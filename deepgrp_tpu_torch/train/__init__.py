"""Training: class-balanced sampler, optimizers, checkpoints and the
training loop (counterpart of ``deepgrp_tpu/train``)."""
