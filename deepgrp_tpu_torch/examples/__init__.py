"""Runnable workflows of the port (counterparts of the JAX package's
``examples/*.py``): ``train_and_evaluate``, ``hpo_sweep`` and
``multihost_sim``.  Each runs with ``python -m
deepgrp_tpu_torch.examples.<name>`` or as a script path; importing one
runs nothing.  See ``README.md`` beside them."""
