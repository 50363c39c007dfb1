"""Several GPUs and processes (counterpart of ``deepgrp_tpu/parallel``):
devices and the process group (:mod:`mesh`), the sharded predictor
(:mod:`predict`) and the data-parallel training step (:mod:`train`).

The JAX package shards over a 1-D device mesh inside one program; here
the sharded predictor drives one chunk loop a shard, each on its device
(several shards may share one), and data-parallel training runs one
process a GPU over ``torch.distributed``, averaging the gradients with
one ``all_reduce`` a step.
"""
