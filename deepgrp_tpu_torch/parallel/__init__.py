"""Several GPUs and processes (counterpart of ``deepgrp_tpu/parallel``):
devices and the process group (:mod:`mesh`), the local launcher that
starts one rank a device (:mod:`launch`), the sharded predictor
(:mod:`predict`) and the data-parallel training step and epoch
(:mod:`train`).

The JAX package shards over a 1-D device mesh inside one program; here
the sharded predictor drives one chunk loop a shard, each on its device
(several shards may share one), and data-parallel training runs one
process a GPU over ``torch.distributed``, averaging the gradients with
one ``all_reduce`` a step.  What the JAX package gets from one process's
mesh, one command that trains on every visible GPU, comes from
:func:`launch_local`: the process starts the ranks itself.

The package exports :class:`ShardedPredictionEngine`,
:func:`dp_train_step`, :func:`local_devices`, :func:`make_mesh`,
:func:`launch_local` and :func:`initialize_distributed`, each imported from its module when first
named (``train.training`` imports :mod:`mesh`, and :mod:`train` imports
``train.training``, so an eager import here would be circular).
"""

import importlib

_EXPORTS = {"ShardedPredictionEngine": "predict", "dp_train_step": "train",
            "local_devices": "mesh", "make_mesh": "mesh",
            "launch_local": "launch", "initialize_distributed": "mesh"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
