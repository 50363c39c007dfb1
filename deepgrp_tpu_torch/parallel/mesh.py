"""Devices and the process group.

Counterpart of ``deepgrp_tpu/parallel/mesh.py``.  The JAX package builds a
1-D ``Mesh`` over ``jax.devices()``; here the shards of the sharded
predictor are a plain list of torch devices (:func:`local_devices`), and
the processes of a multi-process run join one ``torch.distributed``
process group (:func:`initialize_distributed`), one process a GPU
(:func:`rank_device`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from deepgrp_tpu_torch.models.model import resolve_device

Device = Union[str, torch.device]


def local_devices(devices: Optional[Sequence[Device]] = None
                  ) -> List[torch.device]:
    """The devices of this process's shards: every visible CUDA device by
    default, else ``devices`` as given.  A device may repeat, so that
    several shards share it (``["cpu"] * 4``, ``["cuda:0"] * 3``).  Raises
    when no GPU is visible and no list is given, or a CUDA device is
    named without one (as :func:`~deepgrp_tpu_torch.models.model.
    resolve_device` does)."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises, naming --device cpu
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("no devices given")
    return [resolve_device(device) for device in devices]


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: Optional[str] = None) -> None:
    """Join the default process group (no-op when it is already up).

    ``backend`` defaults to ``"cpu:gloo,cuda:nccl"`` where CUDA is
    available (NCCL for CUDA tensors, gloo for CPU ones) and ``"gloo"``
    elsewhere.  Pass ``"gloo"`` to run several ranks on one card: NCCL
    refuses two ranks on one device.  Every failure of
    ``init_process_group`` (a bad address, a port in use, a timeout)
    propagates, so a job never carries on as a single process.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def cuda_backend(group: Optional[dist.ProcessGroup] = None) -> str:
    """The backend that runs ``group``'s collectives on CUDA tensors:
    ``"nccl"`` for ``"nccl"`` and the default ``"cpu:gloo,cuda:nccl"``,
    ``"gloo"`` for ``"gloo"`` (the host, for either device), else the
    backend as named (torch's ``"fake"`` testing backend)."""
    backend = str(dist.get_backend(group))
    pairs = dict(item.split(":", 1) for item in backend.split(",")
                 if ":" in item)
    return pairs.get("cuda", backend)


def world_size() -> int:
    """The default group's size, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_first_rank() -> bool:
    """Whether this process writes a run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device() -> torch.device:
    """This rank's GPU: ``cuda:$LOCAL_RANK`` where the launcher
    (``torchrun``) sets it, else ``cuda:{rank % device_count}``."""
    local = os.environ.get("LOCAL_RANK")
    count = torch.cuda.device_count()
    if count == 0:
        resolve_device("cuda")  # raises
    if local is not None:
        return torch.device("cuda", int(local))
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % count)
