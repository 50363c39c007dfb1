"""One process that starts the ranks of a data-parallel run itself.

The JAX package trains data-parallel over every device of one process's
mesh (``deepgrp_tpu/parallel/mesh.py:make_mesh``, ``train --mesh auto``).
The PyTorch idiom is one process a GPU, so here the process that the user
started spawns one rank a device of its mesh (:func:`launch_local`), the
ranks join one process group over a ``file://`` rendezvous in a temporary
directory, each runs the same function, and rank 0's return value comes
back to the caller.  ``torchrun`` and the CLI's launch flags start the
same ranks from outside; a process inside a started group never launches.

The launch never degrades: when a rank raises or dies, the others are
ended and the caller gets an error that names the rank and carries its
traceback; nothing carries on with fewer ranks or in one process.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessContext, ProcessException

from deepgrp_tpu_torch.parallel.mesh import (Device, initialize_distributed,
                                             local_devices)

_LOG = logging.getLogger(__name__)


def launch_backend(devices: Sequence[torch.device]) -> Optional[str]:
    """The backend of a launch over ``devices``: ``None`` (the default,
    ``"cpu:gloo,cuda:nccl"``) for distinct GPUs, ``"gloo"`` when a GPU
    repeats (NCCL refuses two ranks on one device, so that run stays
    eager) or a device is the CPU."""
    if (all(device.type == "cuda" for device in devices)
            and len(set(devices)) == len(devices)):
        return None
    return "gloo"


def _rank_main(rank: int, fn: Callable[..., Any],
               devices: List[torch.device], args: tuple, threads: int,
               init_file: str, results: Any) -> None:
    """One launched rank: its environment, device and host threads, the
    group, ``fn``; rank 0 puts its pickled result on ``results``.  The
    group is destroyed after a success only: after a failure a peer may be
    gone, and the process's exit closes its connections."""
    device = devices[rank]
    local_rank = (device.index or 0) if device.type == "cuda" else rank
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(len(devices)),
                      LOCAL_RANK=str(local_rank))
    torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(f"file://{init_file}", len(devices), rank,
                           launch_backend(devices))
    result = fn(rank, *args)
    if rank == 0:
        # Plain pickle copies the tensors' bytes: this process may exit
        # before the caller reads them, so no shared-memory handle.
        results.put(pickle.dumps(result))
    dist.destroy_process_group()


def _failures(context: ProcessContext,
              first: ProcessException) -> List[str]:
    """Each rank that failed on its own, the first seen first: its
    traceback, its exit code, or the signal that ended it.  A rank the
    launcher ended is not listed; one whose error file is empty or cut off
    (it was ended while it wrote) is listed as ended.  Call it after every
    rank has been ended and joined."""
    order = [first.error_index] + [rank for rank in
                                   range(len(context.processes))
                                   if rank != first.error_index]
    lines = []
    for rank in order:
        process = context.processes[rank]
        error_file = context.error_files[rank]
        if os.path.exists(error_file):
            try:
                with open(error_file, "rb") as fh:
                    trace = pickle.load(fh)
            except (EOFError, pickle.UnpicklingError):
                trace = None
            os.unlink(error_file)
            lines.append(f"rank {rank} raised:\n{trace}" if trace is not None
                         else f"rank {rank} was ended while it wrote its "
                         "error")
        elif process.exitcode and process.exitcode > 0:
            lines.append(f"rank {rank} exited with code {process.exitcode}")
        elif rank == first.error_index:
            lines.append(f"rank {rank} was ended by signal "
                         f"{getattr(first, 'signal_name', None)}")
    return lines


def _end_ranks(context: ProcessContext) -> None:
    """Kill every rank that is still alive and join them all."""
    for process in context.processes:
        if process.is_alive():
            process.kill()
        process.join()


def launch_local(fn: Callable[..., Any], devices: Sequence[Device],
                 args: tuple = ()) -> Any:
    """Run ``fn(rank, *args)`` in one new process a device of ``devices``
    and return rank 0's result.

    Rank ``r`` runs on ``devices[r]`` (a device may repeat) with
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (the index of its GPU, so
    that :func:`~deepgrp_tpu_torch.parallel.mesh.rank_device` finds it;
    its rank on the CPU) in its environment, inside the default process
    group, which it joins through a ``file://`` store in a temporary
    directory and leaves after ``fn`` returns; the backend is
    :func:`launch_backend`'s choice.  The ranks are spawned, never forked,
    and this process creates no CUDA context for them: ``fn``, ``args``
    and the result must pickle (CPU tensors in ``args`` travel through
    shared memory).  Every rank inherits this process's environment
    (``OMP_NUM_THREADS`` among it) and runs with its torch thread count.

    Raises ``RuntimeError`` inside a started process group (a rank never
    launches again) and, when a rank raises or dies, after ending the
    others: the error names each rank that failed and carries its
    traceback.
    """
    # Inside a group that is up, or that a launcher (torchrun, this
    # function) named in the environment, the ranks are up already.
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        raise RuntimeError("launch_local inside a started process group: "
                           "the ranks are up already")
    devices = local_devices(devices)
    world = len(devices)
    _LOG.info("launching %d ranks on %s (backend %s)", world,
              [str(device) for device in devices],
              launch_backend(devices) or "cpu:gloo,cuda:nccl")
    results = mp.get_context("spawn").SimpleQueue()
    with tempfile.TemporaryDirectory(prefix="deepgrp-launch-") as tmp:
        context = mp.start_processes(
            _rank_main, args=(fn, devices, tuple(args),
                              torch.get_num_threads(),
                              os.path.join(tmp, "rdzv"), results),
            nprocs=world, join=False, start_method="spawn")
        payload, failure = None, None
        try:
            # Read rank 0's result as it comes (a large one fills the
            # pipe, and rank 0 waits for the read before it exits).
            while not context.join(timeout=0.1):
                if payload is None and not results.empty():
                    payload = results.get()
        except ProcessException as err:
            failure = err
        finally:
            # Every rank is gone before an error file is read: a rank that
            # is still writing its own would be read cut off.
            _end_ranks(context)
        if failure is not None:
            raise RuntimeError(
                f"a launched rank failed ({world} ranks on "
                f"{[str(device) for device in devices]}); the others "
                f"were ended:\n" + "\n".join(_failures(context, failure))
            ) from None
        if payload is None:
            payload = results.get()
    return pickle.loads(payload)
