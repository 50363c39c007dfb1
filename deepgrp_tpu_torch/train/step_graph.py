"""One optimization step, captured as a CUDA graph and replayed.

The port's counterpart of the JAX package's one-dispatch training
programs: ``_train_epoch`` (``deepgrp_tpu/train/training.py:151-180``, a
whole epoch as one ``lax.scan``), ``make_dp_train_epoch``
(``deepgrp_tpu/parallel/train.py:119-155``, the data-parallel epoch with
its ``pmean`` inside the scan; here
:func:`deepgrp_tpu_torch.parallel.train.make_dp_train_epoch`, the
gradient ``all_reduce`` inside the graph) and ``_parallel_step``
(``deepgrp_tpu/hpo/vmapped.py:69-113``, one program a fleet step).  An
eager step issues a few hundred small launches from Python (the sampler's
draws, the dropout masks, the recurrence kernels and the head, autograd's
backward, the optimizer's update); a replay of the captured step issues
them with one host call.

:class:`StepGraph` takes a step function of no arguments:

* its first ``WARMUP_STEPS`` calls run the step eagerly on a side
  stream.  They are steps of the run; they build the kernel libraries
  (``_build.load_kernels``), create the optimizer's state, the autograd
  engine's device thread and cuBLAS's workspaces, so that the captured
  step runs no first-use code;
* the next call captures one step into a ``torch.cuda.CUDAGraph`` (capture
  launches nothing) and replays it; every later call replays it;
* the generators the step draws from are registered with the graph, so
  each replay advances their Philox offsets by what the captured draws
  took: the replayed draws are an eager step's, and ``get_state()`` after
  ``n`` steps is the eager run's;
* the launch counters' adds made during the capture are recorded
  (:func:`deepgrp_tpu_torch._build.recording_launches`), not counted, and
  each replay adds them, so the counts after a captured run read what an
  eager run's read;
* the capture runs with ``capture_error_mode="global"``: a call that is
  unsafe during capture, made by any thread (the autograd engine runs the
  backward on its own), raises.  No other thread issues CUDA work during a
  training step (predict's reader threads run only under predict).  Over
  NCCL, ``ProcessGroupNCCL``'s watchdog thread queries the events of
  collectives issued before the capture, which is not an unsafe call, and
  is handed none of the collectives captured (``make_dp_train_epoch``).
  An error raises; nothing falls back to the eager step;
* Python's cyclic garbage collector runs just before the capture and is
  paused during it.  A finished run's graph lives in a reference cycle
  (its ``StepGraph`` holds the step, whose loop holds the ``StepGraph``),
  so only the collector frees it, and torch's graph context no longer
  collects before a capture: a collection that an allocation set off
  inside the capture ran the dead graph's ``cudaGraphExecDestroy``
  there, which invalidated the capture (``CUDAGraph.cpp``: "operation
  not permitted when stream is capturing"; seen on the H100 in a data-
  parallel capture test and in the 7th ``train`` of one process).

What a step may do: device work only, with no read on the host
(``.item()``, ``.cpu()``), no copy of host data to the device and no branch
on a tensor's value.  Tensors it allocates belong to the graph's private
memory pool and are rewritten by every replay, so a step hands its results
over by writing into tensors made before the capture (``copy_``).

A graph belongs to the ``fit`` or fleet call that made it: no cache, so no
process-global state beyond the one-at-a-time launch recording.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Iterator, Optional, Sequence, Union

import torch

from deepgrp_tpu_torch import _build

#: Eager steps before the capture: one builds everything the step uses.
WARMUP_STEPS = 1


class StepGraph:
    """A step function, run eagerly ``WARMUP_STEPS`` times, then captured
    once and replayed (module docstring).  ``device`` must be a CUDA
    device; ``generators`` are the ``torch.Generator``s the step draws
    from."""

    def __init__(self, step: Callable[[], None],
                 device: Union[str, torch.device],
                 generators: Sequence[torch.Generator] = ()):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures work on a CUDA device, "
                             f"not {device}; run the step eagerly there")
        for gen in generators:
            if gen.device.type != "cuda":
                raise ValueError(f"generator on {gen.device}: the graph "
                                 "replays draws of CUDA generators only")
        self.step = step
        self.device = device
        self.generators = list(generators)
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Optional[_build.LaunchRecord] = None
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream()

    def __call__(self) -> None:
        """Take one step: eager during the warm-up, else a replay (the
        first after the capture)."""
        current = torch.cuda.current_stream(self.device)
        if self.calls < WARMUP_STEPS:
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self.step()
            current.wait_stream(self.stream)
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.launches.replay()
        self.calls += 1

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with _build.recording_launches() as launches, collector_paused():
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="global"):
                self.step()
        self.graph, self.launches = graph, launches


@contextlib.contextmanager
def collector_paused() -> Iterator[None]:
    """Runs Python's cyclic garbage collector, then pauses it for the
    block (module docstring); it runs again after, if it ran before."""
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
