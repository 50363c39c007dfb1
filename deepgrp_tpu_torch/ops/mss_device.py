"""Maximum scoring segment labelling on the track's device.

Counterpart of ``deepgrp_tpu/ops/mss_device.py`` (the all-on-device
formulation of the reference's Ruzzo–Tompa post-processing,
``_mss/mss.c:50-101`` and ``_mss/pymss.pyx:16-80``), in torch.  It gives
the labels of :func:`deepgrp_tpu_torch.ops.mss.find_mss_classes` without
copying the score track to the host:

1. **Run collapse**, dense tensor work.  Ruzzo–Tompa consumes each maximal
   positive run whole (``mss.c:62-70``), so a run is one candidate: run
   ids by a ``cumsum`` over run-start marks, each run's first and last
   position by ``scatter_reduce`` (``amin``/``amax``), and its left and
   right prefix ``(L, R)`` from one global ``cumsum``.
2. **X-drop resets at run starts.**  A reset can only fire in a
   non-positive gap; it fires in a gap iff it fires at the gap's end (the
   prefix only falls inside a gap), and where in the gap it fires only
   shifts the prefix frame, which changes no emitted segment
   (``native/src/mss_parallel.cc:1-24``).  So each reset is placed at the
   next run's start, where the new frame's origin is that run's ``L``.
3. **The candidate-stack scan** over the runs, sequential: the reference's
   stack with its back-pointer search, merges, flush on a new minimum and
   the integer-truncated ``min_score`` (``mss.c:35``).  On a CUDA tensor it
   is the kernel ``dg_mss_stack`` (``csrc/mss_stack.cu``: one thread, the
   counterpart of the JAX module's ``lax.while_loop``, which PyTorch has no
   device form of); on a CPU tensor it is :func:`mss_stack_from_candidates`,
   the plain version.
4. **Majority-vote labelling**, dense: each position's segment by
   ``searchsorted``, per-class counts by ``scatter_add``, ties to the
   lowest class, background positions inside a segment adopt its class.

Numerics: the scores are the reference's float32 transform; the prefix sums
and the stack scan run in float64, as the host library accumulates (in
order, in double).  A parallel ``cumsum`` sums in another order, so a
prefix may differ from the host's in its last bits, which can only matter
at an exact tie; on integer-valued or dyadic scores every order is exact
and the segments equal the host library's.  The JAX module keeps float32
prefix sums; its collapsed ``L``/``R`` are float32 where these are float64.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepgrp_tpu_torch import _build
from deepgrp_tpu_torch.ops.mss import mss_thresholds

#: Launches of ``dg_mss_stack`` (name ``mss_stack``) and calls of its plain
#: version on a CPU tensor (name ``mss_stack_plain``).
LAUNCHES = _build.LaunchCounter()

_NEG_INF = -1e30
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


class DeviceSegments(NamedTuple):
    """A padded segment set: the first ``count`` rows are valid."""

    starts: torch.Tensor  # int32 [capacity]
    ends: torch.Tensor  # int32 [capacity], exclusive
    scores: torch.Tensor  # float64 [capacity]
    count: torch.Tensor  # int32 scalar
    overflow: torch.Tensor  # bool scalar: more runs than the capacity


class Candidates(NamedTuple):
    """The collapsed positive runs; the first ``min(n_runs, capacity)``
    rows are valid (the others hold the JAX module's empty-segment
    values)."""

    n_runs: torch.Tensor  # int32 scalar
    overflow: torch.Tensor  # bool scalar: n_runs > capacity
    starts: torch.Tensor  # int32 [capacity]
    ends: torch.Tensor  # int32 [capacity], exclusive
    l_glob: torch.Tensor  # float64 [capacity]: prefix before the run
    r_glob: torch.Tensor  # float64 [capacity]: prefix through the run


def scored_to_scores(classes: torch.Tensor, maxp: torch.Tensor,
                     out_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference score transform on the device (``prediction.py:51-57``,
    ``_scored_to_scores`` of the JAX module): ``(scores float32, labels
    int64)``.  ``t = log(p / (1 - p))``, ``p = min(maxp + 1e-6, 0.99)``
    in float32; ``+t`` on repeat classes, ``-10 t`` on background.  Rows at
    or past ``out_len`` score 0 with label 0, so they join nothing.
    ``maxp`` may be bfloat16 (widened exactly)."""
    in_len = torch.arange(classes.shape[0], device=classes.device) < out_len
    labels = torch.where(in_len, classes.to(torch.int64), 0)
    mins = torch.clamp_max(maxp.to(torch.float32) + 1e-6, 0.99)
    t_scores = torch.log(mins / (1 - mins))
    scores = torch.where(labels > 0, t_scores, -10 * t_scores)
    return torch.where(in_len, scores, 0.0), labels


def collapse_runs(scores: torch.Tensor, capacity: int) -> Candidates:
    """Collapse the positive runs of ``scores [n]`` (step 1): run ``k``
    (``k < capacity``) spans ``[starts[k], ends[k])`` with global prefixes
    ``l_glob[k]`` (before it) and ``r_glob[k]`` (through it), in float64."""
    device = scores.device
    scores = scores.to(torch.float64)
    n = scores.shape[0]
    starts = torch.full((capacity + 2,), _I32_MAX, dtype=torch.int64,
                        device=device)
    ends = torch.full((capacity + 2,), _I32_MIN, dtype=torch.int64,
                      device=device)
    if n == 0:
        zero = torch.zeros((), dtype=torch.int32, device=device)
        empty = torch.zeros(capacity, dtype=torch.float64, device=device)
        return Candidates(zero, zero > 0, starts[1:-1].to(torch.int32),
                          (ends[1:-1] + 1).to(torch.int32), empty, empty)
    idx = torch.arange(n, device=device)
    pos = scores > 0
    run_mark = pos.clone()
    run_mark[1:] &= ~pos[:-1]
    rid = torch.cumsum(run_mark, 0)
    n_runs = rid[-1].to(torch.int32)
    # Bucket 0 takes the non-positive positions, capacity + 1 the runs past
    # the capacity.
    seg_id = torch.where(pos, rid.clamp_max(capacity + 1), 0)
    starts.scatter_reduce_(0, seg_id, torch.where(pos, idx, n), "amin",
                           include_self=False)
    ends.scatter_reduce_(0, seg_id, torch.where(pos, idx, -1), "amax",
                         include_self=False)
    starts, ends = starts[1:-1], ends[1:-1] + 1
    prefix = torch.cumsum(scores, 0)
    prefix_excl = prefix - scores
    l_glob = prefix_excl[starts.clamp(0, n - 1)]
    r_glob = prefix[(ends - 1).clamp(0, n - 1)]
    return Candidates(n_runs, n_runs > capacity, starts.to(torch.int32),
                      ends.to(torch.int32), l_glob, r_glob)


def mss_stack_from_candidates(starts, ends, l_glob, r_glob, n_runs: int,
                              min_score: float,
                              xdrop: float) -> Tuple[List[int], List[int]]:
    """The candidate-stack scan over collapsed runs (step 3), in Python
    floats (float64): the plain version of ``dg_mss_stack``
    (``mss_stack_from_candidates`` and ``run_body``,
    ``mss_device.py:160-226,410-481`` of the JAX package).

    Returns ``(seg_starts, seg_ends)`` in emission order (ascending).
    """
    min_sc = float(math.trunc(min_score))  # mss.c:35
    out_s: List[int] = []
    out_e: List[int] = []
    # The stack: left and right prefix, start, end, back-pointer.
    st_l: List[float] = []
    st_r: List[float] = []
    st_s: List[int] = []
    st_e: List[int] = []
    st_b: List[int] = []

    def flush() -> None:
        for k, (left, right) in enumerate(zip(st_l, st_r)):
            if right - left >= min_sc:
                out_s.append(st_s[k])
                out_e.append(st_e[k])
        for stack in (st_l, st_r, st_s, st_e, st_b):
            stack.clear()

    shift, best = 0.0, _NEG_INF
    for run in range(n_runs):
        l_run, r_run = float(l_glob[run]), float(r_glob[run])
        if xdrop > 0 and l_run - shift + xdrop < best:
            flush()
            shift, best = l_run, _NEG_INF
        cur_l, cur_r = l_run - shift, r_run - shift
        best = max(best, cur_r)
        start, end = int(starts[run]), int(ends[run])
        while True:
            j = len(st_l) - 1
            while j >= 0 and not st_l[j] < cur_l:
                j = st_b[j] if st_b[j] >= 0 else j - 1
            if j >= 0 and st_r[j] < cur_r:  # merge with candidate j
                start, cur_l = st_s[j], st_l[j]
                for stack in (st_l, st_r, st_s, st_e, st_b):
                    del stack[j:]
                continue
            if j < 0:  # a new minimum: everything pending is final
                flush()
                best = cur_r
            st_l.append(cur_l)
            st_r.append(cur_r)
            st_s.append(start)
            st_e.append(end)
            st_b.append(j)
            break
    flush()
    return out_s, out_e


def mss_stack(cand: Candidates, min_score: float, xdrop: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The candidate-stack scan (step 3) where the candidates lie:
    ``(seg_starts int32 [capacity], seg_ends int32 [capacity], count int32
    scalar)``, segments in ascending order.  A CUDA tensor launches
    ``dg_mss_stack`` (no copy to the host) or raises; a CPU tensor runs
    :func:`mss_stack_from_candidates`.  Only the first ``min(n_runs,
    capacity)`` runs are scanned (the caller checks ``overflow``)."""
    capacity = cand.starts.shape[0]
    device = cand.starts.device
    if device.type == "cpu":
        LAUNCHES.add("mss_stack_plain")
        runs = min(int(cand.n_runs), capacity)
        seg_s, seg_e = mss_stack_from_candidates(
            cand.starts.numpy(), cand.ends.numpy(), cand.l_glob.numpy(),
            cand.r_glob.numpy(), runs, min_score, xdrop)
        out = torch.zeros(2, capacity, dtype=torch.int32)
        out[0, :len(seg_s)] = torch.tensor(seg_s, dtype=torch.int32)
        out[1, :len(seg_e)] = torch.tensor(seg_e, dtype=torch.int32)
        return out[0], out[1], torch.tensor(len(seg_s), dtype=torch.int32)
    return _launch_stack(cand, min_score, xdrop)


def _launch_stack(cand: Candidates, min_score: float, xdrop: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    device = cand.starts.device
    if device.type != "cuda":
        raise ValueError(f"mss_stack: candidates on {device}; the kernel "
                         "takes CUDA tensors")
    capacity = cand.starts.shape[0]
    expect = ((cand.starts, torch.int32), (cand.ends, torch.int32),
              (cand.l_glob, torch.float64), (cand.r_glob, torch.float64))
    for tensor, dtype in expect:
        if (tensor.dtype != dtype or tuple(tensor.shape) != (capacity,)
                or tensor.device != device or not tensor.is_contiguous()):
            raise ValueError(f"mss_stack: candidates must be contiguous "
                             f"[{capacity}] int32/float64 on {device}")
    n_runs = cand.n_runs.to(device=device, dtype=torch.int32).reshape(1)
    # The stack (L, R in float64; start, end, back-pointer in int32) and
    # the segments, count last.
    st_f = torch.empty(2, capacity, dtype=torch.float64, device=device)
    st_i = torch.empty(3, capacity, dtype=torch.int32, device=device)
    # Zeros past the count, as the plain version leaves them.
    out = torch.zeros(2 * capacity + 1, dtype=torch.int32, device=device)
    if capacity:
        lib = _build.load_kernels("mss_stack")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.dg_mss_stack(
                cand.starts.data_ptr(), cand.ends.data_ptr(),
                cand.l_glob.data_ptr(), cand.r_glob.data_ptr(),
                n_runs.data_ptr(), capacity, ctypes.c_double(min_score),
                ctypes.c_double(xdrop), st_f.data_ptr(), st_i.data_ptr(),
                out.data_ptr(), ctypes.c_void_p(stream))
        if err != 0:
            msg = lib.dg_error_string(err).decode()
            raise RuntimeError(f"mss_stack kernel launch failed: CUDA error "
                               f"{err} ({msg}) at capacity {capacity}")
        LAUNCHES.add("mss_stack")
    return out[:capacity], out[capacity:2 * capacity], out[2 * capacity]


def _segments(scores: torch.Tensor, min_score: float, xdrop: float,
              max_runs: int) -> Tuple[Candidates, torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Steps 1-3: the collapsed runs and ``(seg_starts, seg_ends,
    count)``."""
    cand = collapse_runs(scores, max_runs)
    return (cand, *mss_stack(cand, min_score, xdrop))


def mss_find_all_device(scores: torch.Tensor, min_score: float,
                        xdrop: float, *, max_runs: int) -> DeviceSegments:
    """Every maximal scoring segment of ``scores [n]`` where they lie
    (``mss_find_all_device``, ``mss_device.py:84-227`` of the JAX package;
    ``mss.c:50-101``).  ``max_runs`` bounds the positive runs; with more,
    ``overflow`` is set and the result must not be used.  A segment's
    score is its sum from the float64 prefix."""
    cand, seg_s, seg_e, count = _segments(scores, min_score, xdrop, max_runs)
    n = scores.shape[0]
    if n:
        prefix = torch.cumsum(scores.to(torch.float64), 0)
        prefix_excl = prefix - scores.to(torch.float64)
        seg_scores = (prefix[(seg_e.long() - 1).clamp(0, n - 1)]
                      - prefix_excl[seg_s.long().clamp(0, n - 1)])
    else:
        seg_scores = torch.zeros(max_runs, dtype=torch.float64,
                                 device=scores.device)
    return DeviceSegments(seg_s, seg_e, seg_scores, count, cand.overflow)


def assign_segment_classes(labels: torch.Tensor, seg_starts: torch.Tensor,
                           seg_ends: torch.Tensor, count: torch.Tensor,
                           nof_labels: int) -> torch.Tensor:
    """Majority-vote labelling (step 4; ``assign_segment_classes``,
    ``mss_device.py:483-518`` of the JAX package; ``pymss.pyx:46-67``):
    ``int64 [n]``.  Inside a segment a background position takes the
    segment's most frequent repeat class (ties to the lowest); everything
    else keeps its label.  The first ``count`` segments are valid."""
    device = labels.device
    n = labels.shape[0]
    capacity = seg_starts.shape[0]
    if capacity == 0 or n == 0:
        return labels.clone()
    valid = torch.arange(capacity, device=device) < count
    sort_starts = torch.where(valid, seg_starts.long(), n)
    sort_starts, order = torch.sort(sort_starts)
    sort_ends = torch.where(valid, seg_ends.long(), n)[order]
    idx = torch.arange(n, device=device)
    sid = torch.searchsorted(sort_starts, idx, right=True) - 1
    sid_c = sid.clamp(0, capacity - 1)
    in_seg = (sid >= 0) & (idx < sort_ends[sid_c])
    key = torch.where(in_seg, sid_c, capacity) * nof_labels + labels
    counts = torch.zeros((capacity + 1) * nof_labels, dtype=torch.int64,
                         device=device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    counts = counts.view(capacity + 1, nof_labels)[:capacity, 1:]
    major = 1 + torch.argmax(counts, dim=1)  # first maximum: lowest class
    return torch.where(in_seg & (labels == 0), major[sid_c], labels)


def mss_classes_device(scores: torch.Tensor, labels: torch.Tensor,
                       nof_labels: int, min_mss_len: int, xdrop_len: int, *,
                       max_runs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position class after the MSS labelling, where the scores lie
    (``mss_classes_device``, ``mss_device.py:230-281`` of the JAX package):
    ``(classes int64 [n], overflow)``; on overflow run again with a larger
    ``max_runs``.  Equals :func:`~deepgrp_tpu_torch.ops.mss.
    find_mss_classes` (up to prefix-sum ties, see the module's note)."""
    min_score, xdrop = mss_thresholds(min_mss_len, xdrop_len)
    cand, seg_s, seg_e, count = _segments(scores, min_score, xdrop, max_runs)
    assigned = assign_segment_classes(labels.to(torch.int64), seg_s, seg_e,
                                      count, nof_labels)
    return assigned, cand.overflow


def find_mss_labels_device(scores: torch.Tensor, labels: torch.Tensor,
                           nof_labels: int, min_mss_len: int, xdrop_len: int,
                           *, max_runs: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mss_classes_device` as one-hot rows ``[n, nof_labels]`` in
    the scores' dtype, and the overflow flag."""
    assigned, overflow = mss_classes_device(scores, labels, nof_labels,
                                            min_mss_len, xdrop_len,
                                            max_runs=max_runs)
    one_hot = torch.nn.functional.one_hot(assigned, nof_labels)
    return one_hot.to(scores.dtype), overflow


def mss_classes_from_scored(classes: torch.Tensor, maxp: torch.Tensor,
                            out_len: int, nof_labels: int, min_mss_len: int,
                            xdrop_len: int, *, max_runs: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole MSS from the engine's scored track, where it lies: the
    score transform (:func:`scored_to_scores`), then
    :func:`mss_classes_device` (``mss_device.py:284-355`` of the JAX
    package)."""
    scores, labels = scored_to_scores(classes, maxp, out_len)
    return mss_classes_device(scores, labels, nof_labels, min_mss_len,
                              xdrop_len, max_runs=max_runs)


def count_positive_runs(scores: torch.Tensor) -> int:
    """Number of maximal positive runs of ``scores`` (one scalar read)."""
    if scores.shape[0] == 0:
        return 0
    pos = scores > 0
    return int(pos[0]) + int((pos[1:] & ~pos[:-1]).sum())


def scored_run_count(classes: torch.Tensor, maxp: torch.Tensor,
                     out_len: int) -> int:
    """Positive runs of a scored track's MSS scores within ``out_len``
    (``_scored_run_count``, ``postprocess.py:240`` of the JAX package): the
    sparsity routing's signal, and the size of the run capacity."""
    scores, _ = scored_to_scores(classes, maxp, out_len)
    return count_positive_runs(scores[:out_len])


def run_capacity(runs: int) -> int:
    """The run capacity for ``runs`` runs: a power of two, at least 64
    (``apply_mss_on_device``, ``postprocess.py:86`` of the JAX package)."""
    return max(64, 1 << int(max(runs, 1)).bit_length())


def find_mss_labels_auto(scores, labels, nof_labels: int, min_mss_len: int,
                         xdrop_len: int,
                         max_runs: Optional[int] = None) -> np.ndarray:
    """One-hot MSS labels of host or device inputs, as numpy; the capacity
    sized from the data unless given, raising ``ValueError`` if it is too
    small (``find_mss_labels_auto``, ``mss_device.py:530-544`` of the JAX
    package)."""
    scores = torch.as_tensor(scores)
    labels = torch.as_tensor(labels, device=scores.device)
    if max_runs is None:
        max_runs = run_capacity(count_positive_runs(scores))
    out, overflow = find_mss_labels_device(scores, labels, nof_labels,
                                           min_mss_len, xdrop_len,
                                           max_runs=max_runs)
    if bool(overflow):
        raise ValueError(f"max_runs={max_runs} insufficient; increase "
                         "capacity")
    return out.cpu().numpy()
