"""Maximum scoring segment (Ruzzo–Tompa) labelling, host side.

Counterpart of ``find_mss_classes`` and ``find_mss_labels`` in
``deepgrp_tpu/ops/mss.py`` (parity with the reference DeepGRP's
``find_mss_labels``, ``_mss/pymss.pyx:16-80``, over ``mss_find_all``,
``_mss/mss.c:50-101``): the same score constants
(s0 = logit(0.99), min_sc = s0*min_mss_len, xdrop = s0*xdrop_len*10 or
disabled), the same integer truncation of the minimum-score threshold, the
same majority-vote labelling quirks (ties keep the lowest class, in-segment
background positions adopt the majority class, everything else keeps its
raw label).

The C++ library (``native/src``) runs the labelling.  The pure-Python
functions at the end implement the identical algorithm; they are the
readable specification and the tests' oracle, and prediction never calls
them.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import List, Tuple

import numpy as np

from deepgrp_tpu_torch import native

_NEG_INF = -1e30


def mss_thresholds(min_mss_len: int, xdrop_len: int) -> Tuple[float, float]:
    """``(min_score, xdrop)`` of the labelling: ``s0 * min_mss_len`` and
    ``s0 * xdrop_len * 10`` (-1, no X-drop, when ``xdrop_len <= 0``), with
    ``s0 = logit(0.99)`` (``pymss.pyx:16-27``)."""
    s0 = math.log(0.99 / (1.0 - 0.99))
    return s0 * min_mss_len, (s0 * xdrop_len * 10.0 if xdrop_len > 0
                              else -1.0)


def default_threads(n: int) -> int:
    """Worker count for the exact-parallel MSS: 1 below ~1 Mbp, else the
    CPU count (at most 16)."""
    if n < (1 << 20):
        return 1
    return min(os.cpu_count() or 1, 16)


def find_mss_classes(scores: np.ndarray, labels: np.ndarray,
                     nof_labels: int, min_mss_len: int, xdrop_len: int,
                     threads: int = 0) -> np.ndarray:
    """Class id per position after MSS labelling, ``int32 [n]``.

    Args:
        scores: per-position MSS scores, float64 ``[n]``.
        labels: per-position argmax classes, int ``[n]``.
        nof_labels: number of classes (background included).
        min_mss_len: minimal segment length (in units of the s0 score).
        xdrop_len: X-drop length; <= 0 disables the X-drop reset.
        threads: workers for the exact-parallel segment search (0 = auto;
            the output is the same for any value).
    """
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    if scores.shape != labels.shape or scores.ndim != 1:
        raise ValueError("scores and labels must be equal-length 1-D arrays")
    if labels.size and (labels.min() < 0 or labels.max() >= nof_labels):
        raise ValueError(f"labels must lie in [0, {nof_labels})")
    if threads <= 0:
        threads = default_threads(scores.size)
    out = np.empty(scores.size, dtype=np.int32)
    native.load().dg_find_mss_classes_mt(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        scores.size, nof_labels, min_mss_len, xdrop_len, threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def mss_find_all(scores: np.ndarray, min_score: float, xdrop: float,
                 threads: int = 0) -> np.ndarray:
    """All maximal scoring subsequences of ``scores`` (``mss_find_all``,
    ``deepgrp_tpu/ops/mss.py:53``; the reference's ``pymss.pyx``), as a
    structured array of ``start``, ``end`` (exclusive) and ``score``: the
    segments scoring at least ``trunc(min_score)`` (``mss.c:35``), with the
    X-drop reset when ``xdrop > 0``.  ``threads`` workers run the exact
    block-parallel search (0 = auto); the output does not depend on it."""
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    if threads <= 0:
        threads = default_threads(scores.size)
    # Segments are disjoint and separated by a non-positive position.
    out = np.empty(scores.size // 2 + 1, dtype=[
        ("start", np.int64), ("end", np.int64), ("score", np.float64)])
    count = native.load().dg_mss_find_all_mt(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), scores.size,
        float(min_score), float(xdrop), threads,
        out.ctypes.data_as(ctypes.POINTER(native.DgSegment)), out.size)
    return out[:min(count, out.size)].copy()


def find_mss_labels(scores: np.ndarray, labels: np.ndarray,
                    nof_labels: int, min_mss_len: int, xdrop_len: int,
                    threads: int = 0) -> np.ndarray:
    """The MSS labelling as one-hot rows, float64 ``[n, nof_labels]``
    (``find_mss_labels``, ``deepgrp_tpu/ops/mss.py:85``; the reference's
    ``pymss.pyx:16-27``): :func:`find_mss_classes` expanded, since the
    labelling sets exactly one class a position."""
    classes = find_mss_classes(scores, labels, nof_labels, min_mss_len,
                               xdrop_len, threads)
    return np.eye(nof_labels, dtype=np.float64)[classes]


class SplitScanner:
    """Incremental, exact block-split detection for the streaming MSS
    (``SplitScanner``, ``deepgrp_tpu/ops/mss.py:151-268``).

    The end of a maximal non-positive run that starts after position 0 and
    whose cumulative drop exceeds ``xdrop`` is an exact block boundary:
    Ruzzo–Tompa restarted there emits the same segments
    (``native/src/mss_parallel.cc:1-24``).  :meth:`feed` scans the score
    track as it lands, a prefix at a time, carries the open run across
    feeds and returns the split points found so far, so that finished
    blocks can be labelled while later positions are still being
    computed.  A split needs ``drop > xdrop + 1e-6 * max(1, |xdrop|)``:
    another scan sums a run in another order, so a run at the threshold
    is never split.  Splits closer than ``min_gap`` positions to the
    previous one are skipped (a noisy track has thousands of reset points,
    and a block costs a dispatch).

    The JAX package scans with vectorised numpy; here one pass of the
    native library (``dg_split_scan_*``) does it, with the interpreter
    lock released: the streaming route scans beside the chunk loop's
    thread, which must keep the card fed.  The split points are the JAX
    scanner's (the run drops differ only in rounding, far inside the
    margin).
    """

    def __init__(self, xdrop: float, min_gap: int = 1 << 18):
        self.xdrop = float(xdrop)
        self.min_gap = int(min_gap)
        self._pos = 0  # next unscanned position
        # [start of the run open at _pos (-1: none), last split], and the
        # open run's drop so far.
        self._state = np.array([-1, 0], dtype=np.int64)
        self._drop = np.zeros(1, dtype=np.float64)

    def feed(self, scores: np.ndarray, upto: int) -> List[int]:
        """Scan ``scores[pos:upto]`` (later entries may still be unwritten);
        returns the new split points, ascending."""
        lo, hi = self._pos, int(upto)
        self._pos = max(self._pos, hi)
        if hi <= lo or self.xdrop <= 0.0:
            return []
        if scores.dtype == np.float32 and scores.flags.c_contiguous:
            fn, ctype = native.load().dg_split_scan_f32, ctypes.c_float
        else:
            scores = np.ascontiguousarray(scores, dtype=np.float64)
            fn, ctype = native.load().dg_split_scan_f64, ctypes.c_double
        out = np.empty((hi - lo) // max(self.min_gap, 1) + 1, np.int64)
        i64 = ctypes.POINTER(ctypes.c_int64)
        count = fn(scores.ctypes.data_as(ctypes.POINTER(ctype)), lo, hi,
                   self.xdrop, self.min_gap, self._state.ctypes.data_as(i64),
                   self._drop.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   out.ctypes.data_as(i64))
        return out[:count].tolist()


def streaming_mss_block_classes(scores: np.ndarray, labels: np.ndarray,
                                out: np.ndarray, lo: int, hi: int,
                                nof_labels: int, min_mss_len: int,
                                xdrop_len: int) -> None:
    """Label the block ``[lo, hi)`` into ``out`` (int32), single-threaded:
    the streaming route runs blocks in parallel.  ``lo`` and ``hi`` are 0,
    the track's length or :class:`SplitScanner` split points."""
    out[lo:hi] = find_mss_classes(scores[lo:hi], labels[lo:hi], nof_labels,
                                  min_mss_len, xdrop_len, threads=1)


def find_mss_classes_spec(scores: np.ndarray, labels: np.ndarray,
                          nof_labels: int, min_mss_len: int,
                          xdrop_len: int) -> np.ndarray:
    """Pure-Python :func:`find_mss_classes` (specification; tests only)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.int64)
    one_hot = np.zeros((scores.size, nof_labels), dtype=np.float64)
    _find_mss_labels_py(scores, labels, nof_labels, min_mss_len, xdrop_len,
                        one_hot)
    return one_hot.argmax(axis=1).astype(np.int32)


def _mss_find_all_py(scores: np.ndarray, min_score: float,
                     xdrop: float) -> List[Tuple[int, int, float]]:
    """Pure-Python Ruzzo–Tompa with X-drop (specification)."""
    min_sc = float(int(min_score))  # reference truncates to int (mss.c:35)
    out: List[Tuple[int, int, float]] = []
    # Candidate entries: [start, end, lprefix, rprefix, back_pointer]
    cands: List[list] = []

    def flush() -> None:
        for start, end, lpre, rpre, _ in cands:
            if rpre - lpre >= min_sc:
                out.append((start, end, rpre - lpre))
        cands.clear()

    n = scores.size
    prefix = 0.0
    best = _NEG_INF
    i = 0
    while i < n:
        if scores[i] > 0.0:
            end = i
            rpre = prefix
            while end < n and scores[end] > 0.0:
                rpre += scores[end]
                end += 1
            best = max(best, rpre)
            cur = [i, end, prefix, rpre, -1]
            while True:
                j = len(cands) - 1
                while j >= 0:
                    if cands[j][2] < cur[2]:
                        break
                    j = cands[j][4] if cands[j][4] >= 0 else j - 1
                if j >= 0 and cands[j][3] < cur[3]:
                    cur[0], cur[2], cur[4] = cands[j][0], cands[j][2], cands[j][4]
                    del cands[j:]
                    continue
                if j < 0:
                    flush()
                    best = rpre
                cur[4] = j
                cands.append(cur)
                break
            prefix = rpre
            i = end
        else:
            if xdrop > 0.0 and prefix + scores[i] + xdrop < best:
                flush()
                prefix = 0.0
                best = _NEG_INF
            prefix += scores[i]
            i += 1
    flush()
    return out


def _find_mss_labels_py(scores: np.ndarray, labels: np.ndarray,
                        nof_labels: int, min_mss_len: int, xdrop_len: int,
                        out: np.ndarray) -> None:
    min_sc, xdrop = mss_thresholds(min_mss_len, xdrop_len)
    segs = _mss_find_all_py(scores, min_sc, xdrop)
    cursor = 0
    rng = np.arange(scores.size)
    for start, end, _ in segs:
        counts = np.bincount(labels[start:end], minlength=nof_labels)
        major = 1 + int(np.argmax(counts[1:]))  # ties -> lowest class
        seg_labels = labels[start:end]
        out[rng[start:end], np.where(seg_labels == 0, major, seg_labels)] = 1.0
        out[rng[cursor:start], labels[cursor:start]] = 1.0
        cursor = end
    out[rng[cursor:], labels[cursor:]] = 1.0
