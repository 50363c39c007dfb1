"""Segment iteration over per-position class arrays, and the evaluation's
short-segment filter.

Counterpart of ``get_segments``, ``yield_segments`` and ``filter_segments``
in ``deepgrp_tpu/ops/segments.py``
(parity with the reference DeepGRP's ``sequence.pyx:40-53,79-85``),
including the reference's boundary quirk: the scan never extends a segment
past index ``size - 2``, so the final element of a trailing run is emitted
as its own one-element segment.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

Segment = Tuple[int, int, int]


def get_segments(classes: np.ndarray, startpos: int) -> Segment:
    """The next non-background constant-label run from ``startpos``: the
    reference's scan (``sequence.pyx:40-53``), which never extends a run
    past index ``size - 2``."""
    length = classes.size - 1
    currentlabel = int(classes[startpos])
    while startpos < length and currentlabel == 0:
        startpos += 1
        currentlabel = int(classes[startpos])
    end = startpos + 1
    while end < length and classes[end] == currentlabel:
        end += 1
    return startpos, end, currentlabel


def yield_segments(classes: np.ndarray,
                   start_offset: int) -> Iterator[Segment]:
    """Iterate ``(start+offset, end+offset, label)`` segments.

    Matches sequence.pyx:79-85 exactly, including the final-element quirk.
    Implemented via a single RLE pass instead of the reference's per-position
    python loop.
    """
    for start, end, label in segments_from_classes(classes):
        yield start + start_offset, end + start_offset, label


def segments_from_classes(classes: np.ndarray) -> List[Segment]:
    """Vectorized equivalent of iterating ``get_segments`` from 0.

    Semantics (derived from sequence.pyx:40-53):
      * zero-label runs are skipped (not emitted), except that the very last
        element always terminates the scan and is emitted as its own
        segment, whatever its label;
      * a non-zero run containing the final element is emitted as
        ``[start, size-1)`` plus ``[size-1, size)``.
    """
    classes = np.asarray(classes)
    n = classes.size
    if n == 0:
        return []
    if n == 1:
        return [(0, 1, int(classes[0]))]
    body = classes[:n - 1]
    # RLE over the first n-1 elements.
    boundaries = np.flatnonzero(body[1:] != body[:-1]) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [n - 1]))
    labels = body[starts]
    out: List[Segment] = [
        (int(s), int(e), int(l))
        for s, e, l in zip(starts, ends, labels) if l != 0
    ]
    out.append((n - 1, n, int(classes[n - 1])))
    return out


def filter_segments(array: np.ndarray, min_len: int = 50) -> None:
    """Clear non-background runs shorter than ``min_len``, in place
    (``filter_segments``, ``deepgrp_tpu/ops/segments.py:80-95``; the
    reference's ``prediction.py:242-260``, vectorised: runs by RLE, each
    short non-zero run set to 0)."""
    n = array.size
    if n == 0:
        return
    boundaries = np.flatnonzero(array[1:] != array[:-1]) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [n]))
    labels = array[starts]
    short = (labels > 0) & ((ends - starts) < min_len)
    for s, e in zip(starts[short], ends[short]):
        array[s:e] = 0
