"""Overlap-max merging of sliding-window predictions, on the device.

Counterpart of ``overlap_max_merge`` and ``get_max`` in
``deepgrp_tpu/ops/overlap_max.py``.  The reference merges overlapping window
outputs into a genome-length array by a strided elementwise max on the host
(``maxcalc.c:10-24``); here the merge is a max over K = ceil(V/step) shifted
chunk layers, in torch ops.  ``get_max`` keeps the reference's host API.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def get_max(output: np.ndarray, inputs: np.ndarray,
            stride: int) -> np.ndarray:
    """In-place strided overlap max on the host (``get_max``,
    ``deepgrp_tpu/ops/overlap_max.py:26-40``; the reference's
    ``sequence.pyx:67-76``): ``output[b*stride + i, j] = max(output[b*stride
    + i, j], inputs[b, i, j])`` for every window ``b``.  ``output`` needs at
    least ``(batch-1)*stride + dim0`` rows; returns it."""
    if inputs.ndim != 3 or output.ndim != 2:
        raise ValueError("inputs must be [batch, dim0, dim1], output 2-D")
    batch, dim0, dim1 = inputs.shape
    if output.shape[1] != dim1:
        raise ValueError("output and inputs disagree on dim1")
    if batch and output.shape[0] < (batch - 1) * stride + dim0:
        raise ValueError("output too small for the window span")
    for b in range(batch):
        lo = b * stride
        np.maximum(output[lo:lo + dim0], inputs[b], out=output[lo:lo + dim0])
    return output


def overlap_max_merge(windows: torch.Tensor, step: int,
                      out_len: int) -> torch.Tensor:
    """Merge window predictions ``[N, V, C]`` into ``[out_len, C]``.

    Window ``b`` covers output rows ``[b*step, b*step + V)``; each output
    row is the max over all covering windows and an implicit zero (the
    reference merges into a zero-filled buffer), so uncovered rows are 0.

    Each window splits into K chunks of ``step`` rows (the last one padded
    with -inf); chunk j of window b lands at output block b + j, so layer j
    is the chunk-j sequence shifted by j blocks, and the merge is a max over
    the K layers.  Max is exact, so the order of the layers does not matter.
    """
    n_windows, vecsize, n_classes = windows.shape
    if n_windows == 0:
        return windows.new_zeros(out_len, n_classes)
    k = -(-vecsize // step)
    chunks = F.pad(windows, (0, 0, 0, k * step - vecsize),
                   value=float("-inf")).reshape(n_windows, k, step, n_classes)
    merged = windows.new_full((n_windows + k - 1, step, n_classes),
                              float("-inf"))
    for j in range(k):
        layer = merged[j:j + n_windows]
        torch.maximum(layer, chunks[:, j], out=layer)
    merged = merged.reshape(-1, n_classes).clamp_min_(0.0)
    if out_len <= merged.shape[0]:
        return merged[:out_len]
    return F.pad(merged, (0, 0, 0, out_len - merged.shape[0]))
