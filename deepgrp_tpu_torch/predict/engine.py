"""On-device sliding-window prediction engine.

Counterpart of ``deepgrp_tpu/predict/engine.py`` (``PredictionEngine``:
the scored route, ``predict_scored``, and the merged-probability track,
``predict``).  The compact code sequence goes to the device once; for each
chunk of ``batch_size`` windows the engine

  * gathers the code windows (``unfold`` of the padded sequence, the torch
    form of ``chunk_windows``),
  * runs the model on one of two routes (:func:`resolve_rnn_kernel`): the
    fused route (the fused fwd+revcomp recurrence kernel on the codes, then
    the attention + dense head and softmax), or the scan route (the code
    windows become one-hot rows, pad code 5 an all-zero row, and go through
    ``DeepGRPModel.apply``: one recurrence over the doubled batch),
  * zeroes the windows past the last real one (the final chunk is padded
    to the batch size, so the kernel always sees the same shape),
  * overlap-max merges the chunk (ops/overlap_max.py) and carries the
    ``vecsize - step`` rows that reach into the next chunk as a spill, and
  * scores each position of the finished block: int8 argmax class and
    float32 max probability, kept on the device (``predict`` keeps the
    block's rows instead).

The two score tracks come back to the host once, at the end, in one byte
buffer: 5 B/bp in float32 (``predict``'s rows: 20 B/bp at 5 classes).  The
bfloat16 fast mode (``compute_dtype``) ships the max probability as 2
bytes, so its tracks are 3 B/bp; that rounding is the mode's contract
(``engine.py:197-212``): the probabilities are nominally bfloat16, and
every consumer sees the rounded track.

Window enumeration parity with the reference (``prediction.py:31``): window
starts are ``range(0, L - vecsize, step_size)``; the window starting exactly
at ``L - vecsize`` is excluded, and ``L <= vecsize`` gives zero windows.

Divergence from the reference, kept from the JAX package: every window is
placed at its true offset ``i * step_size`` (the reference misplaces the
final partial batch, ``prediction.py:105``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from deepgrp_tpu_torch.models.model import (PAD_CODE, DeepGRPModel, one_hot,
                                            resolve_rnn_kernel)
from deepgrp_tpu_torch.ops.overlap_max import overlap_max_merge

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def window_starts(seq_len: int, vecsize: int, step_size: int) -> np.ndarray:
    """Reference-parity window start positions (prediction.py:31)."""
    return np.arange(0, max(seq_len - vecsize, 0), step_size, dtype=np.int64)


def mss_score_transform(classes: np.ndarray,
                        maxp: np.ndarray) -> np.ndarray:
    """The reference MSS score transform (prediction.py:51-57), float32.

    ``t = log(p/(1-p))`` with ``p = min(max_prob + 1e-6, 0.99)``;
    background positions score ``-10*t``, repeat positions ``+t``.
    """
    mins = maxp + np.float32(1e-6)
    mins = np.where(mins > 0.99, np.float32(0.99), mins)
    t_scores = np.log(mins / (1 - mins))
    return np.where(classes > 0, t_scores, -10 * t_scores)


class PredictionEngine:
    """Windowed predictor for one model, on the model's device.

    ``compute_dtype`` is float32 (the parity mode) or bfloat16 (the fast
    mode); ``rnn_kernel`` picks the route (:func:`resolve_rnn_kernel`).
    """

    def __init__(self, model: DeepGRPModel, batch_size: int = 256,
                 step_size: int = 50,
                 compute_dtype: torch.dtype = torch.float32,
                 rnn_kernel: str = "auto"):
        self.model = model
        self.step_size = int(step_size)
        if self.step_size <= 0:
            raise ValueError(f"step_size must be positive, got {step_size}")
        # A chunk's spill must fit inside the next chunk's block:
        # batch*step >= vecsize - step, i.e. batch >= K - 1.  Chunks are
        # masked anyway, so raising a degenerate batch size is free.
        k = -(-model.config.vecsize // self.step_size)
        self.batch_size = max(int(batch_size), k)
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.fused = resolve_rnn_kernel(rnn_kernel)

    def _probs(self, chunk: torch.Tensor) -> torch.Tensor:
        """Float32 class probabilities of one chunk of code windows."""
        if self.fused:
            probs = self.model.forward_probs_from_codes(chunk,
                                                        self.compute_dtype)
        else:
            probs = self.model.apply(one_hot(chunk, self.compute_dtype))
        return probs.to(torch.float32)

    def _merged_blocks(self, codes: np.ndarray, n_windows: int,
                       n_chunks: Optional[int] = None
                       ) -> Tuple[int, Iterator[Tuple[int, torch.Tensor]]]:
        """The chunk loop that both tracks share (``scan_chunk_range``,
        ``engine.py:74-197``).

        Returns ``(rows, blocks)``: ``blocks`` yields ``(first row,
        merged float32 rows [n, n_classes])`` on the device, in order of
        rows and each final (the last one is the final chunk's spill),
        covering rows ``0 .. rows - 1``.  A block is a view that the next
        chunk reuses: read it before asking for the next.

        ``n_chunks`` (default: as many as the windows need) runs a fixed
        number of chunks, windows past the ``n_windows``-th masked: a
        shard of the sharded engine runs its whole range, so its final
        spill is the rows past its range.  ``codes`` are then the shard's
        rows, the halo included.
        """
        config = self.model.config
        vecsize, step, batch = config.vecsize, self.step_size, self.batch_size
        k = -(-vecsize // step)
        if n_chunks is None:
            n_chunks = -(-n_windows // batch)
        block_rows = batch * step
        span = (batch - 1) * step + vecsize
        spill_rows = max(span - block_rows, 0)  # == vecsize - step if > 0
        rows = (n_chunks * batch + k) * step
        padded = np.full(rows, PAD_CODE, np.int8)
        padded[:min(codes.shape[0], rows)] = codes[:rows]
        device = self.model.device
        # [n_chunks*batch + ..., vecsize] view: window w starts at w*step.
        windows = torch.from_numpy(padded).to(device).unfold(0, vecsize, step)

        def blocks() -> Iterator[Tuple[int, torch.Tensor]]:
            spill = torch.zeros(spill_rows, config.n_classes, device=device)
            for c in range(n_chunks):
                chunk = windows[c * batch:(c + 1) * batch].contiguous()
                probs = self._probs(chunk)
                n_real = n_windows - c * batch
                if n_real < batch:
                    probs[max(n_real, 0):] = 0.0
                merged = overlap_max_merge(probs, step, max(span, block_rows))
                block = merged[:block_rows]
                if spill_rows:
                    torch.maximum(block[:spill_rows], spill,
                                  out=block[:spill_rows])
                    spill = merged[block_rows:]
                yield c * block_rows, block
            if spill_rows:
                # The final spill's rows: no further chunk reaches them.
                yield n_chunks * block_rows, spill

        return n_chunks * block_rows + spill_rows, blocks()

    def predict(self, codes: np.ndarray,
                out_len: Optional[int] = None) -> np.ndarray:
        """Overlap-max merged class probabilities, ``float32 [out_len,
        n_classes]`` (``PredictionEngine.predict``, ``engine.py:643-679``).

        ``codes`` is the sequence's int8 code track ``[L]``; ``out_len``
        (default ``L``) sizes the output, as ``results_shape`` in the
        reference's ``prediction.py:90``.  Rows no window covers are zeros.
        The merged rows stay on the device and come back in one copy
        (20 B/bp at 5 classes).  In the bfloat16 fast mode the track is
        float32 holding the bfloat16 probabilities, as the JAX engine's
        unscored track is.
        """
        out_len = codes.shape[0] if out_len is None else int(out_len)
        n_classes = self.model.config.n_classes
        n_windows = window_starts(codes.shape[0], self.model.config.vecsize,
                                  self.step_size).size
        out = np.zeros((out_len, n_classes), np.float32)
        if n_windows == 0:
            return out
        rows, blocks = self._merged_blocks(codes, n_windows)
        merged = torch.empty(rows, n_classes, device=self.model.device)
        for lo, block in blocks:
            merged[lo:lo + block.shape[0]] = block
        take = min(out_len, rows)
        out[:take] = merged[:take].cpu().numpy()
        return out

    def predict_scored(self, codes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-position ``(classes int8 [L], max_prob float32 [L])``.

        ``codes`` is the sequence's int8 code track (A=0..T=3, N=4).
        Positions no window covers come back as class 0 with probability 0
        (the reference merges into a zero buffer).
        """
        out_len = int(codes.shape[0])
        n_windows = window_starts(out_len, self.model.config.vecsize,
                                  self.step_size).size
        out_classes = np.zeros(out_len, np.int8)
        out_maxp = np.zeros(out_len, np.float32)
        if n_windows == 0:
            return out_classes, out_maxp

        total, blocks = self._merged_blocks(codes, n_windows)
        track = ScoredRows(total, self.compute_dtype, self.model.device)
        for lo, block in blocks:
            track.add(lo, block)
        classes_h, maxp_h = track.host()
        take = min(out_len, total)
        out_classes[:take] = classes_h[:take]
        out_maxp[:take] = maxp_h[:take]
        return out_classes, out_maxp


class ScoredRows:
    """Per-position scores of merged rows, kept where the rows are.

    Both score tracks of ``rows`` positions live in one byte buffer,
    ``buf`` (maxp in ``dtype``, then the int8 classes), so they come back
    to the host (or go over a collective) as one tensor.  Storing maxp in
    a bfloat16 track rounds it to nearest even, on the card and on the
    CPU alike: that rounding is the fast mode's contract.
    """

    def __init__(self, rows: int, dtype: torch.dtype,
                 device: Union[str, torch.device],
                 buf: Optional[torch.Tensor] = None):
        self.rows = rows
        self.maxp_size = torch.finfo(dtype).bits // 8
        self.buf = (torch.empty((self.maxp_size + 1) * rows,
                                dtype=torch.uint8, device=device)
                    if buf is None else buf)
        self._maxp = self.buf[:self.maxp_size * rows].view(dtype)
        self._classes = self.buf[self.maxp_size * rows:].view(torch.int8)

    def add(self, lo: int, block: torch.Tensor) -> None:
        """Score merged float32 rows ``block [n, n_classes]`` as positions
        ``lo .. lo + n - 1``: argmax class and max probability."""
        hi = lo + block.shape[0]
        self._classes[lo:hi] = block.argmax(dim=1)
        self._maxp[lo:hi] = block.amax(dim=1)

    def host(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(classes int8 [rows], max_prob float32 [rows])`` on the host
        (one copy)."""
        buf = self.buf.cpu().numpy()
        split = self.maxp_size * self.rows
        if self.maxp_size == 2:
            # numpy has no bfloat16: widen the 16 bits into the top half of
            # a float32 (exact).
            u16 = buf[:split].view(np.uint16)
            maxp = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            maxp = buf[:split].view(np.float32)
        return buf[split:].view(np.int8), maxp
