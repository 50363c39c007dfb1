"""On-device sliding-window prediction engine.

Counterpart of ``deepgrp_tpu/predict/engine.py`` (``PredictionEngine``,
scored route).  The compact code sequence goes to the device once; for each
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
    float32 max probability, kept on the device.

The two score tracks come back to the host once, at the end, in one byte
buffer: 5 B/bp in float32.  The bfloat16 fast mode (``compute_dtype``)
ships the max probability as 2 bytes, so its tracks are 3 B/bp; that
rounding is the mode's contract (``engine.py:197-212``): the probabilities
are nominally bfloat16, and every consumer sees the rounded track.

Window enumeration parity with the reference (``prediction.py:31``): window
starts are ``range(0, L - vecsize, step_size)``; the window starting exactly
at ``L - vecsize`` is excluded, and ``L <= vecsize`` gives zero windows.

Divergence from the reference, kept from the JAX package: every window is
placed at its true offset ``i * step_size`` (the reference misplaces the
final partial batch, ``prediction.py:105``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deepgrp_tpu_torch.models.model import DeepGRPModel
from deepgrp_tpu_torch.ops.overlap_max import overlap_max_merge

PAD_CODE = 5
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


def resolve_rnn_kernel(mode: str) -> bool:
    """Whether the engine takes the fused route (``engine.py:587-609``).

    ``"fused"`` and ``"scan"`` force a route; ``"auto"`` is the fused
    route on every device.  The JAX package's ``auto`` keeps the scan off
    the TPU because its fused kernel would run in the slow Pallas
    interpreter there; the port's fused route on the CPU runs the exact
    plain version of the kernel instead, so ``auto`` keeps the route the
    port has taken since it began, on the card and on the CPU.
    """
    if mode not in ("auto", "scan", "fused"):
        raise ValueError(f"rnn_kernel must be auto|scan|fused, got {mode!r}")
    return mode != "scan"


def one_hot(codes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Code windows ``[B, T]`` -> one-hot ``[B, T, 5]`` in ``dtype``; pad
    code 5 gives the all-zero row (``engine.py:67-70``)."""
    eye = torch.eye(PAD_CODE + 1, dtype=dtype, device=codes.device)
    return eye[codes.long()][..., :PAD_CODE]


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

    def predict_scored(self, codes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-position ``(classes int8 [L], max_prob float32 [L])``.

        ``codes`` is the sequence's int8 code track (A=0..T=3, N=4).
        Positions no window covers come back as class 0 with probability 0
        (the reference merges into a zero buffer).
        """
        config = self.model.config
        vecsize, step, batch = config.vecsize, self.step_size, self.batch_size
        out_len = int(codes.shape[0])
        n_windows = window_starts(out_len, vecsize, step).size
        out_classes = np.zeros(out_len, np.int8)
        out_maxp = np.zeros(out_len, np.float32)
        if n_windows == 0:
            return out_classes, out_maxp

        k = -(-vecsize // step)
        n_chunks = -(-n_windows // batch)
        block_rows = batch * step
        span = (batch - 1) * step + vecsize
        spill_rows = max(span - block_rows, 0)  # == vecsize - step if > 0
        rows = (n_chunks * batch + k) * step
        padded = np.full(rows, PAD_CODE, np.int8)
        padded[:min(out_len, rows)] = codes[:rows]
        device = self.model.device
        # [n_chunks*batch + ..., vecsize] view: window w starts at w*step.
        windows = torch.from_numpy(padded).to(device).unfold(0, vecsize, step)

        total = n_chunks * block_rows + spill_rows
        # Both score tracks live in one byte buffer (maxp, then classes),
        # so they come back to the host in one copy; storing maxp in the
        # bfloat16 track rounds it (to nearest even).
        maxp_size = torch.finfo(self.compute_dtype).bits // 8
        tracks = torch.empty((maxp_size + 1) * total, dtype=torch.uint8,
                             device=device)
        maxp_d = tracks[:maxp_size * total].view(self.compute_dtype)
        classes_d = tracks[maxp_size * total:].view(torch.int8)
        spill = torch.zeros(spill_rows, config.n_classes, device=device)
        for c in range(n_chunks):
            chunk = windows[c * batch:(c + 1) * batch].contiguous()
            probs = self._probs(chunk)
            n_real = n_windows - c * batch
            if n_real < batch:
                probs[n_real:] = 0.0
            merged = overlap_max_merge(probs, step, max(span, block_rows))
            block = merged[:block_rows]
            if spill_rows:
                torch.maximum(block[:spill_rows], spill,
                              out=block[:spill_rows])
                spill = merged[block_rows:]
            lo = c * block_rows
            classes_d[lo:lo + block_rows] = block.argmax(dim=1)
            maxp_d[lo:lo + block_rows] = block.amax(dim=1)
        if spill_rows:
            # The final spill's rows: no further chunk reaches them.
            classes_d[n_chunks * block_rows:] = spill.argmax(dim=1)
            maxp_d[n_chunks * block_rows:] = spill.amax(dim=1)

        tracks_h = tracks.cpu().numpy()
        if maxp_size == 2:
            # numpy has no bfloat16: widen the 16 bits into the top half of
            # a float32 (exact).
            u16 = tracks_h[:2 * total].view(np.uint16)
            maxp_h = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            maxp_h = tracks_h[:4 * total].view(np.float32)
        classes_h = tracks_h[maxp_size * total:].view(np.int8)
        take = min(out_len, total)
        out_classes[:take] = classes_h[:take]
        out_maxp[:take] = maxp_h[:take]
        return out_classes, out_maxp

