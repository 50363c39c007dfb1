"""Plain PyTorch versions of the fused recurrence kernels.

``gru_avg_plain`` and ``lstm_avg_plain`` compute exactly what the CUDA
kernels in ``csrc/rnn_avg.cu`` compute (and what the JAX package's
``pallas_gru_avg`` / ``pallas_lstm_avg`` compute): the shared cell runs over
the doubled batch of forward rows and their reverse complements, with Keras
gate math, and returns the branch average.  They are a Python loop over T
in torch ops: the CPU path of :mod:`deepgrp_tpu_torch.models.cuda_rnn` and
the reference the kernels are held against on the card.

Parameter layout (Keras, ``deepgrp_tpu/models/rnn.py``):

* GRU (``reset_after=True``): gate order (z, r, h), ``kernel [5, 3u]``,
  ``recurrent [u, 3u]``, ``bias [2, 3u]`` (input row 0, recurrent row 1)::

      z = sigmoid(x W_z + b_iz + h U_z + b_rz)
      r = sigmoid(x W_r + b_ir + h U_r + b_rr)
      hh = tanh(x W_h + b_ih + r * (h U_h + b_rh))
      h' = z * h + (1 - z) * hh

* LSTM: gate order (i, f, c, o), ``kernel [5, 4u]``, ``recurrent [u, 4u]``,
  ``bias [4u]``; ``c' = f * c + i * g``, ``h' = o * tanh(c')``.

The input projection of a one-hot row is a row select: ``x W == W[code]``;
pad code 5 is the all-zero row and selects bias only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from deepgrp_tpu_torch._build import LaunchCounter

RnnParams = Dict[str, torch.Tensor]

# DNA complement for codes 0..5 (A<->T, C<->G, N->N, pad->pad).
COMPLEMENT_CODES = (3, 2, 1, 0, 4, 5)

#: Calls of the plain versions, by name (proof that a kernel path did not
#: take them).
PLAIN_CALLS = LaunchCounter()


def _doubled_codes(codes: torch.Tensor) -> torch.Tensor:
    """``[2B, T]`` int64: the forward rows, then their reverse complements."""
    comp = torch.tensor(COMPLEMENT_CODES, device=codes.device)
    codes = codes.long()
    return torch.cat([codes, comp[codes.flip(1)]], dim=0)


def _input_projection(kernel: torch.Tensor, bias_in: torch.Tensor,
                      both: torch.Tensor) -> torch.Tensor:
    """``bias + W[code]`` for every step, ``[2B, T, g*u]``."""
    rows = torch.cat([kernel, kernel.new_zeros(1, kernel.shape[1])])
    return bias_in + rows[both]


def gru_avg_plain(params: RnnParams,
                  codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fwd+revcomp GRU with branch averaging, as a loop over T.

    Args:
        params: ``kernel [5, 3u]``, ``recurrent [u, 3u]``, ``bias [2, 3u]``.
        codes: ``[B, T]`` integer base codes (A=0..T=3, N=4, pad=5).

    Returns:
        ``(avg [B, T, u], hidden_avg [B, u])`` float32.
    """
    PLAIN_CALLS.add("gru_avg")
    batch, steps = codes.shape
    recurrent = params["recurrent"]
    units = recurrent.shape[0]
    bias_rec = params["bias"][1]
    xp = _input_projection(params["kernel"], params["bias"][0],
                           _doubled_codes(codes))
    h = xp.new_zeros(2 * batch, units)
    avg = xp.new_empty(batch, steps, units)
    for t in range(steps):
        x = xp[:, t]
        rp = h @ recurrent + bias_rec
        z = torch.sigmoid(x[:, :units] + rp[:, :units])
        r = torch.sigmoid(x[:, units:2 * units] + rp[:, units:2 * units])
        hh = torch.tanh(x[:, 2 * units:] + r * rp[:, 2 * units:])
        h = z * h + (1.0 - z) * hh
        avg[:, t] = (h[:batch] + h[batch:]) * 0.5
    return avg, avg[:, -1].clone()


def lstm_avg_plain(params: RnnParams,
                   codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM counterpart of :func:`gru_avg_plain` (same contract).

    ``params``: ``kernel [5, 4u]``, ``recurrent [u, 4u]``, ``bias [4u]``.
    """
    PLAIN_CALLS.add("lstm_avg")
    batch, steps = codes.shape
    recurrent = params["recurrent"]
    units = recurrent.shape[0]
    xp = _input_projection(params["kernel"], params["bias"],
                           _doubled_codes(codes))
    h = xp.new_zeros(2 * batch, units)
    c = xp.new_zeros(2 * batch, units)
    avg = xp.new_empty(batch, steps, units)
    for t in range(steps):
        gates = xp[:, t] + h @ recurrent
        i = torch.sigmoid(gates[:, :units])
        f = torch.sigmoid(gates[:, units:2 * units])
        g = torch.tanh(gates[:, 2 * units:3 * units])
        o = torch.sigmoid(gates[:, 3 * units:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        avg[:, t] = (h[:batch] + h[batch:]) * 0.5
    return avg, avg[:, -1].clone()
