"""Plain PyTorch versions of the recurrence kernels, the one-hot
recurrences, and the cell's initialisation and dropout masks.

``gru_avg_plain`` and ``lstm_avg_plain`` compute exactly what the CUDA
kernels in ``csrc/rnn_avg.cu`` (past their cluster tiles ``csrc/rnn_grid.cu``)
compute (and what the JAX package's
``pallas_gru_avg`` / ``pallas_lstm_avg`` compute): the shared cell runs over
the doubled batch of forward rows and their reverse complements, with Keras
gate math, and returns the branch average.  The ``*_train_fwd_plain`` /
``*_train_bwd_plain`` functions are the same for the training kernels of
``csrc/rnn_train.cu`` (from u=1024 ``csrc/rnn_grid.cu``; the JAX package's
``pallas_rnn_train.py``): a
forward with per-gate input dropout masks that also returns the hidden (and
cell) sequence, and an explicit reverse loop over T for the gradients.
They are loops over T in torch ops: the CPU path of
:mod:`deepgrp_tpu_torch.models.cuda_rnn` and the reference the kernels are
held against on the card.

``gru_apply`` and ``lstm_apply`` are the one-hot recurrences of the JAX
package (``deepgrp_tpu/models/rnn.py``) over a float input ``x [B, T, I]``
with a real input dot ``x W + b``; ``gru_apply`` is also the plain version
of the ``csrc/rnn_seq.cu`` kernel (``pallas_gru_apply``; past u=1024 of
``csrc/rnn_grid.cu``'s ``dg_seq_grid``).
``gru_train_apply`` and ``lstm_train_apply`` are the same recurrences for
training, with per-gate input dropout masks, differentiated by autograd.

Precision.  In float32 every product and sum is float32 (the JAX
package's ``Precision.HIGHEST``).  The bfloat16 fast mode follows the TPU's
``DEFAULT`` precision as the kernels run it: the operands of each dot are
rounded to bfloat16 (the weights, and the hidden state ``h`` at every
step), the products are summed in float32, the carried state and the gate
math stay float32, and only the outputs are stored as bfloat16.

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
pad code 5 is the all-zero row and selects bias only.  Keras input dropout
scales the selected row per gate: ``mask[g, row, code] * W_g[code]``, with
``masks [g, 2B, 5]`` over the doubled batch (rows ``0..B-1`` forward,
``B..2B-1`` reverse complement), shared over time.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

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


def _round_to(tensor: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``tensor`` rounded to ``dtype`` and back to float32 (the operand of
    a dot at the mode's precision; itself in float32 mode)."""
    if dtype == torch.float32:
        return tensor
    return tensor.to(dtype).to(torch.float32)


def dtype_suffix(out_dtype: torch.dtype) -> str:
    """The name suffix of a kernel's output type: ``""`` or ``"_bf16"``
    (raises for any other type)."""
    if out_dtype == torch.float32:
        return ""
    if out_dtype == torch.bfloat16:
        return "_bf16"
    raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                     f"{out_dtype}")


def gru_avg_plain(params: RnnParams, codes: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fwd+revcomp GRU with branch averaging, as a loop over T.

    Args:
        params: ``kernel [5, 3u]``, ``recurrent [u, 3u]``, ``bias [2, 3u]``
            float32.
        codes: ``[B, T]`` integer base codes (A=0..T=3, N=4, pad=5).
        out_dtype: float32, or bfloat16 for the fast mode (``h`` and ``U``
            rounded to bfloat16 for the recurrent dot; the input row
            select, the carry and the average stay float32).

    Returns:
        ``(avg [B, T, u], hidden_avg [B, u])`` in ``out_dtype``.
    """
    PLAIN_CALLS.add("gru_avg" + dtype_suffix(out_dtype))
    batch, steps = codes.shape
    recurrent = _round_to(params["recurrent"], out_dtype)
    units = recurrent.shape[0]
    bias_rec = params["bias"][1]
    xp = _input_projection(params["kernel"], params["bias"][0],
                           _doubled_codes(codes))
    h = xp.new_zeros(2 * batch, units)
    avg = xp.new_empty(batch, steps, units)
    for t in range(steps):
        x = xp[:, t]
        rp = _round_to(h, out_dtype) @ recurrent + bias_rec
        z = torch.sigmoid(x[:, :units] + rp[:, :units])
        r = torch.sigmoid(x[:, units:2 * units] + rp[:, units:2 * units])
        hh = torch.tanh(x[:, 2 * units:] + r * rp[:, 2 * units:])
        h = z * h + (1.0 - z) * hh
        avg[:, t] = (h[:batch] + h[batch:]) * 0.5
    avg = avg.to(out_dtype)
    return avg, avg[:, -1].clone()


def lstm_avg_plain(params: RnnParams, codes: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM counterpart of :func:`gru_avg_plain` (same contract).

    ``params``: ``kernel [5, 4u]``, ``recurrent [u, 4u]``, ``bias [4u]``.
    """
    PLAIN_CALLS.add("lstm_avg" + dtype_suffix(out_dtype))
    batch, steps = codes.shape
    recurrent = _round_to(params["recurrent"], out_dtype)
    units = recurrent.shape[0]
    xp = _input_projection(params["kernel"], params["bias"],
                           _doubled_codes(codes))
    h = xp.new_zeros(2 * batch, units)
    c = xp.new_zeros(2 * batch, units)
    avg = xp.new_empty(batch, steps, units)
    for t in range(steps):
        gates = xp[:, t] + _round_to(h, out_dtype) @ recurrent
        i = torch.sigmoid(gates[:, :units])
        f = torch.sigmoid(gates[:, units:2 * units])
        g = torch.tanh(gates[:, 2 * units:3 * units])
        o = torch.sigmoid(gates[:, 3 * units:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        avg[:, t] = (h[:batch] + h[batch:]) * 0.5
    avg = avg.to(out_dtype)
    return avg, avg[:, -1].clone()


# -- one-hot recurrences (deepgrp_tpu/models/rnn.py) -----------------------


def _io_dtype(x: torch.Tensor) -> torch.dtype:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, I], got {tuple(x.shape)}")
    return x.dtype


def _seq_projection(params: RnnParams, x: torch.Tensor,
                    bias_in: torch.Tensor) -> torch.Tensor:
    """``x W + b`` for every step, float32 ``[B, T, g*u]`` (operands at the
    precision of ``x``'s dtype)."""
    kernel = _round_to(params["kernel"].to(torch.float32), x.dtype)
    return x.to(torch.float32) @ kernel + bias_in.to(torch.float32)


def gru_apply(params: RnnParams,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU over ``x [B, T, I]`` (``rnn.py:77-133``, inference).

    The plain version of the ``dg_gru_seq`` kernel (``csrc/rnn_seq.cu``,
    the TPU's ``pallas_gru_apply``): Keras ``reset_after=True`` gate math
    with ``kernel [I, 3u]``, ``recurrent [u, 3u]``, ``bias [2, 3u]``.
    ``x`` is float32 or bfloat16; the parameters are rounded to its type
    (bfloat16: ``DEFAULT`` precision, module docstring).

    Returns:
        ``(seq [B, T, u], last [B, u])`` in ``x``'s dtype; ``last`` is the
        state after step ``T-1`` (zeros for ``T = 0``).
    """
    PLAIN_CALLS.add("gru_seq")
    dtype = _io_dtype(x)
    bias = params["bias"].to(torch.float32)
    return _gru_steps(_seq_projection(params, x, bias[0]),
                      params["recurrent"].to(torch.float32), bias[1], dtype)


def _gru_steps(xp: torch.Tensor, recurrent: torch.Tensor,
               bias_rec: torch.Tensor, dtype: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU's loop over T from the input projections ``xp [B, T, 3u]``
    (float32); ``h`` and ``recurrent`` enter the dot at ``dtype``'s
    precision.  Returns ``(seq, last)`` in ``dtype``."""
    recurrent = _round_to(recurrent, dtype)
    units = recurrent.shape[0]
    h = xp.new_zeros(xp.shape[0], units)
    states = []
    for t in range(xp.shape[1]):
        xt = xp[:, t]
        rp = _round_to(h, dtype) @ recurrent + bias_rec
        z = torch.sigmoid(xt[:, :units] + rp[:, :units])
        r = torch.sigmoid(xt[:, units:2 * units] + rp[:, units:2 * units])
        hh = torch.tanh(xt[:, 2 * units:] + r * rp[:, 2 * units:])
        h = z * h + (1.0 - z) * hh
        states.append(h)
    return _stack_states(states, xp, units).to(dtype), h.to(dtype)


def _stack_states(states, xp: torch.Tensor, units: int) -> torch.Tensor:
    """The per-step states as ``[B, T, u]`` (empty for ``T = 0``)."""
    if not states:
        return xp.new_empty(xp.shape[0], 0, units)
    return torch.stack(states, dim=1)


def lstm_apply(params: RnnParams,
               x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM over ``x [B, T, I]`` (``rnn.py:136-182``, inference).

    Gate order (i, f, c, o), ``kernel [I, 4u]``, ``recurrent [u, 4u]``,
    ``bias [4u]``; precision as :func:`gru_apply`.  No TPU kernel
    computes this function (XLA's scan does), so it is plain torch on
    every device and counts no plain-version call.

    Returns:
        ``(seq [B, T, u], last [B, u])`` in ``x``'s dtype.
    """
    dtype = _io_dtype(x)
    return _lstm_steps(_seq_projection(params, x, params["bias"]),
                       params["recurrent"].to(torch.float32), dtype)


def _lstm_steps(xp: torch.Tensor, recurrent: torch.Tensor,
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM's loop over T from ``xp [B, T, 4u]`` (the bias included);
    as :func:`_gru_steps`."""
    recurrent = _round_to(recurrent, dtype)
    units = recurrent.shape[0]
    h = xp.new_zeros(xp.shape[0], units)
    c = xp.new_zeros(xp.shape[0], units)
    states = []
    for t in range(xp.shape[1]):
        gates = xp[:, t] + _round_to(h, dtype) @ recurrent
        i = torch.sigmoid(gates[:, :units])
        f = torch.sigmoid(gates[:, units:2 * units])
        g = torch.tanh(gates[:, 2 * units:3 * units])
        o = torch.sigmoid(gates[:, 3 * units:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        states.append(h)
    return _stack_states(states, xp, units).to(dtype), h.to(dtype)


# -- trainable one-hot recurrences (the JAX package's scan route) -----------


def _masked_projection(kernel: torch.Tensor, bias_in: torch.Tensor,
                       x: torch.Tensor,
                       masks: Optional[torch.Tensor]) -> torch.Tensor:
    """``x W + b`` for every step with Keras input dropout: gate ``g``'s
    columns take ``(x * masks[g]) @ W_g`` (``rnn.py:109-118``, ``masks [g,
    B, I]`` shared over T); ``None``: ``x W + b``."""
    if masks is None:
        return x @ kernel + bias_in
    units = kernel.shape[1] // masks.shape[0]
    projs = [(x * mask[:, None, :]) @ kernel[:, g * units:(g + 1) * units]
             for g, mask in enumerate(masks)]
    return torch.cat(projs, dim=-1) + bias_in


def gru_train_apply(params: RnnParams, x: torch.Tensor,
                    masks: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU over a float32 input ``x [B, T, I]`` for training, with
    input dropout ``masks [3, B, I]`` (or ``None``): the JAX package's
    ``gru_apply`` under ``jax.grad`` (``rnn.py:77-133``).  The plain loop,
    differentiated by autograd on every device: the JAX package runs it as
    XLA's scan, and no TPU kernel has its backward (``gru_seq`` is
    inference-only).  Returns ``(seq [B, T, u], last [B, u])``."""
    bias = params["bias"]
    xp = _masked_projection(params["kernel"], bias[0], x, masks)
    return _gru_steps(xp, params["recurrent"], bias[1], torch.float32)


def lstm_train_apply(params: RnnParams, x: torch.Tensor,
                     masks: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM counterpart of :func:`gru_train_apply` (``rnn.py:136-182``,
    ``masks [4, B, I]``)."""
    xp = _masked_projection(params["kernel"], params["bias"], x, masks)
    return _lstm_steps(xp, params["recurrent"], torch.float32)


# -- initialisation and dropout ---------------------------------------------


def glorot_uniform(shape: Tuple[int, int],
                   generator: torch.Generator) -> torch.Tensor:
    """Keras ``glorot_uniform``: U(-l, l), ``l = sqrt(6 / (fan_in +
    fan_out))`` for a ``[fan_in, fan_out]`` matrix."""
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


# torch's host thread count is process-wide: one guard at a time may set
# it and restore the caller's (the HPO fleet and the launcher draw initial
# weights from several threads).
_THREADS_LOCK = threading.Lock()


def _orthogonal(shape: Tuple[int, int],
                generator: torch.Generator) -> torch.Tensor:
    """Keras / JAX ``orthogonal``: orthonormal rows (or columns) from the
    QR of a normal matrix, signs fixed by ``diag(R)``.

    The QR (LAPACK on the host) gives other bits at other thread counts, so
    it runs at one thread whatever the caller's count, which is restored:
    the same seed gives the same weights at any ``-t``."""
    out = torch.empty(shape)
    with _THREADS_LOCK:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            torch.nn.init.orthogonal_(out, generator=generator)
        finally:
            torch.set_num_threads(threads)
    return out


def gru_init(input_dim: int, units: int,
             generator: torch.Generator) -> RnnParams:
    """Keras-default GRU initialisation (``deepgrp_tpu/models/rnn.py:39``):
    glorot-uniform kernel, orthogonal recurrent, zero biases.  CPU
    tensors drawn from ``generator``."""
    return {"kernel": glorot_uniform((input_dim, 3 * units), generator),
            "recurrent": _orthogonal((units, 3 * units), generator),
            "bias": torch.zeros(2, 3 * units)}


def lstm_init(input_dim: int, units: int,
              generator: torch.Generator) -> RnnParams:
    """Keras-default LSTM initialisation (``rnn.py:51``), with the unit
    forget-gate bias."""
    bias = torch.zeros(4 * units)
    bias[units:2 * units] = 1.0
    return {"kernel": glorot_uniform((input_dim, 4 * units), generator),
            "recurrent": _orthogonal((units, 4 * units), generator),
            "bias": bias}


def input_dropout_masks(generator: torch.Generator, rows: int, rate: float,
                        n_gates: int, input_dim: int = 5) -> torch.Tensor:
    """Keras RNN input-dropout masks, ``[n_gates, rows, input_dim]``
    float32 of ``Bernoulli(keep) / keep`` (``rnn.py:64``), on the
    generator's device.  ``rows`` is the doubled batch ``2B``: rows
    ``0..B-1`` mask the forward branch, ``B..2B-1`` the reverse
    complement."""
    keep = 1.0 - rate
    probs = torch.full((n_gates, rows, input_dim), keep,
                       device=generator.device)
    return torch.bernoulli(probs, generator=generator) / keep


# -- training recurrences (plain versions of csrc/rnn_train.cu) -------------


def _mask_scale(masks: Optional[torch.Tensor], both: torch.Tensor,
                units: int) -> Optional[torch.Tensor]:
    """Per-gate scale of each step's selected input row, ``[2B, T, g*u]``
    (``None`` without masks; pad steps get scale 1, their row is zero)."""
    if masks is None:
        return None
    n_gates, rows, _ = masks.shape
    padded = torch.cat([masks, masks.new_ones(n_gates, rows, 1)], dim=2)
    scale = padded.gather(2, both[None].expand(n_gates, -1, -1))
    return scale.permute(1, 2, 0).repeat_interleave(units, dim=2)


def _train_projection(kernel: torch.Tensor, bias_in: torch.Tensor,
                      both: torch.Tensor,
                      scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``bias + scale * W[code]`` for every step, ``[2B, T, g*u]``."""
    rows = torch.cat([kernel, kernel.new_zeros(1, kernel.shape[1])])
    selected = rows[both]
    return bias_in + (selected if scale is None else scale * selected)


def _kernel_grad(d_xp: torch.Tensor, both: torch.Tensor,
                 scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``dW[c] = sum over (row, t) with code c of scale * d_xp``, ``[5,
    g*u]`` (pad steps select no row)."""
    width = d_xp.shape[-1]
    contrib = d_xp if scale is None else scale * d_xp
    rows = d_xp.new_zeros(6, width).index_add_(0, both.reshape(-1),
                                               contrib.reshape(-1, width))
    return rows[:5]


def gru_avg_train_fwd_plain(
        params: RnnParams, codes: torch.Tensor,
        masks: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward of the fused GRU (``_gru_train_fwd_kernel``).

    Args:
        params: ``kernel [5, 3u]``, ``recurrent [u, 3u]``, ``bias [2, 3u]``.
        codes: ``[B, T]`` integer base codes.
        masks: ``[3, 2B, 5]`` per-gate input dropout scales, or ``None``.

    Returns:
        ``(avg [B, T, u], hidden_avg [B, u], hseq [2B, T, u])``; ``hseq``
        holds both branches' hidden states, forward rows first.
    """
    PLAIN_CALLS.add("gru_train_fwd")
    batch = codes.shape[0]
    recurrent = params["recurrent"]
    units = recurrent.shape[0]
    both = _doubled_codes(codes)
    xp = _train_projection(params["kernel"], params["bias"][0], both,
                           _mask_scale(masks, both, units))
    bias_rec = params["bias"][1]
    h = xp.new_zeros(2 * batch, units)
    states = []
    for t in range(codes.shape[1]):
        x = xp[:, t]
        rp = h @ recurrent + bias_rec
        z = torch.sigmoid(x[:, :units] + rp[:, :units])
        r = torch.sigmoid(x[:, units:2 * units] + rp[:, units:2 * units])
        hh = torch.tanh(x[:, 2 * units:] + r * rp[:, 2 * units:])
        h = z * h + (1.0 - z) * hh
        states.append(h)
    hseq = torch.stack(states, dim=1)
    avg = (hseq[:batch] + hseq[batch:]) * 0.5
    return avg, avg[:, -1].clone(), hseq


def gru_bwd_recurrence_plain(
        params: RnnParams, codes: torch.Tensor,
        masks: Optional[torch.Tensor], hseq: torch.Tensor,
        d_avg: torch.Tensor, d_hidden: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential part of the fused GRU's backward (the recurrence
    kernel of ``csrc/rnn_train.cu``): an explicit reverse loop over T
    carrying ``dh`` (seeded ``d_hidden / 2`` on both branch rows, plus
    ``d_avg[t] / 2`` each step), the gates recomputed from ``h_prev`` with
    ``rp = h_prev U + b_rec``::

        da_z = dh (h_prev - hh) z (1-z)    da_h = dh (1-z) (1 - hh^2)
        da_r = (da_h rh) r (1-r)
        d_xp = [da_z, da_r, da_h]          d_rp = [da_z, da_r, da_h r]
        dh_prev = dh z + d_rp U^T

    Returns:
        ``(d_rp [2B, T, 3u], d_xp [2B, T, 3u])``, forward rows first: the
        cotangents of the recurrent and of the input preactivations.
    """
    batch, steps = codes.shape
    recurrent = params["recurrent"]
    units = recurrent.shape[0]
    both = _doubled_codes(codes)
    xp = _train_projection(params["kernel"], params["bias"][0], both,
                           _mask_scale(masks, both, units))
    bias_rec = params["bias"][1]
    half = d_hidden * 0.5
    dh = torch.cat([half, half])
    d_rp_seq = xp.new_empty(xp.shape)
    d_xp_seq = xp.new_empty(xp.shape)
    zeros = hseq.new_zeros(2 * batch, units)
    for t in reversed(range(steps)):
        h_prev = hseq[:, t - 1] if t > 0 else zeros
        x = xp[:, t]
        rp = h_prev @ recurrent + bias_rec
        z = torch.sigmoid(x[:, :units] + rp[:, :units])
        r = torch.sigmoid(x[:, units:2 * units] + rp[:, units:2 * units])
        rh = rp[:, 2 * units:]
        hh = torch.tanh(x[:, 2 * units:] + r * rh)
        half_avg = d_avg[:, t] * 0.5
        dht = dh + torch.cat([half_avg, half_avg])
        da_z = dht * (h_prev - hh) * z * (1.0 - z)
        da_h = dht * (1.0 - z) * (1.0 - hh * hh)
        da_r = (da_h * rh) * r * (1.0 - r)
        d_rp = torch.cat([da_z, da_r, da_h * r], dim=1)
        dh = dht * z + d_rp @ recurrent.T
        d_rp_seq[:, t] = d_rp
        d_xp_seq[:, t] = torch.cat([da_z, da_r, da_h], dim=1)
    return d_rp_seq, d_xp_seq


def gru_avg_train_bwd_plain(
        params: RnnParams, codes: torch.Tensor,
        masks: Optional[torch.Tensor], hseq: torch.Tensor,
        d_avg: torch.Tensor, d_hidden: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the fused GRU (``_gru_train_bwd_kernel``): the plain
    recurrence (:func:`gru_bwd_recurrence_plain`), then the plain
    reduction (:func:`train_reduce_plain`) with ``d_rp`` for ``dU`` and
    the recurrent bias, ``d_xp`` for ``dW`` and the input bias.

    Returns:
        ``(d_kernel [5, 3u], d_recurrent [u, 3u], d_bias [2, 3u])``.
    """
    PLAIN_CALLS.add("gru_train_bwd")
    d_rp_seq, d_xp_seq = gru_bwd_recurrence_plain(params, codes, masks, hseq,
                                                  d_avg, d_hidden)
    return train_reduce_plain(hseq, d_rp_seq, codes, masks, d_xp_seq)


def lstm_avg_train_fwd_plain(
        params: RnnParams, codes: torch.Tensor,
        masks: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward of the fused LSTM (``_lstm_train_fwd_kernel``):
    ``masks [4, 2B, 5]`` or ``None``; returns ``(avg, hidden_avg, hseq,
    cseq)``, the sequences ``[2B, T, u]`` forward rows first."""
    PLAIN_CALLS.add("lstm_train_fwd")
    batch = codes.shape[0]
    recurrent = params["recurrent"]
    units = recurrent.shape[0]
    both = _doubled_codes(codes)
    xp = _train_projection(params["kernel"], params["bias"], both,
                           _mask_scale(masks, both, units))
    h = xp.new_zeros(2 * batch, units)
    c = xp.new_zeros(2 * batch, units)
    h_states, c_states = [], []
    for t in range(codes.shape[1]):
        gates = xp[:, t] + h @ recurrent
        i = torch.sigmoid(gates[:, :units])
        f = torch.sigmoid(gates[:, units:2 * units])
        g = torch.tanh(gates[:, 2 * units:3 * units])
        o = torch.sigmoid(gates[:, 3 * units:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        h_states.append(h)
        c_states.append(c)
    hseq = torch.stack(h_states, dim=1)
    avg = (hseq[:batch] + hseq[batch:]) * 0.5
    return avg, avg[:, -1].clone(), hseq, torch.stack(c_states, dim=1)


def lstm_bwd_recurrence_plain(
        params: RnnParams, codes: torch.Tensor,
        masks: Optional[torch.Tensor], hseq: torch.Tensor,
        cseq: torch.Tensor, d_avg: torch.Tensor, d_hidden: torch.Tensor
) -> torch.Tensor:
    """The sequential part of the fused LSTM's backward (the recurrence
    kernel of ``csrc/rnn_train.cu``): an explicit reverse loop over T
    carrying ``(dh, dc)`` (seeded ``d_hidden / 2`` on both branch rows,
    plus ``d_avg[t] / 2`` each step), the gates recomputed from
    ``(h_prev, c_prev)``::

        do = dh tanh(c)          dc_t = dc + dh o (1 - tanh(c)^2)
        da = [dc_t g i(1-i), dc_t c_prev f(1-f), dc_t i (1-g^2), do o(1-o)]
        dh_prev = da U^T         dc_prev = dc_t f

    Returns:
        The gate cotangents ``da [2B, T, 4u]``, forward rows first.
    """
    batch, steps = codes.shape
    recurrent = params["recurrent"]
    units = recurrent.shape[0]
    both = _doubled_codes(codes)
    xp = _train_projection(params["kernel"], params["bias"], both,
                           _mask_scale(masks, both, units))
    half = d_hidden * 0.5
    dh = torch.cat([half, half])
    dc = torch.zeros_like(dh)
    da_seq = xp.new_empty(xp.shape)
    zeros = hseq.new_zeros(2 * batch, units)
    for t in reversed(range(steps)):
        h_prev = hseq[:, t - 1] if t > 0 else zeros
        c_prev = cseq[:, t - 1] if t > 0 else zeros
        gates = xp[:, t] + h_prev @ recurrent
        gi = torch.sigmoid(gates[:, :units])
        gf = torch.sigmoid(gates[:, units:2 * units])
        gg = torch.tanh(gates[:, 2 * units:3 * units])
        go = torch.sigmoid(gates[:, 3 * units:])
        tanh_c = torch.tanh(gf * c_prev + gi * gg)
        half_avg = d_avg[:, t] * 0.5
        dht = dh + torch.cat([half_avg, half_avg])
        d_o = dht * tanh_c
        dc_t = dc + dht * go * (1.0 - tanh_c * tanh_c)
        da = torch.cat([(dc_t * gg) * gi * (1.0 - gi),
                        (dc_t * c_prev) * gf * (1.0 - gf),
                        (dc_t * gi) * (1.0 - gg * gg),
                        d_o * go * (1.0 - go)], dim=1)
        dh = da @ recurrent.T
        dc = dc_t * gf
        da_seq[:, t] = da
    return da_seq


def train_reduce_plain(
        hseq: torch.Tensor, r1_seq: torch.Tensor, codes: torch.Tensor,
        masks: Optional[torch.Tensor],
        r2_seq: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The parameter gradients of a fused recurrence from its gate
    cotangents (the reduction kernel of ``csrc/rnn_train.cu``): sums over
    every ``(row, t)`` of the doubled batch of ``r1`` (the cotangent of the
    recurrent preactivations) and ``r2`` (of the input preactivations;
    LSTM passes none, and then it is ``r1``)::

        dU = sum h_prev^T r1   (h_prev = hseq one step back, zero at t=0)
        dW[c] = sum_{code==c} mask_c r2
        db = sum r1 (LSTM, [4u]); [sum r2, sum r1] (GRU, [2, 3u])

    Returns:
        ``(d_kernel [5, g*u], d_recurrent [u, g*u], d_bias)``.
    """
    rows, _, units = hseq.shape
    width = r1_seq.shape[-1]
    both = _doubled_codes(codes)
    h_prev = torch.cat([hseq.new_zeros(rows, 1, units), hseq[:, :-1]], dim=1)
    flat_r1 = r1_seq.reshape(-1, width)
    d_rec = h_prev.reshape(-1, units).T @ flat_r1
    input_seq = r1_seq if r2_seq is None else r2_seq
    d_kernel = _kernel_grad(input_seq, both, _mask_scale(masks, both, units))
    if r2_seq is None:
        return d_kernel, d_rec, flat_r1.sum(0)
    d_bias = torch.stack([r2_seq.reshape(-1, width).sum(0), flat_r1.sum(0)])
    return d_kernel, d_rec, d_bias


def lstm_avg_train_bwd_plain(
        params: RnnParams, codes: torch.Tensor,
        masks: Optional[torch.Tensor], hseq: torch.Tensor,
        cseq: torch.Tensor, d_avg: torch.Tensor, d_hidden: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the fused LSTM (``_lstm_train_bwd_kernel``): the plain
    recurrence (:func:`lstm_bwd_recurrence_plain`), then the plain
    reduction (:func:`train_reduce_plain`).

    Returns:
        ``(d_kernel [5, 4u], d_recurrent [u, 4u], d_bias [4u])``.
    """
    PLAIN_CALLS.add("lstm_train_bwd")
    da_seq = lstm_bwd_recurrence_plain(params, codes, masks, hseq, cseq,
                                       d_avg, d_hidden)
    return train_reduce_plain(hseq, da_seq, codes, masks)
