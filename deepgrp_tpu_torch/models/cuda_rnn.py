"""Wrappers of the recurrence kernels (``csrc/rnn_avg.cu``,
``csrc/rnn_train.cu``, ``csrc/rnn_seq.cu``).

Inference: counterpart of ``deepgrp_tpu/models/pallas_rnn.py``
(``pallas_gru_avg``, ``pallas_lstm_avg``), with the same contract:
``codes [B, T]`` in, ``(avg [B, T, u], hidden_avg [B, u])`` out in
``out_dtype`` (float32, or bfloat16 for the fast mode).  :func:`gru_apply`
is the counterpart of ``pallas_gru_apply``: the GRU over a float input
``x [B, T, C]``, ``(seq, last)`` out in ``x``'s dtype.

Training: :class:`GruAvgTrain` and :class:`LstmAvgTrain`, the
``torch.autograd.Function`` counterparts of the custom VJPs
``pallas_gru_avg_train`` / ``pallas_lstm_avg_train``
(``deepgrp_tpu/models/pallas_rnn_train.py``).  Their forward runs the
training forward kernel (per-gate input dropout masks, hidden and cell
sequences kept for the backward); their backward runs the recurrence
kernel, which recomputes the gates and writes the gate cotangents, and the
reduction kernel, which sums them into the gradients of the three
parameters (none for the codes and masks).

For a tensor on the CPU a wrapper runs the plain version
(:mod:`deepgrp_tpu_torch.models.rnn`); for a CUDA tensor it launches the
kernel on the current stream or raises.  ``LAUNCHES`` counts the kernel
launches by name: ``gru_avg``, ``lstm_avg``, ``gru_avg_bf16``,
``lstm_avg_bf16``, ``gru_seq`` (either dtype), ``gru_train_fwd``,
``gru_train_bwd``, ``lstm_train_fwd``, ``lstm_train_bwd`` (a backward
counts once, for either cell: it is the recurrence kernel, the reduction
kernel and the sum of the reduction's partials).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from deepgrp_tpu_torch import _build
from deepgrp_tpu_torch.models import rnn
from deepgrp_tpu_torch.models.rnn import RnnParams

#: Kernel launches by name.
LAUNCHES = _build.LaunchCounter()


def gru_avg(params: RnnParams, codes: torch.Tensor,
            out_dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fwd+revcomp GRU with branch averaging (inference).

    ``params``: ``kernel [5, 3u]``, ``recurrent [u, 3u]``, ``bias [2, 3u]``
    float32; ``codes``: int8 ``[B, T]`` (A=0..T=3, N=4, pad=5);
    ``out_dtype``: float32, or bfloat16 (the fast mode, kernel
    ``gru_avg_bf16``: see :func:`~deepgrp_tpu_torch.models.rnn.
    gru_avg_plain`).
    """
    if codes.device.type == "cpu":
        return rnn.gru_avg_plain(params, codes, out_dtype)
    return _launch("gru_avg", 3, params, codes, out_dtype)


def lstm_avg(params: RnnParams, codes: torch.Tensor,
             out_dtype: torch.dtype = torch.float32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM counterpart of :func:`gru_avg` (``bias [4u]``)."""
    if codes.device.type == "cpu":
        return rnn.lstm_avg_plain(params, codes, out_dtype)
    return _launch("lstm_avg", 4, params, codes, out_dtype)


def _check(name: str, gates: int, params: RnnParams,
           codes: torch.Tensor) -> Tuple[int, int, int]:
    """Validates a kernel's inputs; returns ``(batch, steps, units)``."""
    if codes.device.type != "cuda":
        raise ValueError(f"{name}: codes on {codes.device}; the kernel "
                         "takes CUDA tensors")
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise ValueError(f"{name}: codes must be int8 [B, T], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous")
    batch, steps = codes.shape
    if steps == 0:
        raise ValueError(f"{name}: codes have no time steps")
    units = params["recurrent"].shape[0]
    width = gates * units
    bias_shape = (2, width) if gates == 3 else (width,)
    expect = {"kernel": (5, width), "recurrent": (units, width),
              "bias": bias_shape}
    for key, shape in expect.items():
        _check_f32(name, key, params[key], shape, codes.device)
    return batch, steps, units


def _check_f32(name: str, key: str, tensor: torch.Tensor, shape: tuple,
               device: torch.device) -> None:
    if tuple(tensor.shape) != shape:
        raise ValueError(f"{name}: {key} has shape {tuple(tensor.shape)}, "
                         f"expected {shape}")
    if (tensor.dtype != torch.float32 or tensor.device != device
            or not tensor.is_contiguous()):
        raise ValueError(f"{name}: {key} must be contiguous float32 on "
                         f"{device}")


def _ptr(tensor: Optional[torch.Tensor]) -> Optional[int]:
    return None if tensor is None else tensor.data_ptr()


def _empty(device: torch.device, *shape: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.empty(*shape, device=device, dtype=dtype)


def _raise_on(lib: ctypes.CDLL, err: int, name: str, shape: str) -> None:
    if err != 0:
        msg = lib.dg_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg}) at {shape}")


def _launch(name: str, gates: int, params: RnnParams, codes: torch.Tensor,
            out_dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    name += rnn.dtype_suffix(out_dtype)
    batch, steps, units = _check(name, gates, params, codes)
    avg = _empty(codes.device, batch, steps, units, dtype=out_dtype)
    hidden = _empty(codes.device, batch, units, dtype=out_dtype)
    if batch == 0:
        return avg, hidden
    lib = _build.load_kernels("rnn_avg")
    fn: Callable[..., int] = getattr(lib, f"dg_{name}")
    windows = avg_tile("lstm" if gates == 4 else "gru", batch, units,
                       codes.device)[0]
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = fn(codes.data_ptr(), batch, steps,
                 params["kernel"].data_ptr(), params["bias"].data_ptr(),
                 params["recurrent"].data_ptr(), units, windows,
                 avg.data_ptr(), hidden.data_ptr(), ctypes.c_void_p(stream))
    _raise_on(lib, err, name, f"B={batch} T={steps} u={units}")
    LAUNCHES.add(name)
    return avg, hidden


def block_windows(batch: int, sms: int, most: int) -> int:
    """Windows a CTA owns: the least that keeps the grid of
    ``ceil(batch / windows)`` CTAs within one wave on ``sms`` SMs, at most
    ``most`` (then the grid takes the fewest waves it can)."""
    return max(1, min(most, -(-batch // max(sms, 1))))


def avg_tile(cell: str, batch: int, units: int,
             device: Optional[torch.device] = None) -> Tuple[int, int]:
    """``(windows a CTA owns, CTAs)`` of the inference kernels of ``cell``
    ("gru" or "lstm") for a batch on a CUDA device (:func:`block_windows`
    with the card's SM count and the kernel's cap at this width: 8 windows
    up to u=128, 2 beyond; a width the kernel refuses gets 1, and its
    launch raises)."""
    device = device or torch.device("cuda")
    gates = 4 if cell == "lstm" else 3
    most = _build.load_kernels("rnn_avg").dg_avg_max_windows(gates, units)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    windows = block_windows(batch, sms, most)
    return windows, -(-batch // windows)


def seq_tile(rows: int, units: int, sms: int) -> Tuple[int, int]:
    """``(rows a CTA, CTAs)`` of the GRU sequence kernel for ``rows`` rows
    on ``sms`` SMs: :func:`block_windows` with the kernel's cap at this
    width (16 rows up to u=128, 4 beyond: ``MaxRows`` in
    ``csrc/rnn_seq.cu``)."""
    rows_a_cta = block_windows(rows, sms, 16 if units <= 128 else 4)
    return rows_a_cta, -(-rows // rows_a_cta)


def seq_layout(units: int, rows_a_cta: int) -> Dict[str, object]:
    """The layout the GRU sequence kernel launches at this width and tile:
    rows a lane group, k-slices a unit and where ``U`` sits ("registers"
    or "L1/L2"); raises ``ValueError`` for a shape the kernel refuses."""
    lib = _build.load_kernels("rnn_seq")
    out = (ctypes.c_int * 3)()
    if lib.dg_gru_seq_layout(units, rows_a_cta, out) == 0:
        raise ValueError(f"gru_seq refuses u={units} with {rows_a_cta} rows "
                         "a CTA")
    return {"rows_a_group": out[0], "slices": out[1],
            "u_in": "registers" if out[2] else "L1/L2"}


def gru_apply(params: RnnParams, x: torch.Tensor, *,
              dropout_rate: float = 0.0,
              dropout_key: Optional[object] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU over a float input ``x [B, T, C]`` (inference only).

    Counterpart of ``pallas_gru_apply`` (``pallas_rnn.py:126``), a
    drop-in for :func:`~deepgrp_tpu_torch.models.rnn.gru_apply`:
    ``params`` ``kernel [C, 3u]``, ``recurrent [u, 3u]``, ``bias [2, 3u]``
    (any float type: ``kernel`` and ``recurrent`` are cast to ``x``'s
    dtype, ``bias`` to float32, as ``pallas_rnn.py:121-122``); ``x``
    float32 or bfloat16.  Returns ``(seq [B, T, u], last [B, u])`` in
    ``x``'s dtype.  Dropout raises ``ValueError``, as ``:135-138``.
    """
    if dropout_key is not None and (
            not isinstance(dropout_rate, (int, float)) or dropout_rate > 0.0):
        raise ValueError("the GRU sequence kernel is inference-only (no "
                         "dropout)")
    if x.device.type == "cpu":
        return rnn.gru_apply(params, x)
    return _launch_seq(params, x)


def _launch_seq(params: RnnParams,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    name = "gru_seq"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}; the kernel takes CUDA "
                         "tensors")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3:
        raise ValueError(f"{name}: x must be float32 or bfloat16 [B, T, C], "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    batch, steps, channels = x.shape
    if steps == 0:
        raise ValueError(f"{name}: x has no time steps")
    units = params["recurrent"].shape[0]
    width = 3 * units
    weights = {"kernel": params["kernel"].to(x.dtype).contiguous(),
               "recurrent": params["recurrent"].to(x.dtype).contiguous(),
               "bias": params["bias"].to(torch.float32).contiguous()}
    expect = {"kernel": (channels, width), "recurrent": (units, width),
              "bias": (2, width)}
    for key, shape in expect.items():
        tensor = weights[key]
        if tuple(tensor.shape) != shape or tensor.device != x.device:
            raise ValueError(f"{name}: {key} has shape "
                             f"{tuple(tensor.shape)} on {tensor.device}, "
                             f"expected {shape} on {x.device}")
    seq = _empty(x.device, batch, steps, units, dtype=x.dtype)
    last = _empty(x.device, batch, units, dtype=x.dtype)
    if batch == 0:
        return seq, last
    lib = _build.load_kernels("rnn_seq")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows_a_cta = seq_tile(batch, units, sms)[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dg_gru_seq(
            x.data_ptr(), batch, steps, channels,
            weights["kernel"].data_ptr(), weights["bias"].data_ptr(),
            weights["recurrent"].data_ptr(), units, rows_a_cta,
            int(x.dtype == torch.bfloat16), seq.data_ptr(), last.data_ptr(),
            ctypes.c_void_p(stream))
    _raise_on(lib, err, name, f"B={batch} T={steps} C={channels} u={units} "
              f"{x.dtype}")
    LAUNCHES.add(name)
    return seq, last


# -- training kernels --------------------------------------------------------


def _check_masks(name: str, gates: int, masks: Optional[torch.Tensor],
                 batch: int, device: torch.device) -> None:
    if masks is not None:
        _check_f32(name, "masks", masks, (gates, 2 * batch, 5), device)


def train_fwd(cell: str, params: RnnParams, codes: torch.Tensor,
              masks: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Launch the training forward kernel of ``cell`` ("gru" or "lstm").

    Returns ``(avg [B, T, u], hidden [B, u], hseq [2B, T, u])`` and, for
    LSTM, ``cseq [2B, T, u]``.
    """
    name, gates = f"{cell}_train_fwd", (4 if cell == "lstm" else 3)
    batch, steps, units = _check(name, gates, params, codes)
    _check_masks(name, gates, masks, batch, codes.device)
    avg = _empty(codes.device, batch, steps, units)
    hidden = _empty(codes.device, batch, units)
    n_seqs = 2 if cell == "lstm" else 1  # hseq (and cseq)
    seqs = [_empty(codes.device, 2 * batch, steps, units)
            for _ in range(n_seqs)]
    if batch == 0:
        return (avg, hidden, *seqs)
    lib = _build.load_kernels("rnn_train")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = getattr(lib, f"dg_{name}")(
            codes.data_ptr(), batch, steps, _ptr(masks),
            params["kernel"].data_ptr(), params["bias"].data_ptr(),
            params["recurrent"].data_ptr(), units,
            avg.data_ptr(), hidden.data_ptr(),
            *(seq.data_ptr() for seq in seqs), ctypes.c_void_p(stream))
    _raise_on(lib, err, name, f"B={batch} T={steps} u={units}")
    LAUNCHES.add(name)
    return (avg, hidden, *seqs)


def train_bwd(cell: str, params: RnnParams, codes: torch.Tensor,
              masks: Optional[torch.Tensor], seqs: Tuple[torch.Tensor, ...],
              d_avg: torch.Tensor, d_hidden: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the training backward of ``cell``: the recurrence kernel,
    then the reduction kernel (:func:`_bwd_recurrence`,
    :func:`_train_reduce`).  ``seqs`` is ``(hseq,)`` or ``(hseq, cseq)``
    from :func:`train_fwd`.  Returns ``(d_kernel, d_recurrent, d_bias)``
    and counts one launch."""
    name, gates = f"{cell}_train_bwd", (4 if cell == "lstm" else 3)
    batch, steps, units = _check(name, gates, params, codes)
    _check_masks(name, gates, masks, batch, codes.device)
    for key, seq in zip(("hseq", "cseq"), seqs):
        _check_f32(name, key, seq, (2 * batch, steps, units), codes.device)
    d_avg = d_avg.to(torch.float32).contiguous()
    d_hidden = d_hidden.to(torch.float32).contiguous()
    _check_f32(name, "d_avg", d_avg, (batch, steps, units), codes.device)
    _check_f32(name, "d_hidden", d_hidden, (batch, units), codes.device)
    grads = [torch.empty_like(params[key])
             for key in ("kernel", "recurrent", "bias")]
    if batch == 0:
        return tuple(g.zero_() for g in grads)
    cotangents = _bwd_recurrence(cell, params, codes, masks, seqs, d_avg,
                                 d_hidden)
    _train_reduce(seqs[0], codes, masks, gates, grads, *cotangents)
    LAUNCHES.add(name)
    return grads[0], grads[1], grads[2]


def _bwd_recurrence(cell: str, params: RnnParams, codes: torch.Tensor,
                    masks: Optional[torch.Tensor],
                    seqs: Tuple[torch.Tensor, ...], d_avg: torch.Tensor,
                    d_hidden: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward's recurrence kernel of ``cell`` on checked inputs (see
    :func:`train_bwd`): the gate cotangents, ``(da [2B, T, 4u],)`` for
    LSTM, ``(d_rp, d_xp)`` ``[2B, T, 3u]`` each for GRU."""
    batch, steps = codes.shape
    units = params["recurrent"].shape[0]
    gates = 4 if cell == "lstm" else 3
    outs = tuple(_empty(codes.device, 2 * batch, steps, gates * units)
                 for _ in range(1 if cell == "lstm" else 2))
    lib = _build.load_kernels("rnn_train")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = getattr(lib, f"dg_{cell}_bwd_recurrence")(
            codes.data_ptr(), batch, steps, _ptr(masks),
            params["kernel"].data_ptr(), params["bias"].data_ptr(),
            params["recurrent"].data_ptr(), units,
            *(seq.data_ptr() for seq in seqs), d_avg.data_ptr(),
            d_hidden.data_ptr(), *(out.data_ptr() for out in outs),
            ctypes.c_void_p(stream))
    _raise_on(lib, err, f"{cell}_train_bwd (recurrence)",
              f"B={batch} T={steps} u={units}")
    return outs


#: Tile of the reduction kernel (left rows and columns).
REDUCE_TILE = 64


def reduce_splits(rows: int, units: int, gates: int, sms: int) -> int:
    """Splits over the ``rows`` = 2B*T rows of the reduction kernel: about
    four CTAs an SM over the output tiles, and at least 256 rows a split.
    A function of the shape and the SM count only, so two runs sum in the
    same order."""
    tiles = -(-gates * units // REDUCE_TILE) * -(-units // REDUCE_TILE)
    return max(1, min(-(-4 * sms // tiles), -(-rows // 256)))


def _train_reduce(hseq: torch.Tensor, codes: torch.Tensor,
                  masks: Optional[torch.Tensor], gates: int, grads: list,
                  r1: torch.Tensor, r2: Optional[torch.Tensor] = None
                  ) -> None:
    """The reduction kernel: ``dW, dU, db`` from ``hseq`` and the gate
    cotangents, written into ``grads`` (``[d_kernel, d_recurrent,
    d_bias]``).  LSTM passes ``r1 = da``; GRU ``r1 = d_rp`` (``dU`` and the
    recurrent bias row) and ``r2 = d_xp`` (``dW`` and the input bias
    row)."""
    batch, steps = codes.shape
    units = hseq.shape[2]
    sms = torch.cuda.get_device_properties(
        codes.device).multi_processor_count
    splits = reduce_splits(2 * batch * steps, units, gates, sms)
    parts = _empty(codes.device, splits, units + 7, gates * units)
    d_bias = grads[2]
    bias_1, bias_2 = ((d_bias, None) if r2 is None
                      else (d_bias[1], d_bias[0]))
    lib = _build.load_kernels("rnn_train")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.dg_train_reduce(
            hseq.data_ptr(), r1.data_ptr(), _ptr(r2), codes.data_ptr(),
            _ptr(masks), batch, steps, units, gates, splits,
            parts.data_ptr(), grads[0].data_ptr(), bias_1.data_ptr(),
            _ptr(bias_2), grads[1].data_ptr(), ctypes.c_void_p(stream))
    cell = "lstm" if gates == 4 else "gru"
    _raise_on(lib, err, f"{cell}_train_bwd (reduction)",
              f"B={batch} T={steps} u={units} splits={splits}")


#: The window kernels of each cell's training path, ``(kind, index that
#: dg_window_ctas_per_sm takes)``.
_WINDOW_KERNELS = {"lstm": (("fwd", 0), ("bwd", 1)),
                   "gru": (("fwd", 3), ("bwd", 2))}


def train_tile(cell: str, batch: int, units: int, steps: int,
               device: Optional[torch.device] = None) -> Dict[str, int]:
    """The window tile of ``cell``'s training kernels (the forward and the
    backward's recurrence) on a CUDA device: threads a CTA (four per
    unit), CTAs (one a window), resident CTAs an SM of each kernel, and the
    warps an SM that gives at this batch."""
    lib = _build.load_kernels("rnn_train")
    device = device or torch.device("cuda")
    threads = 4 * units
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tile = {"threads": threads, "ctas": batch}
    with torch.cuda.device(device):
        for kind, which in _WINDOW_KERNELS[cell]:
            per_sm = lib.dg_window_ctas_per_sm(which, units, steps)
            tile[f"{kind}_ctas_per_sm"] = per_sm
            tile[f"{kind}_warps_per_sm"] = (min(per_sm, -(-batch // sms))
                                            * -(-threads // 32))
    return tile


_PLAIN: Dict[str, Tuple[Callable, Callable]] = {
    "gru": (rnn.gru_avg_train_fwd_plain, rnn.gru_avg_train_bwd_plain),
    "lstm": (rnn.lstm_avg_train_fwd_plain, rnn.lstm_avg_train_bwd_plain),
}


class _AvgTrain(torch.autograd.Function):
    """Shared body of :class:`GruAvgTrain` and :class:`LstmAvgTrain`."""

    CELL = ""

    @classmethod
    def forward(cls, ctx, kernel, recurrent, bias, codes, masks):
        params = {"kernel": kernel, "recurrent": recurrent, "bias": bias}
        if codes.device.type == "cpu":
            avg, hidden, *seqs = _PLAIN[cls.CELL][0](params, codes, masks)
        else:
            avg, hidden, *seqs = train_fwd(cls.CELL, params, codes, masks)
        ctx.save_for_backward(kernel, recurrent, bias, codes, masks, *seqs)
        return avg, hidden

    @classmethod
    def backward(cls, ctx, d_avg, d_hidden):
        kernel, recurrent, bias, codes, masks, *seqs = ctx.saved_tensors
        params = {"kernel": kernel, "recurrent": recurrent, "bias": bias}
        if codes.device.type == "cpu":
            grads = _PLAIN[cls.CELL][1](params, codes, masks, *seqs, d_avg,
                                        d_hidden)
        else:
            grads = train_bwd(cls.CELL, params, codes, masks, tuple(seqs),
                              d_avg, d_hidden)
        return (*grads, None, None)


class GruAvgTrain(_AvgTrain):
    """Trainable fused fwd+revcomp GRU with branch averaging.

    ``GruAvgTrain.apply(kernel [5, 3u], recurrent [u, 3u], bias [2, 3u],
    codes int8 [B, T], masks [3, 2B, 5] | None)`` returns ``(avg [B, T,
    u], hidden [B, u])``; the backward gives the three parameters'
    gradients.
    """

    CELL = "gru"


class LstmAvgTrain(_AvgTrain):
    """LSTM counterpart of :class:`GruAvgTrain` (``bias [4u]``, ``masks
    [4, 2B, 5]``); saves the hidden and cell sequences."""

    CELL = "lstm"


def avg_train(cell: str, params: RnnParams, codes: torch.Tensor,
              masks: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(avg, hidden)`` of the trainable fused recurrence of ``cell``."""
    fn = LstmAvgTrain if cell == "lstm" else GruAvgTrain
    return fn.apply(params["kernel"], params["recurrent"], params["bias"],
                    codes, masks)
