"""Wrappers of the fused recurrence kernels (``csrc/rnn_avg.cu``).

Counterpart of ``deepgrp_tpu/models/pallas_rnn.py`` (``pallas_gru_avg``,
``pallas_lstm_avg``), with the same contract: ``codes [B, T]`` in,
``(avg [B, T, u], hidden_avg [B, u])`` float32 out.

For a tensor on the CPU a wrapper runs the plain version
(:mod:`deepgrp_tpu_torch.models.rnn`); for a CUDA tensor it launches the
kernel on the current stream or raises.  ``LAUNCHES`` counts the kernel
launches by name.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from deepgrp_tpu_torch import _build
from deepgrp_tpu_torch.models import rnn
from deepgrp_tpu_torch.models.rnn import RnnParams

#: Kernel launches by name ("gru_avg", "lstm_avg").
LAUNCHES = _build.LaunchCounter()


def gru_avg(params: RnnParams,
            codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fwd+revcomp GRU with branch averaging (inference).

    ``params``: ``kernel [5, 3u]``, ``recurrent [u, 3u]``, ``bias [2, 3u]``
    float32; ``codes``: int8 ``[B, T]`` (A=0..T=3, N=4, pad=5).
    """
    if codes.device.type == "cpu":
        return rnn.gru_avg_plain(params, codes)
    return _launch("gru_avg", 3, params, codes)


def lstm_avg(params: RnnParams,
             codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM counterpart of :func:`gru_avg` (``bias [4u]``)."""
    if codes.device.type == "cpu":
        return rnn.lstm_avg_plain(params, codes)
    return _launch("lstm_avg", 4, params, codes)


def _launch(name: str, gates: int, params: RnnParams,
            codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
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
        tensor = params[key]
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name}: {key} has shape "
                             f"{tuple(tensor.shape)}, expected {shape}")
        if (tensor.dtype != torch.float32 or tensor.device != codes.device
                or not tensor.is_contiguous()):
            raise ValueError(f"{name}: {key} must be contiguous float32 on "
                             f"{codes.device}")
    avg = torch.empty(batch, steps, units, device=codes.device,
                      dtype=torch.float32)
    hidden = torch.empty(batch, units, device=codes.device,
                         dtype=torch.float32)
    if batch == 0:
        return avg, hidden
    lib = _build.load_kernels()
    fn: Callable[..., int] = getattr(lib, f"dg_{name}")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = fn(codes.data_ptr(), batch, steps,
                 params["kernel"].data_ptr(), params["bias"].data_ptr(),
                 params["recurrent"].data_ptr(), units, avg.data_ptr(),
                 hidden.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.dg_rnn_avg_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg}) at B={batch} T={steps} u={units}")
    LAUNCHES.add(name)
    return avg, hidden
