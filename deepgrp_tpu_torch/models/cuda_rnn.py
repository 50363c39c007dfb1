"""Wrappers of the recurrence kernels (``csrc/rnn_avg.cu``,
``csrc/rnn_train.cu``, ``csrc/rnn_seq.cu``, ``csrc/rnn_grid.cu``).

Inference: counterpart of ``deepgrp_tpu/models/pallas_rnn.py``
(``pallas_gru_avg``, ``pallas_lstm_avg``), with the same contract:
``codes [B, T]`` in, ``(avg [B, T, u], hidden_avg [B, u])`` out in
``out_dtype`` (float32, or bfloat16 for the fast mode, whose kernels run
the recurrent dot on the tensor cores at every width), at every width:
one CTA a window up to u=128, past it a window's units split over a
thread-block cluster of CTAs up to :data:`CLUSTER_MAX_UNITS` (u=1024; in
bfloat16 :data:`BF16_CLUSTER_MAX_UNITS`, u=1279; in float32 from
:data:`STATIONARY_MIN_UNITS`, u=384, the stationary tile: one cooperative
grid whose CTAs each keep some units' slice of ``U`` in shared memory
for the whole launch and serve every window, ``h`` handed over in device
memory, a grid barrier a step), and past it the grid
tile (``csrc/rnn_grid.cu``: one tiled product of every row's ``h`` with
``U`` a step, FMAs in float32 and ``mma.sync`` in bfloat16, the gate
math in its epilogue).  :func:`avg_layout` names
the tile, the CTAs a cluster and where ``U`` sits
(:func:`stationary_layout` the stationary tile's launch); only u <= 0 is
refused.  :func:`gru_apply` is the counterpart of ``pallas_gru_apply``:
the GRU over a float input ``x [B, T, C]``, ``(seq, last)`` out in
``x``'s dtype, at every width (the grid tile past
:data:`CLUSTER_MAX_UNITS`, with bfloat16 IO past
:data:`SEQ_BF16_CLUSTER_MAX_UNITS`).

Training: :class:`GruAvgTrain` and :class:`LstmAvgTrain`, the
``torch.autograd.Function`` counterparts of the custom VJPs
``pallas_gru_avg_train`` / ``pallas_lstm_avg_train``
(``deepgrp_tpu/models/pallas_rnn_train.py``).  Their forward runs the
training forward kernel (per-gate input dropout masks, hidden and cell
sequences kept for the backward); their backward runs the recurrence
kernel, which recomputes the gates and writes the gate cotangents, and the
reduction kernel, which sums them into the gradients of the three
parameters (none for the codes and masks).  The training kernels take
every width, as the inference kernels do: one CTA a window up to u=128,
past it a window's units split over a thread-block cluster up to
:data:`TRAIN_CLUSTER_MAX_UNITS` (u=511), and past it the grid tile
(``csrc/rnn_grid.cu``: the forward one tiled product of every row's
``h`` with ``U`` a step; the backward one product of every ``(row,
t)``'s ``h_prev`` with ``U`` that recomputes the gates, then one product
a step, in reverse time, of the gate cotangents with ``U^T``); the
reduction kernel serves every layout. :func:`train_layout` names the
layout of a width, :func:`train_tile` what the card launches; only u <= 0
is refused.

For a tensor on the CPU a wrapper runs the plain version
(:mod:`deepgrp_tpu_torch.models.rnn`); for a CUDA tensor it launches the
kernel on the current stream or raises.  ``LAUNCHES`` counts the kernel
launches by name: ``gru_avg``, ``lstm_avg``, ``gru_avg_bf16``,
``lstm_avg_bf16``, ``gru_seq`` (either dtype), ``gru_train_fwd``,
``gru_train_bwd``, ``lstm_train_fwd``, ``lstm_train_bwd`` (a backward
counts once, for either cell: it is the recurrence kernel, the reduction
kernel and the sum of the reduction's partials).  A launch of the
stationary tile counts under its row's name and as ``gru_avg_stationary``
or ``lstm_avg_stationary``.  A call of the grid tile
(its step launches) counts once under its row's name and once under
the grid's: ``gru_avg_grid``, ``lstm_avg_grid``, ``gru_avg_grid_bf16``,
``lstm_avg_grid_bf16``, ``gru_seq_grid`` (either dtype),
``gru_train_fwd_grid``, ``gru_train_bwd_grid``, ``lstm_train_fwd_grid``,
``lstm_train_bwd_grid``.
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
            out_dtype: torch.dtype = torch.float32, grid: bool = False,
            stationary: bool = False, variant: int = -1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches ``name``'s kernel on the tile of :func:`avg_tile_name`
    (``grid``: on the grid tile at any width, ``stationary``: on the
    float32 stationary tile at any width it takes, in its ``variant``
    (-1: the library's choice), to time them beside the other tiles)."""
    cell = name.split("_")[0]
    name += rnn.dtype_suffix(out_dtype)
    batch, steps, units = _check(name, gates, params, codes)
    _check_width(units)
    avg = _empty(codes.device, batch, steps, units, dtype=out_dtype)
    hidden = _empty(codes.device, batch, units, dtype=out_dtype)
    if batch == 0:
        return avg, hidden
    if not grid and (stationary or _stationary_route(units, out_dtype)):
        if out_dtype != torch.float32:
            raise ValueError(f"{name}: the stationary tile is float32 only")
        lib = _build.load_kernels("rnn_avg")
        with torch.cuda.device(codes.device):
            layout = stationary_layout(cell, batch, units, variant)
            scratch = torch.zeros(layout["scratch"], dtype=torch.uint8,
                                  device=codes.device)
            stream = torch.cuda.current_stream(codes.device).cuda_stream
            err = lib.dg_avg_stationary(
                gates, variant, codes.data_ptr(), batch, steps,
                params["kernel"].data_ptr(), params["bias"].data_ptr(),
                params["recurrent"].data_ptr(), units, scratch.data_ptr(),
                avg.data_ptr(), hidden.data_ptr(), ctypes.c_void_p(stream))
        _raise_on(lib, err, f"{name} (stationary)",
                  f"B={batch} T={steps} u={units}")
        LAUNCHES.add(name)
        LAUNCHES.add(name.replace("_avg", "_avg_stationary"))
        return avg, hidden
    if grid or _grid_route(units, "avg", out_dtype):
        lib = _build.load_kernels("rnn_grid")
        with torch.cuda.device(codes.device):
            recurrent, h, carry = _grid_buffers(
                lib, 2 * batch, units, gates, params["recurrent"], out_dtype)
            stream = torch.cuda.current_stream(codes.device).cuda_stream
            err = lib.dg_avg_grid(
                gates, int(out_dtype == torch.bfloat16), codes.data_ptr(),
                batch, steps, params["kernel"].data_ptr(),
                params["bias"].data_ptr(), recurrent.data_ptr(), units,
                h[0].data_ptr(), h[1].data_ptr(), carry.data_ptr(),
                avg.data_ptr(), hidden.data_ptr(), ctypes.c_void_p(stream))
        _raise_on(lib, err, f"{name} (grid)",
                  f"B={batch} T={steps} u={units}")
        LAUNCHES.add(name)
        LAUNCHES.add(name.replace("_avg", "_avg_grid"))
        return avg, hidden
    lib = _build.load_kernels("rnn_avg")
    fn: Callable[..., int] = getattr(lib, f"dg_{name}")
    windows = avg_tile(cell, batch, units, codes.device, out_dtype)[0]
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


#: The widest layer the float32 fused rows (1, 2) and the GRU sequence
#: kernel (row 7, float32 IO) run on their cluster tiles
#: (``csrc/rnn_avg.cu``, ``csrc/rnn_seq.cu``: a window's units over 16
#: CTAs of 64 units, one unit a lane); past it the grid tile
#: (``csrc/rnn_grid.cu``).  From ``tools/avg_tile_sweep.py --grid`` on an
#: NVIDIA H100 80GB HBM3 at 700 W (ms cluster / grid): u=1024, B=5, T=23
#: rows 1 / 2 0.594 / 0.816, 1.071 / 1.102, and row 7 at 16 rows, T=342
#: 8.321 / 13.075 (bf16 IO 9.388 / 13.263), so the cluster tiles keep
#: u=1024; at u=1025 and every swept width above, every batch (B=16, 64,
#: 256 at T=342; B=37, T=150; B=5, T=23; row 7 at 16, 64, 2048 rows) runs
#: the grid within 0.87x the cluster tile's time.
CLUSTER_MAX_UNITS = 1024
#: The narrowest layer the float32 fused rows (1, 2) run on the
#: stationary tile (``AvgStationaryKernel`` of ``csrc/rnn_avg.cu``: each
#: CTA keeps its units' slice of ``U`` in shared memory for the whole
#: launch), up to :data:`CLUSTER_MAX_UNITS`; below it the cluster tile.
#: From ``tools/avg_tile_sweep.py --stationary`` on an NVIDIA H100 80GB
#: HBM3 at 700 W (B=16, 64, 256 at T=342; B=37, T=150; B=5, T=23; both
#: cells; the stationary tile's largest ratio to the cluster tile's time
#: over them): u=257 1.57, u=300 1.28, u=320 1.31, u=352 1.05 (each at
#: B=256), u=384 0.97, u=512 0.83, u=768 0.91, u=1024 0.71; at u=129-256
#: 1.8-3.2; past u=1024 it took up to 1.34x (u=1025) and 2.31x (u=1280)
#: the grid tile's time.
STATIONARY_MIN_UNITS = 384
#: The widest layer the bfloat16 fused rows (1b, 2b) run on their cluster
#: tile (``MmaAvgKernel``, past u=1024 ``MmaWideKernel`` of
#: ``csrc/rnn_avg.cu``); past it the grid tile's bf16 step (``mma.sync``
#: too).  From ``tools/avg_tile_sweep.py --grid`` on an NVIDIA H100 80GB
#: HBM3 at 700 W (ms cluster / grid): at u=1024 and 1025 the LSTM at
#: B=16, T=342 runs the grid 1.044x / 1.062x (8.751 / 9.134, 8.786 /
#: 9.329), the GRU within 0.999x at every batch; from u=1280 (then 1536,
#: 2048) every batch (B=16, 64, 256 at T=342; B=37, T=150; B=5, T=23)
#: runs the grid within 0.824x (the worst: GRU B=16, u=1280, 10.003 /
#: 8.243).
BF16_CLUSTER_MAX_UNITS = 1279
#: The widest layer the GRU sequence kernel (row 7) runs on its cluster
#: tile with bfloat16 IO (``SeqKernel<..., kBf16>`` of
#: ``csrc/rnn_seq.cu``); past it the grid tile's bf16 step.  The same
#: sweep (16, 64, 2048 rows at T=342, ms cluster / grid): u=257 1.470 /
#: 4.118 at 16 rows, u=512 1.483 / 5.010 at 16 rows and 4.649 / 6.631 at
#: 64; from u=768 (then 1024) every row count runs the grid within 0.927x
#: (16 rows at u=768, 6.684 / 6.193).  Float32 IO keeps
#: :data:`CLUSTER_MAX_UNITS`.
SEQ_BF16_CLUSTER_MAX_UNITS = 767
#: The widest layer the training kernels (rows 3-6) run on their cluster
#: tile (``csrc/rnn_train.cu``, one unit a lane, from u=129); from u=512
#: the grid tile.  ``tools/train_tile_sweep.py --routes`` (u=129-1023,
#: B=256, 64 at T=342, B=37 at T=150, B=5 at T=23, both cells, in turns;
#: the largest ratio of a tile's forward + backward to the fastest
#: tile's, cluster / grid): u=129 1.08 / 3.05, u=256 1.25 / 2.02, u=300
#: 1.34 / 1.77, u=384 1.62 / 1.71, u=512 1.69 / 1.60, u=768 1.97 / 1.24,
#: u=1023 2.11 / 1.07.  No tile came within 1.02x at every batch (the
#: grid wins at B >= 64, the cluster tile at B <= 37, up to different
#: widths), so each width takes the tile with the least largest ratio.
#: The library's cluster tile takes u <= 1024.
TRAIN_CLUSTER_MAX_UNITS = 511
#: Where a kernel keeps ``U``, by the library's code.
U_IN = {0: "L1/L2", 1: "registers", 2: "shared"}
#: Where the grid tile keeps ``U``: tiles of it copied from L2 (or HBM)
#: into shared memory each step.
GRID_U_IN = "L2"
#: The grid tile's rows and units a CTA (``kBlockRows``, ``kBlockUnits``
#: of ``csrc/rnn_grid.cu``; the fused rows' 32 rows are 16 windows).
GRID_ROWS = GRID_UNITS = 32
#: The rows a CTA of the grid tile's bf16 step (``kMmaRows``: 8 m16 tiles,
#: the fused rows' 64 windows); its units a CTA are :func:`grid_mma_units`.
GRID_MMA_ROWS = 128


def _check_width(units: int) -> None:
    if units <= 0:
        raise ValueError(f"the inference kernels take widths u >= 1, not "
                         f"u={units}")


def _grid_route(units: int, row: str = "seq",
                out_dtype: torch.dtype = torch.float32) -> bool:
    """Whether a recurrence runs the grid tile at this width: the fused
    inference rows (``row="avg"``) past :data:`CLUSTER_MAX_UNITS`, or in
    bfloat16 past :data:`BF16_CLUSTER_MAX_UNITS`; the GRU sequence kernel
    (``"seq"``) past :data:`CLUSTER_MAX_UNITS`, or with bfloat16 IO past
    :data:`SEQ_BF16_CLUSTER_MAX_UNITS`; the training kernels
    (``"train"``) past :data:`TRAIN_CLUSTER_MAX_UNITS`.  Every layout
    helper and launch asks this."""
    if row == "train":
        return units > TRAIN_CLUSTER_MAX_UNITS
    if rnn.dtype_suffix(out_dtype):
        return units > (BF16_CLUSTER_MAX_UNITS if row == "avg"
                        else SEQ_BF16_CLUSTER_MAX_UNITS)
    return units > CLUSTER_MAX_UNITS


def _stationary_route(units: int,
                      out_dtype: torch.dtype = torch.float32) -> bool:
    """Whether the float32 fused inference rows (1, 2) run the stationary
    tile at this width: from :data:`STATIONARY_MIN_UNITS` up to
    :data:`CLUSTER_MAX_UNITS`, in float32 only.  Every layout helper and
    launch asks this."""
    return (not rnn.dtype_suffix(out_dtype)
            and STATIONARY_MIN_UNITS <= units <= CLUSTER_MAX_UNITS)


#: The fields of ``dg_avg_stationary_layout``'s ``out``, in order.
STATIONARY_FIELDS = ("ctas", "units_a_cta", "threads", "windows_a_block",
                     "blocks", "stages", "smem", "windows_a_group",
                     "units_a_lane", "width", "variant")


def stationary_layout(cell: str, batch: int, units: int,
                      variant: int = -1) -> Dict[str, int]:
    """The float32 stationary tile's launch for ``batch`` windows at this
    width on the current CUDA device, from the library: its CTAs (one
    cooperative grid, every CTA resident), the units a CTA owns (with
    their slice of ``U`` in its shared memory), threads a CTA, the
    windows of a row block (each CTA takes every window of the batch, a
    row block at a time) and the row blocks, the stages of ``h``'s ring,
    the shared bytes, the windows a lane group, the units a lane, the
    padded width, the variant (``variant`` -1: the library's choice by
    batch, else the first other variant that fits where it does not;
    every variant gives the same bits) and ``scratch``, the zeroed bytes
    the launch takes (barrier count, two ``h`` buffers, the LSTM's
    carry).  Raises ``ValueError`` for a shape the tile refuses (or
    whose grid the card cannot hold at once)."""
    _check_width(units)
    out = (ctypes.c_int * len(STATIONARY_FIELDS))()
    scratch = _build.load_kernels("rnn_avg").dg_avg_stationary_layout(
        4 if cell == "lstm" else 3, units, max(batch, 1), variant, out)
    if scratch == 0:
        raise ValueError(f"{cell}_avg's stationary tile refuses u={units} "
                         f"at B={batch} (variant {variant})")
    return {**dict(zip(STATIONARY_FIELDS, out)), "scratch": scratch}


def grid_mma_units(rows: int, units: int, sms: int) -> int:
    """Units a CTA of the grid tile's bf16 step for ``rows`` rows at this
    width on ``sms`` SMs (pure Python, ``MmaUnits`` of
    ``csrc/rnn_grid.cu``): 32, unless that grid would have fewer CTAs
    than the SMs, then 16."""
    ctas = -(-rows // GRID_MMA_ROWS) * -(-units // GRID_UNITS)
    return 32 if ctas >= sms else 16


def grid_tile(rows: int, units: int,
              out_dtype: torch.dtype = torch.float32,
              sms: Optional[int] = None) -> Tuple[int, int]:
    """``(rows a CTA, CTAs a step)`` of the grid tile for ``rows`` rows
    (the fused rows' doubled batch, or the GRU sequence kernel's rows) at
    this width (pure Python): in float32 a CTA owns :data:`GRID_ROWS`
    rows and :data:`GRID_UNITS` units with all their gates; in bfloat16
    (the tensor-core step) :data:`GRID_MMA_ROWS` rows and
    :func:`grid_mma_units` units on ``sms`` SMs (by default the current
    CUDA device's); the grid covers every row and unit.  Raises
    ``ValueError`` for u <= 0."""
    _check_width(units)
    if out_dtype == torch.bfloat16:
        if sms is None:
            sms = torch.cuda.get_device_properties(
                torch.cuda.current_device()).multi_processor_count
        width = -(-units // GRID_UNITS) * GRID_UNITS
        return (min(GRID_MMA_ROWS, max(rows, 1)),
                -(-rows // GRID_MMA_ROWS)
                * (width // grid_mma_units(rows, units, sms)))
    return (min(GRID_ROWS, max(rows, 1)),
            -(-rows // GRID_ROWS) * -(-units // GRID_UNITS))


#: The most blocks of :data:`GRID_UNITS` units a CTA of the training
#: backward's (B) step owns (``kBwdMaxGroups`` of ``csrc/rnn_grid.cu``).
GRID_BWD_MAX_GROUPS = 4


#: The time a block of :data:`GRID_UNITS` units takes in a CTA of (B)
#: that owns 1-4 of them (20 = the time at 3 or 4), fitted to
#: ``tools/train_tile_sweep.py --ablate`` (every count forced; H100, ms of
#: (B)): GRU B=64, u=4608 1-4 blocks 257.47 / 257.08 / 213.23 / 285.12,
#: GRU B=256, u=1024 51.93 / 44.02 / 56.02 / 47.23, LSTM B=16, u=4096
#: 77.50 / 118.49 / 153.09 / 190.83; the estimate orders the fastest
#: first at all three.
GRID_BWD_BLOCK_COST = (0, 29, 24, 20, 20)


def grid_bwd_groups(rows: int, units: int, sms: int) -> int:
    """Blocks of :data:`GRID_UNITS` units a CTA of the grid tile's
    training backward step (B) owns for ``rows`` rows (the doubled batch)
    at this width on ``sms`` SMs (pure Python; the count
    :func:`_bwd_recurrence` gives ``dg_*_bwd_grid``): the count, up to
    :data:`GRID_BWD_MAX_GROUPS`, with the least estimated step time (the
    CTAs of the busiest SM times the blocks a CTA times
    :data:`GRID_BWD_BLOCK_COST`, 1.3x where no SM runs two CTAs), the
    fewer at a tie.  The blocks change which CTA owns a sum, not its
    order, so a window's bits do not depend on them.  Raises
    ``ValueError`` for u <= 0."""
    _check_width(units)
    row_blocks, blocks = -(-rows // GRID_ROWS), -(-units // GRID_UNITS)
    costs = []
    for groups in range(1, GRID_BWD_MAX_GROUPS + 1):
        ctas = row_blocks * -(-blocks // groups)
        costs.append(-(-ctas // sms) * groups * GRID_BWD_BLOCK_COST[groups]
                     * (13 if ctas <= sms else 10))
    return 1 + costs.index(min(costs))


def grid_bwd_tile(rows: int, units: int,
                  sms: Optional[int] = None) -> Tuple[int, int, int]:
    """``(rows a CTA, units a CTA, CTAs a step)`` of the grid tile's
    training backward step (B) for ``rows`` rows at this width on ``sms``
    SMs (by default the current CUDA device's; pure Python otherwise):
    :data:`GRID_ROWS` rows and :func:`grid_bwd_groups` blocks of
    :data:`GRID_UNITS` units a CTA."""
    if sms is None:
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    groups = grid_bwd_groups(rows, units, sms)
    blocks = -(-units // GRID_UNITS)
    return (GRID_ROWS, groups * GRID_UNITS,
            -(-rows // GRID_ROWS) * -(-blocks // groups))


def _grid_buffers(lib: ctypes.CDLL, rows: int, units: int, gates: int,
                  recurrent: torch.Tensor, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grid tile's operands beside the parameters, zeroed, on
    ``recurrent``'s device: ``U`` padded to ``[W, gates, W]`` in ``dtype``
    (bfloat16: rounded to nearest even, the dot's operand), the two h
    buffers in ``dtype`` and the float32 carry (float32 ``[2, W, R']``
    each, k-major; bfloat16 ``[2, R', W]``, row-major, as the tensor-core
    step's A operand; W and R' from the library's ``dg_grid_shape``)."""
    shape = (ctypes.c_longlong * 4)()
    if not lib.dg_grid_shape(rows, units, shape):
        raise ValueError(f"the grid tile refuses {rows} rows at u={units}")
    width, rows_p = shape[0], shape[1]
    device = recurrent.device
    padded = torch.zeros(width, gates, width, dtype=dtype, device=device)
    padded[:units, :, :units] = recurrent.view(units, gates, units)
    dims = ((2, rows_p, width) if dtype == torch.bfloat16
            else (2, width, rows_p))
    h = torch.zeros(*dims, dtype=dtype, device=device)
    carry = torch.zeros(*dims, device=device)
    return padded, h, carry


def _grid_transposed(recurrent: torch.Tensor, gates: int,
                     width: int) -> torch.Tensor:
    """``U^T`` zero-padded to ``[gates, W, W]`` (entry ``[g, i, k] =
    U[k, g u + i]``), the training backward's operand beside
    :func:`_grid_buffers`' padded ``U``, made on the current stream."""
    units = recurrent.shape[0]
    padded = torch.zeros(gates, width, width, device=recurrent.device)
    padded[:, :units, :units] = recurrent.view(units, gates,
                                               units).permute(1, 2, 0)
    return padded


def _grid_layout(out_dtype: torch.dtype = torch.float32, rows: int = 1,
                 units: int = GRID_UNITS) -> list:
    """The grid tile's layout from the library for ``rows`` rows at this
    width in ``out_dtype`` on the current device: rows a CTA, units a
    CTA, k a stage, k-slices, threads a CTA, stages, then rows and units
    a thread (float32) or a warp (bfloat16, the tensor-core step)."""
    out = (ctypes.c_int * 8)()
    if not _build.load_kernels("rnn_grid").dg_grid_layout(
            int(out_dtype == torch.bfloat16), rows, units, out):
        raise ValueError(f"the grid tile refuses {rows} rows at u={units}")
    return list(out)


def avg_tile_name(cell: str, units: int,
                  out_dtype: torch.dtype = torch.float32) -> str:
    """The tile of ``cell``'s ("gru" or "lstm") inference kernels at this
    width in ``out_dtype`` (pure Python): in float32 ``"registers"`` (the
    register tile, one CTA a window, ``U``'s slice in registers, u <= 64),
    ``"l2"`` (the same reading it through L1/L2, u <= 128), in bfloat16
    ``"mma"`` (the tensor-core tile, one CTA a window, u <= 128); past
    u=128 ``"cluster"`` in either (a window's units over a thread-block
    cluster of CTAs) up to :data:`CLUSTER_MAX_UNITS` (in bfloat16
    :data:`BF16_CLUSTER_MAX_UNITS`), in float32 from
    :data:`STATIONARY_MIN_UNITS` ``"stationary"`` (the stationary tile,
    :func:`stationary_layout`), and past it ``"grid"`` (the grid tile).
    Raises ``ValueError`` for u <= 0."""
    _check_width(units)
    if _grid_route(units, "avg", out_dtype):
        return "grid"
    if _stationary_route(units, out_dtype):
        return "stationary"
    if units > 128:
        return "cluster"
    if rnn.dtype_suffix(out_dtype):
        return "mma"
    return "registers" if units <= 64 else "l2"


def avg_layout(cell: str, units: int,
               out_dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """The layout that ``cell``'s inference kernels launch at this width in
    ``out_dtype`` on the current device: ``tile`` (:func:`avg_tile_name`),
    and from the library, which asks the card, ``cluster`` (CTAs a
    cluster; 1: one CTA a window, or the grid tile), ``u_in`` (where ``U``
    sits: ``"registers"``, ``"shared"``, each CTA's share in shared
    memory, ``"L1/L2"``, read each step, or on the grid tile ``"L2"``,
    tiles of it copied into shared memory each step) and ``max_windows``
    (the most windows a CTA, of a cluster: the cluster's, owns; None on
    the stationary tile, whose every CTA serves every window).  Raises
    ``ValueError`` for u <= 0 before it asks."""
    tile = avg_tile_name(cell, units, out_dtype)
    most, cluster, u_in = _library_layout(cell, units, out_dtype)
    return {"tile": tile, "cluster": cluster, "u_in": u_in,
            "max_windows": most}


def _library_layout(cell: str, units: int,
                    out_dtype: torch.dtype) -> Tuple[int, int, str]:
    """``(most windows a CTA, CTAs a cluster, where U sits)`` from the
    library, which asks the current device (on the grid route the grid
    tile's library); ``ValueError`` for a width it refuses."""
    if _grid_route(units, "avg", out_dtype):
        return _grid_layout(out_dtype, 2, units)[0] // 2, 1, GRID_U_IN
    if _stationary_route(units, out_dtype):
        stationary_layout(cell, 1, units)  # raises where it is refused
        return None, 1, U_IN[2]
    gates = 4 if cell == "lstm" else 3
    out = (ctypes.c_int * 2)()
    most = _build.load_kernels("rnn_avg").dg_avg_layout(
        gates, units, int(bool(rnn.dtype_suffix(out_dtype))), out)
    if most == 0:
        raise ValueError(f"{cell}_avg{rnn.dtype_suffix(out_dtype)} refuses "
                         f"u={units}")
    return most, out[0], U_IN[out[1]]


def avg_tile(cell: str, batch: int, units: int,
             device: Optional[torch.device] = None,
             out_dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """``(windows a CTA owns, CTAs)`` of the inference kernels of ``cell``
    ("gru" or "lstm") for a batch on a CUDA device: :func:`block_windows`
    with the kernel's cap at this width (``max_windows`` of
    :func:`avg_layout`) over the CTAs that run at once:
    the card's SMs, or past u=128 the clusters (of :func:`avg_cluster`
    CTAs, each of which holds its cluster's windows) that the card places
    at once (a cluster of 16 CTAs needs 16 free SMs of one GPC); on the
    stationary tile every window and its layout's CTAs; on the
    grid route the grid tile's windows a CTA and CTAs a step
    (:func:`grid_tile`).  Raises ``ValueError`` for a width the kernels
    refuse."""
    device = device or torch.device("cuda")
    if _grid_route(units, "avg", out_dtype):
        rows_a_cta, ctas = grid_tile(
            2 * batch, units, out_dtype,
            torch.cuda.get_device_properties(device).multi_processor_count)
        return max(rows_a_cta // 2, 1), ctas
    if _stationary_route(units, out_dtype):
        with torch.cuda.device(device):
            return batch, stationary_layout(cell, batch, units)["ctas"]
    gates = 4 if cell == "lstm" else 3
    cap, cluster, _ = _library_layout(cell, units, out_dtype)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slots = sms
    if cluster > 1:
        with torch.cuda.device(device):
            slots = _build.load_kernels("rnn_avg").dg_avg_clusters(
                gates, units, cap, int(bool(rnn.dtype_suffix(out_dtype))))
        slots = slots or sms // cluster
    windows = block_windows(batch, slots, cap)
    return windows, -(-batch // windows) * cluster


def avg_cluster(cell: str, units: int,
                out_dtype: torch.dtype = torch.float32) -> int:
    """CTAs a cluster of ``cell``'s inference kernels in ``out_dtype`` at
    this width on the current device (1: one CTA a window); raises
    ``ValueError`` for a width they refuse."""
    return _library_layout(cell, units, out_dtype)[1]


#: The tiles of the bfloat16 inference kernels, by the library's code (2,
#: the float32-FMA register tile, served u=129-256 before the cluster
#: tile).
BF16_TILES = {1: "mma", 3: "cluster"}


def avg_bf16_tile(cell: str, units: int) -> str:
    """The tile the bfloat16 inference kernels of ``cell`` run at this
    width: ``"mma"`` (the tensor-core tile, ``mma.sync`` with bf16
    operands, one CTA a window, up to u=128), ``"cluster"`` (the same
    step with a window's units split over a cluster of CTAs, up to
    :data:`BF16_CLUSTER_MAX_UNITS`) or past it ``"grid"`` (the grid tile's
    bf16 step, ``mma.sync`` too); raises ``ValueError`` for a width they
    refuse."""
    if _grid_route(units, "avg", torch.bfloat16):
        return "grid"
    gates = 4 if cell == "lstm" else 3
    code = _build.load_kernels("rnn_avg").dg_avg_bf16_tile(gates, units)
    if code not in BF16_TILES:
        raise ValueError(f"{cell}_avg_bf16 refuses u={units}")
    return BF16_TILES[code]


def avg_bf16_cluster(cell: str, units: int) -> int:
    """CTAs a cluster of the bfloat16 inference kernels of ``cell`` at this
    width (:func:`avg_cluster` in bfloat16)."""
    return avg_cluster(cell, units, torch.bfloat16)


def seq_cluster(units: int, dtype: torch.dtype = torch.float32) -> int:
    """CTAs a cluster of the GRU sequence kernel at this width with
    ``dtype`` IO: 1 up to u=128, 8 up to u=256, 16 up to
    :data:`CLUSTER_MAX_UNITS` (``SeqCluster`` in ``csrc/rnn_seq.cu``), 1
    on the grid tile past it (with bfloat16 IO past
    :data:`SEQ_BF16_CLUSTER_MAX_UNITS`)."""
    if _grid_route(units, "seq", dtype):
        return 1
    return 1 if units <= 128 else 8 if units <= 256 else 16


def seq_max_rows(units: int, dtype: torch.dtype = torch.float32) -> int:
    """The most rows a CTA of the GRU sequence kernel owns at this width:
    16, but 4 from u=257 to 512, where each CTA keeps its slice of U in
    shared memory (``MaxRows`` in ``csrc/rnn_seq.cu``); the grid tile's
    :data:`GRID_ROWS` past :data:`CLUSTER_MAX_UNITS` (with bfloat16 IO
    :data:`GRID_MMA_ROWS` past :data:`SEQ_BF16_CLUSTER_MAX_UNITS`)."""
    if _grid_route(units, "seq", dtype):
        return GRID_MMA_ROWS if dtype == torch.bfloat16 else GRID_ROWS
    return 4 if 256 < units <= 512 else 16


def seq_tile(rows: int, units: int, sms: int,
             slots: Optional[int] = None,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """``(rows a CTA, CTAs)`` of the GRU sequence kernel for ``rows`` rows
    on ``sms`` SMs: :func:`block_windows` with the kernel's cap at this
    width (:func:`seq_max_rows`) over ``slots``, the CTAs (past u=128 the
    clusters of :func:`seq_cluster` CTAs, each of which holds its
    cluster's rows) that run at once: by default ``sms`` over the CTAs a
    cluster; the card's own count where it places fewer clusters (the
    library's ``dg_gru_seq_clusters``).  On the grid route (see
    :func:`seq_cluster`) the grid tile's in ``dtype`` (:func:`grid_tile`).
    Raises ``ValueError`` for u <= 0."""
    _check_width(units)
    if _grid_route(units, "seq", dtype):
        return grid_tile(rows, units, dtype, sms)
    cluster = seq_cluster(units, dtype)
    if slots is None:
        slots = sms // cluster
    rows_a_cta = block_windows(rows, slots, seq_max_rows(units, dtype))
    return rows_a_cta, -(-rows // rows_a_cta) * cluster


def seq_slots(units: int, steps: int, channels: int,
              dtype: torch.dtype) -> Optional[int]:
    """The clusters of the GRU sequence kernel's layout for this shape
    (at its cap of rows a CTA) that the current CUDA device runs at once
    (a 16-CTA cluster needs 16 free SMs of one GPC, so fewer than the SMs
    over 16 may fit); ``None`` without a cluster, or when the card cannot
    place one (the launch then raises)."""
    if seq_cluster(units, dtype) == 1:
        return None
    lib = _build.load_kernels("rnn_seq")
    slots = lib.dg_gru_seq_clusters(units, seq_max_rows(units, dtype), steps,
                                    channels, int(dtype == torch.bfloat16))
    return slots or None


#: Where the GRU sequence kernel's ``U`` sits, by the library's code.
SEQ_U_IN = {0: "L1/L2", 1: "registers", 2: "shared"}


def seq_layout(units: int, rows_a_cta: int,
               dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """The layout the GRU sequence kernel launches at this width and tile:
    rows a lane group, k-slices a unit, where ``U`` sits ("registers",
    "L1/L2" or "shared": each CTA's slice in shared memory) and the CTAs
    a cluster (1: one CTA a row); on the grid route (see
    :func:`seq_cluster`) the grid tile's in ``dtype``: rows a thread
    (bfloat16: a warp), its k-slices, ``U`` in ``"L2"``, no cluster, and
    its units a thread (a warp).  Raises ``ValueError`` for a shape the
    kernel refuses."""
    most = GRID_MMA_ROWS if dtype == torch.bfloat16 else GRID_ROWS
    if _grid_route(units, "seq", dtype) and 0 < rows_a_cta <= most:
        layout = _grid_layout(dtype, rows_a_cta, units)
        return {"rows_a_group": layout[6], "slices": layout[3],
                "u_in": GRID_U_IN, "cluster": 1,
                "units_a_thread": layout[7]}
    lib = _build.load_kernels("rnn_seq")
    out = (ctypes.c_int * 4)()
    if lib.dg_gru_seq_layout(units, rows_a_cta, out) == 0:
        raise ValueError(f"gru_seq refuses u={units} with {rows_a_cta} rows "
                         "a CTA")
    return {"rows_a_group": out[0], "slices": out[1],
            "u_in": SEQ_U_IN[out[2]], "cluster": out[3]}


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
    ``x``'s dtype.  Dropout raises ``ValueError``, as ``:135-138``.  Past
    :data:`CLUSTER_MAX_UNITS` (bfloat16: :data:`SEQ_BF16_CLUSTER_MAX_UNITS`)
    a CUDA tensor runs the grid tile.
    """
    if dropout_key is not None and (
            not isinstance(dropout_rate, (int, float)) or dropout_rate > 0.0):
        raise ValueError("the GRU sequence kernel is inference-only (no "
                         "dropout)")
    if x.device.type == "cpu":
        return rnn.gru_apply(params, x)
    return _launch_seq(params, x)


def _launch_seq(params: RnnParams, x: torch.Tensor, grid: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_apply` on a CUDA tensor (``grid``: on the grid tile at
    any width, to time it beside the cluster tiles)."""
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
    _check_width(units)
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
    bf16 = int(x.dtype == torch.bfloat16)
    if grid or _grid_route(units, "seq", x.dtype):
        lib = _build.load_kernels("rnn_grid")
        with torch.cuda.device(x.device):
            recurrent, h, carry = _grid_buffers(
                lib, batch, units, 3, weights["recurrent"], x.dtype)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.dg_seq_grid(
                bf16, x.data_ptr(), batch, steps, channels,
                weights["kernel"].data_ptr(), weights["bias"].data_ptr(),
                recurrent.data_ptr(), units, h[0].data_ptr(),
                h[1].data_ptr(), carry.data_ptr(), seq.data_ptr(),
                last.data_ptr(), ctypes.c_void_p(stream))
        _raise_on(lib, err, f"{name} (grid)", f"B={batch} T={steps} "
                  f"C={channels} u={units} {x.dtype}")
        LAUNCHES.add(name)
        LAUNCHES.add(f"{name}_grid")
        return seq, last
    lib = _build.load_kernels("rnn_seq")
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        rows_a_cta = seq_tile(batch, units, sms,
                              seq_slots(units, steps, channels, x.dtype))[0]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dg_gru_seq(
            x.data_ptr(), batch, steps, channels,
            weights["kernel"].data_ptr(), weights["bias"].data_ptr(),
            weights["recurrent"].data_ptr(), units, rows_a_cta, bf16,
            seq.data_ptr(), last.data_ptr(),
            ctypes.c_void_p(stream))
    _raise_on(lib, err, name, f"B={batch} T={steps} C={channels} u={units} "
              f"{x.dtype}")
    LAUNCHES.add(name)
    return seq, last


# -- training kernels --------------------------------------------------------


#: The widest layer of the training kernels' window tile (4u threads a
#: CTA, at most 512); past it the cluster tile.
TRAIN_WINDOW_UNITS = 128


def train_layout(units: int) -> str:
    """The training kernels' layout at a width (pure Python): the window
    tile's ``"registers"`` (U's slice in registers, u <= 64) or ``"l2"``
    (U through L1/L2, up to :data:`TRAIN_WINDOW_UNITS`), then
    ``"cluster"`` (a window's units over a thread-block cluster, one unit
    a lane, up to :data:`TRAIN_CLUSTER_MAX_UNITS`), past it ``"grid"``
    (the grid tile).  Raises ``ValueError`` for u <= 0."""
    if units <= 0:
        raise ValueError(f"the training kernels take widths u >= 1, not "
                         f"u={units}")
    if _grid_route(units, "train"):
        return "grid"
    if units > TRAIN_WINDOW_UNITS:
        return "cluster"
    return "registers" if units <= 64 else "l2"


def _check_masks(name: str, gates: int, masks: Optional[torch.Tensor],
                 batch: int, device: torch.device) -> None:
    if masks is not None:
        _check_f32(name, "masks", masks, (gates, 2 * batch, 5), device)


def train_fwd(cell: str, params: RnnParams, codes: torch.Tensor,
              masks: Optional[torch.Tensor], grid: bool = False
              ) -> Tuple[torch.Tensor, ...]:
    """Launch the training forward kernel of ``cell`` ("gru" or "lstm")
    (``grid``: on the grid tile at any width, to time it beside the
    cluster tiles).

    Returns ``(avg [B, T, u], hidden [B, u], hseq [2B, T, u])`` and, for
    LSTM, ``cseq [2B, T, u]``.
    """
    name, gates = f"{cell}_train_fwd", (4 if cell == "lstm" else 3)
    batch, steps, units = _check(name, gates, params, codes)
    grid = train_layout(units) == "grid" or grid  # raises for u <= 0
    _check_masks(name, gates, masks, batch, codes.device)
    avg = _empty(codes.device, batch, steps, units)
    hidden = _empty(codes.device, batch, units)
    n_seqs = 2 if cell == "lstm" else 1  # hseq (and cseq)
    seqs = [_empty(codes.device, 2 * batch, steps, units)
            for _ in range(n_seqs)]
    if batch == 0:
        return (avg, hidden, *seqs)
    head = (codes.data_ptr(), batch, steps, _ptr(masks),
            params["kernel"].data_ptr(), params["bias"].data_ptr())
    outs = (avg.data_ptr(), hidden.data_ptr(),
            *(seq.data_ptr() for seq in seqs))
    lib = _build.load_kernels("rnn_grid" if grid else "rnn_train")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        if grid:
            recurrent, h, carry = _grid_buffers(
                lib, 2 * batch, units, gates, params["recurrent"],
                torch.float32)
            err = getattr(lib, f"dg_{name}_grid")(
                *head, recurrent.data_ptr(), units, *outs, h[0].data_ptr(),
                h[1].data_ptr(), carry.data_ptr(), ctypes.c_void_p(stream))
        else:
            err = getattr(lib, f"dg_{name}")(
                *head, params["recurrent"].data_ptr(), units, *outs,
                ctypes.c_void_p(stream))
    _raise_on(lib, err, name + (" (grid)" if grid else ""),
              f"B={batch} T={steps} u={units}")
    LAUNCHES.add(name)
    if grid:
        LAUNCHES.add(f"{name}_grid")
    return (avg, hidden, *seqs)


def train_bwd(cell: str, params: RnnParams, codes: torch.Tensor,
              masks: Optional[torch.Tensor], seqs: Tuple[torch.Tensor, ...],
              d_avg: torch.Tensor, d_hidden: torch.Tensor, grid: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the training backward of ``cell``: the recurrence kernel,
    then the reduction kernel (:func:`_bwd_recurrence`,
    :func:`_train_reduce`).  ``seqs`` is ``(hseq,)`` or ``(hseq, cseq)``
    from :func:`train_fwd`.  Returns ``(d_kernel, d_recurrent, d_bias)``
    and counts one launch (``grid``: as :func:`train_fwd`)."""
    name, gates = f"{cell}_train_bwd", (4 if cell == "lstm" else 3)
    batch, steps, units = _check(name, gates, params, codes)
    grid = train_layout(units) == "grid" or grid  # raises for u <= 0
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
                                 d_hidden, grid)
    _train_reduce(seqs[0], codes, masks, gates, grads, *cotangents)
    LAUNCHES.add(name)
    if grid:
        LAUNCHES.add(f"{name}_grid")
    return grads[0], grads[1], grads[2]


def _bwd_recurrence(cell: str, params: RnnParams, codes: torch.Tensor,
                    masks: Optional[torch.Tensor],
                    seqs: Tuple[torch.Tensor, ...], d_avg: torch.Tensor,
                    d_hidden: torch.Tensor, grid: bool = False,
                    groups: Optional[int] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The backward's recurrence kernel of ``cell`` on checked inputs (see
    :func:`train_bwd`): the gate cotangents, ``(da [2B, T, 4u],)`` for
    LSTM, ``(d_rp, d_xp)`` ``[2B, T, 3u]`` each for GRU.  Past
    :data:`TRAIN_CLUSTER_MAX_UNITS` (or with ``grid``) the grid tile's: its
    recompute of the gates writes their preactivations into ``da``
    (``d_xp``), which each step then overwrites with the cotangents; each
    step also writes them k-major into a scratch ``[2, g W, R']`` that the
    next step's product reads, in ``groups`` blocks of :data:`GRID_UNITS`
    units a CTA (by default :func:`grid_bwd_groups` on this card; any
    count gives the same bits)."""
    batch, steps = codes.shape
    units = params["recurrent"].shape[0]
    gates = 4 if cell == "lstm" else 3
    grid = grid or _grid_route(units, "train")
    outs = tuple(_empty(codes.device, 2 * batch, steps, gates * units)
                 for _ in range(1 if cell == "lstm" else 2))
    head = (codes.data_ptr(), batch, steps, _ptr(masks),
            params["kernel"].data_ptr(), params["bias"].data_ptr())
    ins = (*(seq.data_ptr() for seq in seqs), d_avg.data_ptr(),
           d_hidden.data_ptr(), *(out.data_ptr() for out in outs))
    lib = _build.load_kernels("rnn_grid" if grid else "rnn_train")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        if grid:
            recurrent, _, carry = _grid_buffers(
                lib, 2 * batch, units, gates, params["recurrent"],
                torch.float32)
            width = recurrent.shape[0]
            transposed = _grid_transposed(params["recurrent"], gates, width)
            # (B)'s cotangents handed k-major between steps.
            cot = torch.zeros(2, gates * width, carry.shape[2],
                              device=codes.device)
            if groups is None:
                groups = grid_bwd_groups(
                    2 * batch, units, torch.cuda.get_device_properties(
                        codes.device).multi_processor_count)
            err = getattr(lib, f"dg_{cell}_bwd_grid")(
                *head, recurrent.data_ptr(), units, transposed.data_ptr(),
                *ins, carry.data_ptr(), cot.data_ptr(), groups,
                ctypes.c_void_p(stream))
        else:
            err = getattr(lib, f"dg_{cell}_bwd_recurrence")(
                *head, params["recurrent"].data_ptr(), units, *ins,
                ctypes.c_void_p(stream))
    _raise_on(lib, err, f"{cell}_train_bwd ("
              f"{'grid ' if grid else ''}recurrence)",
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


#: The kernels of each cell's training path, ``(kind, index that
#: dg_window_ctas_per_sm and dg_train_clusters take)``.
_WINDOW_KERNELS = {"lstm": (("fwd", 0), ("bwd", 1)),
                   "gru": (("fwd", 3), ("bwd", 2))}


def train_tile(cell: str, batch: int, units: int, steps: int,
               device: Optional[torch.device] = None) -> Dict[str, int]:
    """The tile of ``cell``'s training kernels (the forward and the
    backward's recurrence) on a CUDA device: its layout
    (:func:`train_layout`, ``"refused"`` for u <= 0) and threads a
    CTA (four per unit the CTA owns).  On the window tile (u <= 128):
    CTAs (one a window), resident CTAs an SM of each kernel (0 where it
    cannot launch) and the warps an SM that gives at this batch.  On the
    cluster tile, for each kernel (``fwd_...``, ``bwd_...``; the library
    picks their layouts apart): CTAs a cluster, windows a cluster,
    threads a CTA, clusters, and the clusters the card runs at once.  On
    the grid tile (past :data:`TRAIN_CLUSTER_MAX_UNITS`), from its
    library: rows and units a CTA,
    threads a CTA, the CTAs of a forward step, the CTAs
    of the backward's recompute of the gates (over the ``2B T`` rows),
    and the rows, units and CTAs of a backward step (``bwd_*``,
    :func:`grid_bwd_tile`)."""
    device = device or torch.device("cuda")
    if units <= 0:
        return {"layout": "refused", "threads": 4 * units, "ctas": batch,
                **{f"{kind}_ctas_per_sm": 0
                   for kind, _ in _WINDOW_KERNELS[cell]}}
    layout = train_layout(units)
    if layout == "grid":
        shape = (ctypes.c_longlong * 4)()
        if not _build.load_kernels("rnn_grid").dg_grid_shape(
                2 * batch, units, shape):
            raise ValueError(f"{cell}_train_fwd_grid refuses u={units} at "
                             f"B={batch}")
        grid = _grid_layout()
        bwd = grid_bwd_tile(2 * batch, units, torch.cuda.get_device_properties(
            device).multi_processor_count)
        return {"layout": layout, "rows_a_cta": min(grid[0], 2 * batch),
                "units_a_cta": grid[1], "threads": grid[4],
                "ctas_a_step": shape[2] * shape[3],
                "recompute_ctas": (-(-2 * batch * steps // grid[0])
                                   * shape[3]),
                "bwd_rows_a_cta": min(bwd[0], 2 * batch),
                "bwd_units_a_cta": bwd[1], "bwd_ctas_a_step": bwd[2]}
    lib = _build.load_kernels("rnn_train")
    if layout == "cluster":
        tile: Dict[str, object] = {"layout": layout}
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            for kind, which in _WINDOW_KERNELS[cell]:
                if not lib.dg_train_clusters(which, units, batch, out):
                    raise ValueError(f"{cell}_train_{kind} refuses "
                                     f"u={units} at B={batch}")
                tile.update({f"{kind}_cluster": out[0],
                             f"{kind}_windows": out[1],
                             f"{kind}_threads": 4 * -(-units // out[0]),
                             f"{kind}_clusters": -(-batch // out[1]),
                             f"{kind}_clusters_at_once": out[2]})
        return tile
    threads = 4 * units
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tile = {"layout": layout, "threads": threads, "ctas": batch}
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
