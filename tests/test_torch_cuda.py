"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU).

Run on a machine with a CUDA card, without the JAX conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card, at
atol 1e-5 (the JAX package's kernel tolerance, tests/test_pallas_rnn.py):
the kernel and the plain version sum the recurrent dot in other orders.
The shapes include the engine's default tile at the flagship shape
(1024 windows, T=342, u=60), a ragged batch and tiny widths.

The training kernels are held against their plain versions at the
flagship training shape (256 windows, T=342, u=60), a ragged batch and
tiny widths (also at u=96 and u=128, past the register tile, at
u=129 on the cluster tile up to its route's ceiling u=511, and from
u=512 on the grid tile, ragged at u=520, 1023, 1025 and 3000, at
u=1024, 2048, 4096, 4097, 5000 and 8192), with
and without dropout masks: forward outputs at atol 1e-5;
gradients at a max abs difference of 1e-4 times the largest magnitude of
that gradient (sums over B x T terms taken in other orders); two backward
runs give bitwise-equal gradients (no float atomics); on the cluster and
grid tiles a window's bits are the same alone and in a batch (on the grid
tile under a CUDA graph's capture too); only u <= 0 is refused, before any
launch; the grid tile's training kernels also run at GRU u=26,800 and
LSTM u=23,200 (g u^2 and the reduction's partials past 2^31 elements).
The reduction kernel alone matches the plain reduction at u=4096, at the
CLI's B=256, T=342 and u=4096, where its cotangents hold more than 2^31
elements, and at GRU u=26,800, where its partials do.  A captured step outlasts a dead graph freed around
it.

The fused inference kernels (one register tile for both cells up to
u=128) also run at the CLI's default batch (256 windows: two a CTA), at
u=96 and u=128 (past the register tile's registers), and past u=128 on
the float32 cluster tile (a window's units over 8 CTAs up to u=256, 16
beyond, ragged at u=129, 200, 300 and 520) up to its ceiling u=1024; a
window's bits there are the same alone and inside a batch, and on a
second launch.  The float32 stationary tile (the route from u=384;
forced at u=257-1024 with one to 256 windows at ragged T) matches the
plain version, gives the same bits in every variant and the cluster
tile's bits (stored digests), replays under a CUDA graph's capture bit
for bit, and its layout holds every unit and window on a grid the card
keeps resident.  Past it (in bf16 past u=1279; the scan route's GRU past
u=1024, with bf16 IO past u=767) every inference row runs the grid tile
(``csrc/rnn_grid.cu``: one tiled product a step, ``mma.sync`` in bf16;
either side of each bf16 route; the float32 rows' bits those of the step
before the bf16 step's redesign, from stored digests): held against the
plain versions at u=1025, 2048, 3000 and 4096 (ragged at u=1025 and 3000)
and at u=4097, 5000 and 8192 (one window, a ragged batch, T <= 32), at
GRU u=26,800 and LSTM u=23,200 (g u^2 past 2^31 elements), with a
window's bits alone, in a batch and repeated, and under a CUDA graph's
capture.  ``cuda_rnn.avg_layout``'s tile agrees with the library's
layout at every width up to 1279 and past it, and the bf16 step's layout
with ``cuda_rnn.grid_tile``.
The GRU sequence kernel (``gru_seq``) is held against its plain version
(``rnn.gru_apply``) on uniform random input at the scan route's shape
(2048 rows, T=342, u=60), at the CLI's default 512 rows, at u=64 and u=65
(either side of U in registers), u=128 (U through L1/L2), past it on the
cluster tile (u=256 and u=512: clusters of 8 and 16 CTAs, each with its
slice of U in shared memory; u=520 and u=1024: 16 CTAs, U through L1/L2;
past it the grid tile), and at ragged shapes; a second launch is bitwise
equal to the first (on the cluster and grid tiles too).  The bf16
variants of the fused kernels are held against their plain versions, up
to u=128 on their tensor-core tile (``mma.sync``), beyond on its cluster
tile (a window's units split over a cluster of 2 to 16 CTAs, up to
u=1279: past u=1024 one m-tile, a warp owning one unit group) and past
it on the grid tile's bf16 step (``mma.sync`` too), which
``cuda_rnn.avg_bf16_tile`` names; a window's
bf16 bits are the same alone and inside a batch of 1024 (and of 256 at
two places, on the cluster tile). Tolerance in bfloat16: atol 2e-2
(the plain version rounds h and U as the kernel does, but the tensor
cores sum the products in another order; the outputs are bf16).

The on-device MSS's stack scan (``dg_mss_stack``) is held against its
plain version on the same collapsed runs (segments equal: float64 adds and
compares in the same order), the device search against the host library,
and the MSS routes on the card against the CPU's host route (classes
equal); a CUDA tensor never runs the plain scan.

The training scan route (autograd through the plain loop, no kernel) is
held against the fused step on the card and against itself on the CPU,
and an HPO fleet step (three trials, one frozen) against the same step on
the CPU: losses at atol 1e-5, gradients and updated parameters within
1e-4 of their largest magnitude, the frozen trial's parameters bit for
bit.

The reference API's ``engine.predict`` through ``create_model`` on the
card equals ``PredictionEngine.predict`` bit for bit, and where ``h5py``
is missing ``train --modelfile m.h5`` raises before it reads anything.

The training step captured as a CUDA graph (``-k capture``): a captured
``Trainer.fit`` equals the eager fit (``capture=False``, the same
optimizer built the same way) bit for bit in history, best parameters,
the generator's state and the launch counts, for GRU with attention and
LSTM, with and without dropout, on the fused and the scan route, and for
one epoch of every optimizer name the port maps; captured fleet steps
with a freeze (a new graph of the active trials) equal the eager ones,
and a captured ``run_parallel_trials`` the eager one.

The data-parallel epoch captured with its ``all_reduce`` inside
(``-k dp_capture``): at world size 1 over NCCL the captured
``make_dp_train_epoch`` equals the eager one bit for bit (losses,
parameters, generator state, launch counts) for ``gru_att`` and the LSTM
of its width on the fused route and ``gru_att`` on the scan route; a
capture in ``StepGraph``'s ``"global"`` mode outlasts NCCL's watchdog's
polling of earlier collectives; under
torch's fake process group at world size 2 a captured ``Trainer.fit(group=
...)`` equals the eager fit bit for bit; on a machine with two cards, two
NCCL ranks (processes of their own) fit captured and eager, equal bit for
bit (skipped with fewer cards).

The ``train_and_evaluate`` example on the card for 1 x 3 steps launches
each training kernel once a step and the inference kernel on the
validation and every evaluation chunk, and no plain version runs.
"""

import contextlib
import ctypes
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deepgrp_tpu_torch import _build
from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.models import cuda_rnn, rnn
from deepgrp_tpu_torch.models.keras_io import load_model
from deepgrp_tpu_torch.models.model import (DeepGRPModel, ModelConfig,
                                            init_params,
                                            require_full_f32_matmul)
from deepgrp_tpu_torch.ops import mss, mss_device
from deepgrp_tpu_torch.parallel.predict import ShardedPredictionEngine
from deepgrp_tpu_torch.predict import postprocess
from deepgrp_tpu_torch.predict.engine import PredictionEngine
from deepgrp_tpu_torch.train.optimizers import get_optimizer
from deepgrp_tpu_torch.train.training import train_step

pytestmark = pytest.mark.cuda

ATOL = 1e-5
# Past u=1024, where the tiles of several units a lane once ran (the grid
# tile now; in bf16 the cluster tile up to u=1279): (batch, steps, units),
# ragged at u=1025 and 3000, and u=2048 and 4096 at T=342.
WIDE_SHAPES = ((37, 150, 1025), (64, 342, 2048), (5, 23, 3000),
               (16, 342, 4096))
TORCH_FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "torch")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    require_full_f32_matmul()
    return torch.device("cuda")


def random_case(seed, gates, batch, steps, units, device):
    rng = np.random.default_rng(seed)
    width = gates * units
    params = {
        "kernel": rng.normal(0.0, 0.5, (5, width)),
        "recurrent": rng.normal(0.0, units ** -0.5, (units, width)),
        "bias": rng.normal(0.0, 0.3, (2, width) if gates == 3 else (width,)),
    }
    codes = rng.integers(0, 6, size=(batch, steps)).astype(np.int8)
    codes[0, :3] = 4  # N
    codes[-1, -4:] = 5  # pad
    return ({k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in params.items()},
            torch.from_numpy(codes).to(device))


TRAIN_SHAPES = [(256, 342, 60), (37, 150, 32), (3, 7, 5), (9, 1, 17)]
# The grid's backward step (B) (batch, steps, units): ragged rows at B=1,
# 3, 19 over ragged widths (u=1025, 3000, 4097), T=1 (no product), and on
# 132 SMs its blocks of 32 units a CTA with a ragged last CTA: B=64 at
# u=4097 2 blocks (129), u=3001 3 (94), B=256 at u=1537 4 (49).
GRID_BWD_SHAPES = ((1, 20, 1025), (3, 9, 3000), (19, 12, 4097),
                   (3, 1, 1025), (64, 12, 4097), (64, 12, 3001),
                   (256, 4, 1537))


def random_masks(seed, gates, batch, device, rate=0.0928):
    keep = 1.0 - rate
    rng = np.random.default_rng(seed)
    masks = (rng.random((gates, 2 * batch, 5)) < keep) / keep
    return torch.tensor(masks, dtype=torch.float32, device=device)


def assert_grads_close(got, want):
    for name, g, w in zip(("kernel", "recurrent", "bias"), got, want):
        assert g.shape == w.shape, name
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("batch,steps,units", TRAIN_SHAPES)
def test_train_kernels_match_plain(device, cell, masked, batch, steps,
                                   units):
    check_train_pair(device, cell, masked, batch, steps, units)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("batch,steps,units", [(64, 342, 96),
                                               (5, 20, 128),
                                               (5, 20, 129),
                                               (37, 150, 200),
                                               (64, 342, 256),
                                               (5, 20, 257),
                                               (37, 150, 300),
                                               (5, 23, 520),
                                               (64, 342, 512),
                                               (8, 64, 511),
                                               (8, 64, 512),
                                               (8, 64, 1023),
                                               (8, 64, 1024),
                                               *WIDE_SHAPES,
                                               *GRID_BWD_SHAPES])
def test_train_kernels_match_plain_wide(device, cell, masked, batch, steps,
                                        units):
    """Widths past the register tile (U read through L2) up to u=128, the
    cluster tile (a window's units over a cluster of CTAs) from u=129 to
    its route's ceiling u=511 and the grid tile from u=512
    (``cuda_rnn.train_layout``); ragged batches at u=200 and 300, ragged
    widths over the cluster's CTAs at u=129, 257 and 300, over the grid's
    unit blocks at u=520, 1023, 1025 and 3000; the grid's backward step
    (B) at ragged rows (B=1, 3, 19), over its blocks of 1-4 x 32 units a
    CTA (:data:`GRID_BWD_SHAPES`) and at T=1."""
    check_train_pair(device, cell, masked, batch, steps, units)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", [129, 256, 300, 511, 1023, 1024, 1025,
                                   2048, 4096, 4097])
def test_train_cluster_bits_alone_and_repeated(device, cell, units):
    """On the tile each width routes to (from u=129; the grid tile from
    u=512, at u=4097 one unit past a block of 32) a window's training
    forward and backward cotangents have the same bits alone and inside a
    batch (whatever its cluster, CTA, lane or the windows a cluster; on
    the grid its row block), and a second run repeats them.  On the
    cluster tile also inside a batch of 256, which takes 4 or 8 windows a
    cluster in both kernels where the window alone takes 2."""
    gates = 4 if cell == "lstm" else 3
    steps = 40
    cluster = units <= cuda_rnn.TRAIN_CLUSTER_MAX_UNITS
    for batch in (19, 256) if cluster else (19,):
        if batch == 256:
            big = cuda_rnn.train_tile(cell, batch, units, steps)
            one = cuda_rnn.train_tile(cell, 1, units, steps)
            for kind in ("fwd", "bwd"):
                assert big[f"{kind}_windows"] >= 4 > one[f"{kind}_windows"]
        params, codes = random_case(units, gates, batch, steps, units,
                                    device)
        masks = random_masks(units, gates, batch, device)
        rng = np.random.default_rng(units + 1)
        d_avg = torch.tensor(rng.normal(size=(batch, steps, units)),
                             dtype=torch.float32, device=device)
        d_hid = torch.tensor(rng.normal(size=(batch, units)),
                             dtype=torch.float32, device=device)

        def run(rows):
            lo, hi = rows
            sub_masks = masks.view(gates, 2, batch, 5)[:, :, lo:hi].reshape(
                gates, 2 * (hi - lo), 5).contiguous()
            sub = codes[lo:hi].contiguous()
            out = cuda_rnn.train_fwd(cell, params, sub, sub_masks)
            seqs = tuple(out[2:])
            cot = cuda_rnn._bwd_recurrence(cell, params, sub, sub_masks,
                                           seqs, d_avg[lo:hi].contiguous(),
                                           d_hid[lo:hi].contiguous())
            return out, cot

        (out, cot), (again, cot_again) = run((0, batch)), run((0, batch))
        alone, cot_alone = run((11, 12))
        torch.cuda.synchronize()
        for g, a in zip(out + cot, again + cot_again):
            assert torch.equal(g, a)
        assert torch.equal(alone[0], out[0][11:12])
        assert torch.equal(alone[1], out[1][11:12])
        for seq, seq_alone in zip(out[2:], alone[2:]):
            assert torch.equal(seq_alone, seq[[11, batch + 11]])
        for c, c_alone in zip(cot, cot_alone):
            assert torch.equal(c_alone, c[[11, batch + 11]])


def check_train_pair(device, cell, masked, batch, steps, units):
    gates = 4 if cell == "lstm" else 3
    seed = batch * steps + units
    params, codes = random_case(seed, gates, batch, steps, units, device)
    masks = random_masks(seed, gates, batch, device) if masked else None
    plain_fwd, plain_bwd = cuda_rnn._PLAIN[cell]
    launches = cuda_rnn.LAUNCHES.snapshot()
    got = cuda_rnn.train_fwd(cell, params, codes, masks)
    torch.cuda.synchronize()
    want = plain_fwd(params, codes, masks)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)

    rng = np.random.default_rng(seed + 1)
    d_avg = torch.tensor(rng.normal(size=(batch, steps, units)),
                         dtype=torch.float32, device=device)
    d_hid = torch.tensor(rng.normal(size=(batch, units)),
                         dtype=torch.float32, device=device)
    seqs = tuple(want[2:])
    grads = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                               d_hid)
    again = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                               d_hid)
    torch.cuda.synchronize()
    assert_grads_close(grads, plain_bwd(params, codes, masks, *seqs, d_avg,
                                        d_hid))
    for g, a in zip(grads, again):
        assert torch.equal(g, a)
    now = cuda_rnn.LAUNCHES.snapshot()
    assert now.get(f"{cell}_train_fwd", 0) == launches.get(
        f"{cell}_train_fwd", 0) + 1
    assert now.get(f"{cell}_train_bwd", 0) == launches.get(
        f"{cell}_train_bwd", 0) + 2


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_window_tile_quadruples_warps_per_sm(device, cell):
    """At B=256, u=60 the window kernels (each cell's forward and backward
    recurrence) put at least 4x the 3.75 warps an SM of the block-row tile
    they replace (2 windows x 60 threads, one CTA an SM)."""
    tile = cuda_rnn.train_tile(cell, 256, 60, 342)
    assert tile["threads"] == 240 and tile["ctas"] == 256
    for kind in ("fwd", "bwd"):
        assert tile[f"{kind}_warps_per_sm"] >= 4 * 3.75, tile


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_train_tile_by_width(device, cell):
    """The training kernels (forward and backward recurrence) launch up
    to u=511 at T=342 on their window and cluster tiles (4u threads a
    CTA up to u=128; past it one unit a lane over a cluster of CTAs, at
    most 256 threads a CTA), and from u=512 on the grid tile, whose tile
    the library reports, the backward step's (B) as ``grid_bwd_tile``
    counts it on this card."""
    tile = cuda_rnn.train_tile(cell, 8, 128, 342)
    assert tile["layout"] == "l2", tile
    assert tile["bwd_ctas_per_sm"] >= 1 and tile["fwd_ctas_per_sm"] >= 1
    for units in (129, 256, 257, 511):
        tile = cuda_rnn.train_tile(cell, 8, units, 342)
        assert tile["layout"] == "cluster", tile
        for kind in ("fwd", "bwd"):
            cluster = tile[f"{kind}_cluster"]
            assert cluster * 64 >= units, tile
            assert tile[f"{kind}_threads"] == 4 * -(-units // cluster)
            assert tile[f"{kind}_threads"] <= 256, tile
            assert tile[f"{kind}_clusters"] == -(-8 // tile[
                f"{kind}_windows"]), tile
            assert tile[f"{kind}_clusters_at_once"] >= 1, tile
    for batch, units in ((8, 512), (8, 1023), (8, 1024), (8, 1025),
                         (8, 2048), (8, 4096), (8, 4097), (64, 4608),
                         (3, 8192)):
        tile = cuda_rnn.train_tile(cell, batch, units, 342)
        assert tile == {
            "layout": "grid", "rows_a_cta": min(32, 2 * batch),
            "units_a_cta": 32, "threads": 256,
            "ctas_a_step": cuda_rnn.grid_tile(2 * batch, units)[1],
            "recompute_ctas": -(-2 * batch * 342 // 32) * -(-units // 32),
            "bwd_rows_a_cta": min(32, 2 * batch),
            "bwd_units_a_cta": cuda_rnn.grid_bwd_tile(2 * batch, units)[1],
            "bwd_ctas_a_step": cuda_rnn.grid_bwd_tile(2 * batch, units)[2]}
    tile = cuda_rnn.train_tile(cell, 8, 0, 342)
    assert tile["layout"] == "refused"
    assert tile["bwd_ctas_per_sm"] == 0 and tile["fwd_ctas_per_sm"] == 0


def test_train_kernels_refuse_only_u0(device):
    """Both cells' forward and backward take every width (u=4097 launches
    the grid tile) and refuse only u <= 0, naming it, before any
    launch."""
    batch, steps = 2, 5
    for cell, gates in (("gru", 3), ("lstm", 4)):
        for units in (0, 4097):
            params, codes = random_case(5, gates, batch, steps,
                                        max(units, 1), device)
            if units == 0:  # random_case draws U at scale u^-0.5
                params = {"kernel": torch.zeros(5, 0, device=device),
                          "recurrent": torch.zeros(0, 0, device=device),
                          "bias": torch.zeros(*((2, 0) if gates == 3
                                                else (0,)), device=device)}
            seqs = tuple(torch.zeros(2 * batch, steps, units, device=device)
                         for _ in range(gates - 2))
            launches = cuda_rnn.LAUNCHES.snapshot()

            def run():
                cuda_rnn.train_fwd(cell, params, codes, None)
                cuda_rnn.train_bwd(cell, params, codes, None, seqs,
                                   torch.zeros(batch, steps, units,
                                               device=device),
                                   torch.zeros(batch, units, device=device))
                torch.cuda.synchronize()

            if units == 0:
                with pytest.raises(ValueError, match="not u=0"):
                    run()
                assert cuda_rnn.LAUNCHES.snapshot() == launches
                continue
            run()
            now = cuda_rnn.LAUNCHES.snapshot()
            for name in (f"{cell}_train_fwd", f"{cell}_train_bwd",
                         f"{cell}_train_fwd_grid", f"{cell}_train_bwd_grid"):
                assert now.get(name, 0) == launches.get(name, 0) + 1, name


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("masked", [True, False])
def test_bwd_parts_match_plain(device, cell, masked):
    """The recurrence kernel's gate cotangents against the plain
    recurrence, and the reduction kernel on those cotangents against the
    plain reduction (1e-4 of the largest magnitude)."""
    batch, steps, units = 37, 150, 32
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(99, gates, batch, steps, units, device)
    masks = random_masks(99, gates, batch, device) if masked else None
    _, _, *seqs = cuda_rnn._PLAIN[cell][0](params, codes, masks)
    rng = np.random.default_rng(7)
    d_avg = torch.tensor(rng.normal(size=(batch, steps, units)),
                         dtype=torch.float32, device=device)
    d_hid = torch.tensor(rng.normal(size=(batch, units)),
                         dtype=torch.float32, device=device)
    got = cuda_rnn._bwd_recurrence(cell, params, codes, masks, tuple(seqs),
                                   d_avg, d_hid)
    if cell == "lstm":
        want = (rnn.lstm_bwd_recurrence_plain(params, codes, masks, *seqs,
                                              d_avg, d_hid),)
    else:
        want = rnn.gru_bwd_recurrence_plain(params, codes, masks, seqs[0],
                                            d_avg, d_hid)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    grads = [torch.empty_like(params[k])
             for k in ("kernel", "recurrent", "bias")]
    cuda_rnn._train_reduce(seqs[0], codes, masks, gates, grads, *want)
    assert_grads_close(grads, rnn.train_reduce_plain(seqs[0], want[0], codes,
                                                     masks, *want[1:]))


def random_reduce_case(seed, gates, batch, steps, units, masked, device):
    """hseq in (-1, 1) and the gate cotangents (r1, and r2 for the GRU)
    drawn on the card, codes with N and pad steps, masks at rate 0.0928."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hseq = torch.rand(2 * batch, steps, units, generator=gen,
                      device=device) * 2 - 1
    cots = tuple(torch.randn(2 * batch, steps, gates * units, generator=gen,
                             device=device)
                 for _ in range(1 if gates == 4 else 2))
    _, codes = random_case(seed, gates, batch, steps, 1, device)
    masks = random_masks(seed, gates, batch, device) if masked else None
    return hseq, cots, codes, masks


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("masked", [True, False])
def test_train_reduce_matches_plain_u4096(device, cell, masked):
    """The reduction kernel at the ceiling u=4096 (64 x 256 output tiles of
    the LSTM's dU) against the plain reduction: 1e-4 of the largest
    magnitude, and a second run repeats its bits."""
    gates = 4 if cell == "lstm" else 3
    batch, steps, units = 4, 20, 4096
    hseq, cots, codes, masks = random_reduce_case(
        units + gates, gates, batch, steps, units, masked, device)
    shapes = ((5, gates * units), (units, gates * units),
              (2, 3 * units) if gates == 3 else (4 * units,))
    grads, again = ([torch.empty(shape, device=device) for shape in shapes]
                    for _ in range(2))
    cuda_rnn._train_reduce(hseq, codes, masks, gates, grads, *cots)
    cuda_rnn._train_reduce(hseq, codes, masks, gates, again, *cots)
    torch.cuda.synchronize()
    assert_grads_close(grads, rnn.train_reduce_plain(hseq, cots[0], codes,
                                                     masks, *cots[1:]))
    for g, a in zip(grads, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("gates,batch,steps,units", [
    (4, 256, 342, 4096), (3, 2, 4, 26800)])
def test_train_reduce_past_2_31_elements(device, gates, batch, steps,
                                         units):
    """The reduction kernel past 2^31 elements: at the CLI's B=256, T=342
    and u=4096 (LSTM) r1 holds 175,104 x 16,384 = 2.87e9 floats; at the
    grid tile's GRU u=26,800 (B=2, T=4) the partials [u+7, 3u] hold 2.16e9
    (summed by SumReducePartsKernel with 64-bit offsets); against the
    plain reduction (1e-4 of the largest magnitude).  Needs about 20 GB of
    device memory."""
    hseq, cots, codes, _ = random_reduce_case(7, gates, batch, steps, units,
                                              False, device)
    assert max(cots[0].numel(), (units + 7) * gates * units) > 2 ** 31
    shapes = ((5, gates * units), (units, gates * units),
              (2, 3 * units) if gates == 3 else (4 * units,))
    grads = [torch.empty(shape, device=device) for shape in shapes]
    cuda_rnn._train_reduce(hseq, codes, None, gates, grads, *cots)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert_grads_close(grads, rnn.train_reduce_plain(hseq, cots[0], codes,
                                                     None, *cots[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_avg_tile_fills_the_card(device, dtype):
    """The GRU inference tile: one wave at the engine's 1024 windows and at
    the fixtures' 64 (8 and 1 windows a CTA on a 132-SM card), in float32
    (at most 8 windows a CTA up to u=128) and on the bf16 tensor-core tile
    (at most 8, one m-tile); past u=128 the cluster tile's windows, which
    every CTA of a cluster holds (the wave counts clusters).  The float32 choice is the same with and
    without ``out_dtype``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in (1024, 64, 4096):
        windows, n_cta = cuda_rnn.avg_tile("gru", batch, 60, None, dtype)
        assert windows * n_cta >= batch and windows <= 8
        assert n_cta <= sms or windows == 8
    assert cuda_rnn.avg_tile("gru", 64, 60, None, dtype) == (1, 64)
    windows, n_cta = cuda_rnn.avg_tile("gru", 1024, 200, None, dtype)
    if dtype == torch.float32:  # the cluster tile: 8 CTAs, 8 windows
        assert cuda_rnn.avg_cluster("gru", 200) == 8
        assert windows == 8 and n_cta == 1024 // 8 * 8
    else:  # the cluster tile: clusters of 2 CTAs, 16 windows at most
        assert cuda_rnn.avg_bf16_cluster("gru", 200) == 2
        assert windows <= 16 and n_cta == -(-1024 // windows) * 2
        if sms == 132:  # 64 clusters of 4 windows fill the card
            assert cuda_rnn.avg_tile("gru", 256, 256, None, dtype) == (4,
                                                                      128)
    # Past u=256 the wave counts the card's own count of clusters at once
    # (16 CTAs need 16 free SMs of one GPC; small ones share an SM): the
    # fewest windows that fill one wave, at most the layout's cap; on the
    # float32 stationary tile (u=384-1024) every CTA of one resident grid,
    # at most one an SM, takes every window; on the grid tile (past
    # u=1024, in bf16 past 1279) its rows and CTAs a step in the dtype's
    # step (bf16: 128 rows a CTA, the tensor-core step).
    lib = _build.load_kernels("rnn_avg")
    for units in (300, 512, 1024, 2048, 4096):
        layout = cuda_rnn.avg_layout("gru", units, dtype)
        if layout["tile"] == "stationary":
            for batch in (5, 64, 256, 1024):
                ctas = cuda_rnn.stationary_layout("gru", batch,
                                                  units)["ctas"]
                assert ctas <= sms
                assert cuda_rnn.avg_tile("gru", batch, units, None,
                                         dtype) == (batch, ctas)
            continue
        if layout["tile"] == "grid":
            for batch in (5, 64, 256, 1024):
                rows, ctas = cuda_rnn.grid_tile(2 * batch, units, dtype)
                assert cuda_rnn.avg_tile("gru", batch, units, None,
                                         dtype) == (max(rows // 2, 1), ctas)
            continue
        slots = lib.dg_avg_clusters(3, units, layout["max_windows"],
                                    int(dtype == torch.bfloat16))
        assert slots > 0
        for batch in (5, 64, 256, 1024):
            windows, n_cta = cuda_rnn.avg_tile("gru", batch, units, None,
                                               dtype)
            assert windows == cuda_rnn.block_windows(
                batch, slots, layout["max_windows"])
            assert n_cta == -(-batch // windows) * layout["cluster"]
    assert cuda_rnn.avg_tile("gru", 4096, 128, None, dtype)[0] == 8
    if dtype == torch.float32:
        for batch in (1024, 256, 64, 4096):
            assert cuda_rnn.avg_tile("gru", batch, 60) == cuda_rnn.avg_tile(
                "gru", batch, 60, None, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_avg_tile_fills_the_card(device, dtype):
    """The LSTM runs on the GRU's tile: one wave at the engine's 1024
    windows and at the CLI's default 256 (128 CTAs of 2 windows on a
    132-SM card, where the first design ran 32 CTAs of 8), in float32 and
    in bf16."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in (1024, 256):
        windows, n_cta = cuda_rnn.avg_tile("lstm", batch, 60, None, dtype)
        assert windows * n_cta >= batch and windows <= 8
        assert n_cta <= sms or windows == 8
        assert cuda_rnn.avg_tile("lstm", batch, 60, None,
                                 dtype) == cuda_rnn.avg_tile(
            "gru", batch, 60, None, dtype)
    if sms == 132:
        assert cuda_rnn.avg_tile("lstm", 256, 60, None, dtype) == (2, 128)
        assert cuda_rnn.avg_tile("lstm", 1024, 60, None, dtype) == (8, 128)
    # Past u=1024 the CLI's default batch and -b 1024 get a tile within the
    # width's cap of windows a CTA (its h buffers; on the grid tile its
    # row block), every window placed; at u=1024 in float32 the
    # stationary tile's CTAs, at most one an SM, each take every window.
    for units in (2048, 4096, 1024):
        layout = cuda_rnn.avg_layout("lstm", units, dtype)
        for batch in (256, 1024):
            windows, n_cta = cuda_rnn.avg_tile("lstm", batch, units, None,
                                               dtype)
            if layout["tile"] == "stationary":
                assert windows == batch and n_cta <= sms
                assert n_cta == cuda_rnn.stationary_layout(
                    "lstm", batch, units)["ctas"]
                continue
            assert 1 <= windows <= layout["max_windows"]
            if layout["tile"] == "grid":
                assert n_cta == cuda_rnn.grid_tile(2 * batch, units,
                                                   dtype)[1]
            else:
                assert n_cta == -(-batch // windows) * layout["cluster"]


def test_lstm_avg_refuses_u257(device):
    """Named for the first ceiling: the inference kernels take every width
    (past u=256 on a cluster of 16 CTAs, past u=1024 the grid tile; in
    bf16 past u=1279).  u=4097 launches the grid tile, in float32
    and bfloat16, and no plain version runs; only u <= 0 raises
    ``ValueError``, before any launch."""
    params, codes = random_case(6, 4, 3, 5, 4097, device)
    for dtype in (torch.float32, torch.bfloat16):
        suffix = rnn.dtype_suffix(dtype)
        launches = cuda_rnn.LAUNCHES.snapshot()
        plain = rnn.PLAIN_CALLS.snapshot()
        avg, hidden = cuda_rnn.lstm_avg(params, codes, dtype)
        torch.cuda.synchronize()
        now = cuda_rnn.LAUNCHES.snapshot()
        for name in (f"lstm_avg{suffix}", f"lstm_avg_grid{suffix}"):
            assert now.get(name, 0) == launches.get(name, 0) + 1
        assert rnn.PLAIN_CALLS.snapshot() == plain
        assert avg.shape == (3, 5, 4097) and avg.dtype == dtype
    empty = {"kernel": torch.zeros(5, 0, device=device),
             "recurrent": torch.zeros(0, 0, device=device),
             "bias": torch.zeros(0, device=device)}
    launches = cuda_rnn.LAUNCHES.snapshot()
    with pytest.raises(ValueError, match="u >= 1, not u=0"):
        cuda_rnn.lstm_avg(empty, codes)
    assert cuda_rnn.LAUNCHES.snapshot() == launches


@pytest.mark.parametrize("cell,batch,steps,units", [
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in ((1024, 342, 60), (1000, 150, 32), (3, 7, 5), (9, 1, 17))),
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in ((256, 342, 60), (1024, 342, 96), (1024, 342, 128),
                    (37, 50, 200))),
    # The cluster tile: 8 CTAs with U in shared memory (ragged at u=129
    # and 200), 16 with U through L1/L2 (ragged at u=257, 300 and 520, up
    # to the ceiling).
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in ((37, 50, 129), (64, 100, 200), (256, 342, 256),
                    (9, 40, 257), (37, 150, 300), (256, 342, 512),
                    (5, 23, 520), (64, 342, 1024))),
    # Past u=1024 the grid tile (ragged over its unit blocks at u=1025 and
    # u=3000).
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in WIDE_SHAPES)])
def test_kernel_matches_plain(device, cell, batch, steps, units):
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(batch + steps + units, gates, batch, steps,
                                units, device)
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    plain = getattr(rnn, f"{cell}_avg_plain")
    launches = cuda_rnn.LAUNCHES.get(f"{cell}_avg")
    avg, hidden = kernel(params, codes)
    torch.cuda.synchronize()
    assert cuda_rnn.LAUNCHES.get(f"{cell}_avg") == launches + 1
    want_avg, want_hidden = plain(params, codes)
    assert avg.shape == (batch, steps, units)
    assert hidden.shape == (batch, units)
    torch.testing.assert_close(avg, want_avg, atol=ATOL, rtol=0)
    torch.testing.assert_close(hidden, want_hidden, atol=ATOL, rtol=0)


def test_kernel_refuses_wrong_dtype(device):
    params, codes = random_case(0, 3, 4, 8, 6, device)
    with pytest.raises(ValueError, match="int8"):
        cuda_rnn.gru_avg(params, codes.int())


def test_engine_on_card_matches_cpu(device):
    """The whole scan on the card (kernels) against the same scan on the
    CPU (plain versions): classes equal, max probability to 1e-5."""
    config, params = load_model(
        os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    codes = np.random.default_rng(3).integers(0, 5, 20000).astype(np.int8)
    results = []
    for dev in (device, "cpu"):
        model = DeepGRPModel.from_params(config, params, dev)
        results.append(PredictionEngine(model, batch_size=64,
                                        step_size=50).predict_scored(codes))
    (got_c, got_p), (want_c, want_p) = results
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, atol=ATOL)


@pytest.mark.parametrize("rnn_type,attention,units,epsilon", [
    pytest.param("GRU", True, 16, None, id="GRU-True"),
    pytest.param("LSTM", False, 16, None, id="LSTM-False"),
    pytest.param("GRU", True, 300, 1e-6, id="GRU-True-u300"),
    pytest.param("LSTM", False, 300, 1e-6, id="LSTM-False-u300")])
def test_train_step_on_card_matches_cpu(device, rnn_type, attention, units,
                                        epsilon):
    """One optimization step on the card (kernels) against the same step
    on the CPU (plain versions): loss at atol 1e-5, gradients as above,
    updated parameters at atol 1e-5; also at u=300, on the cluster tile,
    with RMSprop's epsilon at 1e-6 (as tests/test_torch_training.py's
    u=300 case: U's gradient has entries near the default 1e-10, where
    sums in other orders move the update by more than 1e-5)."""
    extra = {} if epsilon is None else {"epsilon": epsilon}
    options = Options(vecsize=60, units=units, batch_size=32, rnn=rnn_type,
                      attention=attention, dropout=0.0928, **extra)
    config = ModelConfig.from_options(options)
    params = init_params(config, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    codes = torch.from_numpy(rng.integers(0, 6, size=(32, 60)).astype(
        np.int8))
    labels = torch.eye(5)[torch.from_numpy(rng.integers(0, 5, (32, 60)))]
    masks = random_masks(8, config.gates, 32, "cpu")
    results = []
    for dev in (device, torch.device("cpu")):
        model = DeepGRPModel.from_params(config, params, dev)
        opt = get_optimizer(options, model.parameters())
        loss = train_step(model, opt, codes.to(dev), labels.to(dev),
                          masks.to(dev))
        results.append((loss.item(),
                        {k: (v.detach().cpu(), v.grad.cpu())
                         for k, v in model.params().items()}))
    (loss_card, card), (loss_cpu, cpu) = results
    assert abs(loss_card - loss_cpu) <= 1e-5
    for key, (value, grad) in card.items():
        err = (grad - cpu[key][1]).abs().max().item()
        assert err <= 1e-4 * cpu[key][1].abs().max().item(), (key, err)
        torch.testing.assert_close(value, cpu[key][0], atol=1e-5, rtol=0)


BF16_ATOL = 2e-2


def random_seq_case(batch, steps, units, dtype, device):
    """GRU weights and a uniform random input ``x [B, T, 5]`` from a seed."""
    rng = np.random.default_rng(batch + steps + units)
    width = 3 * units
    params = {
        "kernel": rng.normal(0.0, 0.5, (5, width)),
        "recurrent": rng.normal(0.0, units ** -0.5, (units, width)),
        "bias": rng.normal(0.0, 0.3, (2, width)),
    }
    params = {k: torch.tensor(v, dtype=torch.float32, device=device)
              for k, v in params.items()}
    x = torch.tensor(rng.random((batch, steps, 5)), dtype=torch.float32,
                     device=device).to(dtype)
    return params, x


@pytest.mark.parametrize("dtype,batch,steps,units", [
    (torch.float32, 2048, 342, 60), (torch.bfloat16, 2048, 342, 60),
    (torch.float32, 2048, 342, 128), (torch.float32, 512, 342, 256),
    (torch.bfloat16, 512, 342, 256), (torch.float32, 7, 23, 60),
    (torch.bfloat16, 7, 23, 60), (torch.float32, 9, 1, 17),
    # The CLI's default batch (512 rows: 4 a CTA, a lane group of 4 rows).
    (torch.float32, 512, 342, 60),
    # 12 rows a CTA: the second lane group of 8 (u=64, U in registers) or
    # the one group of 16 (u=65, through L1/L2) has rows past the CTA, and
    # the last CTA holds one row.
    (torch.float32, 1501, 50, 64), (torch.float32, 1501, 50, 65),
    # The cluster tile: u=512 (16 CTAs, U in shared memory; u=256 above:
    # 8), u=1024 and the ragged u=520 (16 CTAs of 33 units, the last with
    # 25; U through L1/L2), at few rows; with bf16 IO past u=767 the grid
    # tile (u=1024 here).
    (torch.float32, 6, 40, 512), (torch.float32, 5, 20, 1024),
    (torch.bfloat16, 5, 20, 1024), (torch.bfloat16, 2048, 342, 128),
    (torch.float32, 16, 342, 512), (torch.bfloat16, 16, 342, 512),
    (torch.float32, 64, 342, 1024), (torch.bfloat16, 64, 342, 1024),
    (torch.float32, 5, 23, 520), (torch.bfloat16, 5, 23, 520),
    (torch.float32, 37, 60, 200),
    # Past u=1024 the grid tile, in either dtype.
    *((dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
      for shape in WIDE_SHAPES)])
def test_gru_seq_matches_plain(device, dtype, batch, steps, units):
    params, x = random_seq_case(batch, steps, units, dtype, device)
    launches = cuda_rnn.LAUNCHES.get("gru_seq")
    seq, last = cuda_rnn.gru_apply(params, x)
    torch.cuda.synchronize()
    assert cuda_rnn.LAUNCHES.get("gru_seq") == launches + 1
    want_seq, want_last = rnn.gru_apply(params, x)
    assert seq.dtype == last.dtype == dtype
    assert seq.shape == (batch, steps, units) and last.shape == (batch,
                                                                 units)
    atol = ATOL if dtype == torch.float32 else BF16_ATOL
    torch.testing.assert_close(seq.float(), want_seq.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(last.float(), want_last.float(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_seq_repeats_bitwise(device, dtype):
    """Fixed-order sums and no atomics: a second launch equals the first
    bit for bit (two lane groups, rows past the CTA and the batch)."""
    params, x = random_seq_case(1501, 50, 60, dtype, device)
    first = cuda_rnn.gru_apply(params, x)
    second = cuda_rnn.gru_apply(params, x)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,steps,units", [(16, 342, 512), (9, 40, 520),
                                               (37, 60, 200),
                                               (16, 342, 2048),
                                               (9, 40, 4096)])
def test_gru_seq_cluster_repeats_bitwise(device, dtype, batch, steps,
                                         units):
    """On the cluster tile each unit's sum runs in an order fixed by u (a
    CTA owns whole sums; no partial sum crosses CTAs), and on the grid
    tile past u=1024 likewise: a second launch equals the first bit for
    bit, and a row's bits do not depend on the other rows of its cluster
    (row block) or the batch."""
    params, x = random_seq_case(batch, steps, units, dtype, device)
    first = cuda_rnn.gru_apply(params, x)
    second = cuda_rnn.gru_apply(params, x)
    alone = cuda_rnn.gru_apply(params, x[batch // 2:batch // 2 + 1]
                               .contiguous())
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(alone[0], first[0][batch // 2:batch // 2 + 1])


def test_gru_seq_refuses_u1025(device):
    """Named for a former ceiling: the sequence kernel takes u <= 1024 on
    its cluster tile and past it runs the grid tile: u=1025 and u=4097
    launch it (``gru_seq`` and ``gru_seq_grid`` counted once each) and no
    plain version runs."""
    for units in (1025, 4097):
        params, x = random_seq_case(2, 3, units, torch.float32, device)
        launches = cuda_rnn.LAUNCHES.snapshot()
        plain = rnn.PLAIN_CALLS.snapshot()
        seq, last = cuda_rnn.gru_apply(params, x)
        torch.cuda.synchronize()
        now = cuda_rnn.LAUNCHES.snapshot()
        for name in ("gru_seq", "gru_seq_grid"):
            assert now.get(name, 0) == launches.get(name, 0) + 1
        assert rnn.PLAIN_CALLS.snapshot() == plain
        assert seq.shape == (2, 3, units) and last.shape == (2, units)


def test_gru_seq_layout(device):
    """The layout the kernel launches by width and rows a CTA, and the
    cap of :func:`cuda_rnn.seq_tile` is the kernel's own."""
    cases = {(60, 16): (8, 4, "registers", 1),
             (60, 4): (4, 4, "registers", 1),
             (64, 12): (8, 4, "registers", 1), (65, 12): (16, 4, "L1/L2", 1),
             (128, 3): (4, 4, "L1/L2", 1), (129, 4): (4, 4, "shared", 8),
             (256, 16): (8, 4, "shared", 8), (512, 1): (4, 4, "shared", 16),
             (520, 8): (16, 4, "L1/L2", 16), (1023, 16): (16, 4, "L1/L2", 16),
             (1024, 4): (4, 4, "L1/L2", 16)}
    for (units, rows), want in cases.items():
        layout = cuda_rnn.seq_layout(units, rows)
        assert (layout["rows_a_group"], layout["slices"], layout["u_in"],
                layout["cluster"]) == want
        assert layout["cluster"] == cuda_rnn.seq_cluster(units)
    for units in (60, 128, 129, 256, 257, 512, 513, 1023, 1024):
        most = cuda_rnn.seq_tile(10 ** 6, units, 1)[0]
        cuda_rnn.seq_layout(units, most)
        with pytest.raises(ValueError):
            cuda_rnn.seq_layout(units, most + 1)
    # Past u=1024 the grid tile: 4 rows x 4 units a thread, four k-slices,
    # tiles of U through L2, no cluster; only u <= 0 is refused.
    for units in (1025, 2048, 2049, 4096, 4097, 8192):
        assert cuda_rnn.seq_layout(units, 1) == {
            "rows_a_group": 4, "slices": 4, "u_in": "L2", "cluster": 1,
            "units_a_thread": 4}
    with pytest.raises(ValueError):
        cuda_rnn.seq_layout(0, 1)


@pytest.mark.parametrize("cell,batch,steps,units", [
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in ((1024, 342, 60), (1000, 150, 32), (3, 7, 5),
                    (1024, 342, 96), (1024, 342, 128),
                    # The cluster tile, one window, one step, an odd width
                    # and more windows than one wave holds.
                    (64, 342, 256), (1, 342, 60), (1000, 1, 60),
                    (37, 50, 17), (4000, 40, 128),
                    # The cluster tile at the CLI's default batch and the
                    # engine's, and a ragged one (u=200: 25 unit groups,
                    # the last CTA of a cluster owns fewer).
                    (256, 342, 160), (1024, 342, 192), (256, 342, 256),
                    (37, 150, 200), (3, 7, 129),
                    # Past u=256: clusters of 4 to 16 CTAs, U's fragments
                    # in shared memory, then (u=1024) through L1/L2.
                    (9, 40, 257), (37, 150, 300), (256, 342, 512),
                    (5, 23, 520), (64, 342, 1024),
                    # Past u=1024: one m-tile, one unit group a warp up to
                    # u=1279, the grid tile's bf16 step beyond.
                    (5, 23, 1279), (5, 23, 1280), (5, 23, 2049),
                    *WIDE_SHAPES))])
def test_avg_bf16_kernel_matches_plain(device, cell, batch, steps, units):
    """The bf16 kernels against their plain versions; up to u=128 they run
    the tensor-core tile, beyond it its cluster tile up to u=1279, and
    past it the grid tile's bf16 step."""
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(batch * units + steps, gates, batch, steps,
                                units, device)
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    plain = getattr(rnn, f"{cell}_avg_plain")
    assert cuda_rnn.avg_bf16_tile(cell, units) == (
        "mma" if units <= 128 else
        "cluster" if units <= cuda_rnn.BF16_CLUSTER_MAX_UNITS else "grid")
    launches = cuda_rnn.LAUNCHES.get(f"{cell}_avg_bf16")
    avg, hidden = kernel(params, codes, torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_rnn.LAUNCHES.get(f"{cell}_avg_bf16") == launches + 1
    want_avg, want_hidden = plain(params, codes, torch.bfloat16)
    assert avg.dtype == hidden.dtype == torch.bfloat16
    torch.testing.assert_close(avg.float(), want_avg.float(),
                               atol=BF16_ATOL, rtol=0)
    torch.testing.assert_close(hidden.float(), want_hidden.float(),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", [60, 128, 200, 256])
def test_avg_bf16_rows_independent_of_batch(device, cell, units):
    """A row's bf16 bits depend only on its own codes and the weights: 7
    windows alone (one CTA, one m-tile) and inside a batch of 1024 at
    offset 501 (other CTAs, other places in the tile) give identical bits;
    the sharded engine's bit-for-bit tracks rest on this."""
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(units + gates, gates, 1024, 342, units,
                                device)
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    alone = kernel(params, codes[501:508].contiguous(), torch.bfloat16)
    inside = kernel(params, codes, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], inside[0][501:508])
    assert torch.equal(alone[1], inside[1][501:508])


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", [160, 256, 300, 512, 1024, 2048, 4096])
def test_avg_bf16_cluster_window_bits(device, cell, units):
    """On the cluster tile (up to u=1279; the grid tile at u=2048 and
    4096) a window's bf16 bits are the same alone, inside a batch of 256 and at
    another place in that batch (other clusters, another row of the
    m-tile), and a second launch equals the first."""
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(units * gates, gates, 256, 342, units,
                                device)
    codes[200] = codes[13]
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    alone = kernel(params, codes[13:14].contiguous(), torch.bfloat16)
    inside = kernel(params, codes, torch.bfloat16)
    again = kernel(params, codes, torch.bfloat16)
    torch.cuda.synchronize()
    for got, want in zip(alone, inside):
        assert torch.equal(got[0], want[13])
        assert torch.equal(got[0], want[200])
    for a, b in zip(inside, again):
        assert torch.equal(a, b)


def test_avg_bf16_tile_by_width(device):
    """The tile of each width: the tensor-core tile up to u=128 (one CTA a
    window, at most 8), its cluster tile up to u=1279, the grid tile
    beyond (no cluster; the launch runs it).  A cluster has 2 CTAs where
    half of U's fragments fit a CTA's shared memory at 8 windows (the GRU
    up to u=256, the LSTM up to u=224), else 4; a CTA takes 16 windows
    where two m-tiles fit, else 8 (the H100's 227 KB a block); past
    u=1024 16 CTAs of one m-tile holding only their windows' rows of h: 8
    windows at u=1279."""
    cases = {"gru": [(240, 2, 16), (241, 2, 8), (256, 2, 8), (1279, 16, 8)],
             "lstm": [(208, 2, 16), (209, 2, 8), (224, 2, 8), (225, 4, 16),
                      (256, 4, 16), (1279, 16, 8)]}
    for cell, wide in cases.items():
        for units, tile, cluster, most in (
                [(1, "mma", 1, 8), (60, "mma", 1, 8), (128, "mma", 1, 8),
                 (129, "cluster", 2, 16)]
                + [(units, "cluster", c, m) for units, c, m in wide]):
            assert cuda_rnn.avg_bf16_tile(cell, units) == tile
            assert cuda_rnn.avg_bf16_cluster(cell, units) == cluster
            assert cuda_rnn.avg_tile(cell, 10 ** 6, units, None,
                                     torch.bfloat16)[0] == most
        for units in (1280, 2048, 2049, 4096, 4097):
            assert cuda_rnn.avg_bf16_tile(cell, units) == "grid"
            assert cuda_rnn.avg_bf16_cluster(cell, units) == 1
        with pytest.raises(ValueError, match="u=0"):
            cuda_rnn.avg_bf16_tile(cell, 0)
    params, codes = random_case(3, 3, 2, 3, 2049, device)
    launches = cuda_rnn.LAUNCHES.get("gru_avg_grid_bf16")
    avg, _ = cuda_rnn.gru_avg(params, codes, torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_rnn.LAUNCHES.get("gru_avg_grid_bf16") == launches + 1
    assert avg.dtype == torch.bfloat16


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", [129, 200, 256, 300, 512, 520, 1024,
                                   1025, 2048, 4096, 768, 1023])
def test_avg_cluster_window_bits(device, cell, units):
    """On the float32 cluster and stationary tiles (up to u=1024; the grid
    tile past it) a window's bits are the same alone, inside a batch of 64
    and at another place in it (other clusters, another lane of a group;
    another row block of the stationary tile, another row of the grid's
    row block), and a second launch equals the first."""
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(units + gates, gates, 64, 150, units,
                                device)
    codes[50] = codes[13]
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    alone = kernel(params, codes[13:14].contiguous())
    inside = kernel(params, codes)
    again = kernel(params, codes)
    torch.cuda.synchronize()
    for got, want in zip(alone, inside):
        assert torch.equal(got[0], want[13])
        assert torch.equal(got[0], want[50])
    for a, b in zip(inside, again):
        assert torch.equal(a, b)


# The float32 stationary tile (rows 1 and 2 from
# cuda_rnn.STATIONARY_MIN_UNITS to the ceiling; forced at every width
# here): widths either side of its variants' shapes, ragged over the CTAs
# (u=300: 3 units a CTA of 100; u=520: 4 of 130; u=1023: 8, the last 7),
# and (batch, T) from one window to the CLI's 256 at ragged T.
STATIONARY_UNITS = (257, 300, 512, 520, 768, 1023, 1024)
STATIONARY_BATCHES = ((1, 1), (5, 23), (37, 150), (64, 23), (256, 23))


def run_stationary(cell, params, codes, variant=-1):
    """``cell``'s fused row on the stationary tile at any width it takes
    (``variant`` -1: the library's)."""
    return cuda_rnn._launch(f"{cell}_avg", 4 if cell == "lstm" else 3,
                            params, codes, stationary=True, variant=variant)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", STATIONARY_UNITS)
@pytest.mark.parametrize("batch,steps", STATIONARY_BATCHES)
def test_stationary_matches_plain(device, cell, batch, steps, units):
    """The stationary tile against the plain version at 1e-5 on both
    outputs; one launch counted under the row's name and the tile's, no
    plain version run."""
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(batch + steps + units, gates, batch, steps,
                                units, device)
    launches = cuda_rnn.LAUNCHES.snapshot()
    plain_calls = rnn.PLAIN_CALLS.snapshot()
    avg, hidden = run_stationary(cell, params, codes)
    torch.cuda.synchronize()
    now = cuda_rnn.LAUNCHES.snapshot()
    for name in (f"{cell}_avg", f"{cell}_avg_stationary"):
        assert now.get(name, 0) == launches.get(name, 0) + 1
    assert rnn.PLAIN_CALLS.snapshot() == plain_calls
    want_avg, want_hidden = getattr(rnn, f"{cell}_avg_plain")(params, codes)
    torch.testing.assert_close(avg, want_avg, atol=ATOL, rtol=0)
    torch.testing.assert_close(hidden, want_hidden, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", [300, 768, 1024])
def test_stationary_variants_give_the_same_bits(device, cell, units):
    """Each variant of the stationary tile (2 or 4 windows a lane group,
    1 or 2 units a lane) gives the library's choice's bits, at 64 windows
    and at 5: the variant changes which thread owns a sum, not its
    order."""
    gates = 4 if cell == "lstm" else 3
    for batch, steps in ((64, 40), (5, 23)):
        params, codes = random_case(units + batch, gates, batch, steps,
                                    units, device)
        want = run_stationary(cell, params, codes)
        for variant in range(3):
            got = run_stationary(cell, params, codes, variant)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                batch, variant)


def stationary_digests(device) -> dict:
    """sha256 of the stationary tile's outputs (avg then hidden) for each
    cell at :data:`STATIONARY_DIGEST_SHAPES`, inputs from
    :func:`random_case`'s seed."""
    digests = {}
    for cell in ("gru", "lstm"):
        gates = 4 if cell == "lstm" else 3
        for batch, steps, units in STATIONARY_DIGEST_SHAPES:
            params, codes = random_case(units + batch + steps, gates, batch,
                                        steps, units, device)
            got = run_stationary(cell, params, codes)
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for out in got:
                digest.update(out.cpu().numpy().tobytes())
            digests[f"{cell} {batch}x{steps}x{units}"] = digest.hexdigest()
    return digests


# (batch, T, u) of the digests, on the stationary route: ragged over its
# CTAs (u=385: the last of 129 owns one unit of 3; u=1023: the last of 128
# owns 7 of 8) and over the cluster tile's 16 CTAs (u=520: 33 units a CTA).
STATIONARY_DIGEST_SHAPES = ((37, 12, 385), (5, 23, 520), (3, 9, 1023))
# The same digests of the float32 cluster tile (AvgClusterKernel on 16
# CTAs, U through L1/L2) as it ran on an NVIDIA H100 80GB HBM3 before the
# stationary tile took its widths.
CLUSTER_TILE_DIGESTS = {
    "gru 37x12x385":
        "d95ecd49a3132121ff8f55e13f032b88c1d36ff7e5c15ff6d320e5a10694f048",
    "gru 5x23x520":
        "fa6440d1d6b3a52c0014347b188e5eae2132410f6aa6a1b332f7592290b89d42",
    "gru 3x9x1023":
        "d50167c29b2a53112a5494e15b33e9afd6a49aa1edc916b4376fbdd996e9ab74",
    "lstm 37x12x385":
        "c73514c55c5ab86c962ea66ff961ca4858f6d296901eea7acb5f709e5aebfbb7",
    "lstm 5x23x520":
        "a7d4326f327cff75694265035aeb7126f7ea775c47f10ee4b5ab5d4856427930",
    "lstm 3x9x1023":
        "d4ce9b1825a0bb21e198ff0446457bf468095cd94ab426716a8dd1890cf9af73"}


def test_stationary_bits_are_the_cluster_tiles(device):
    """The stationary tile sums each unit in the cluster tile's order
    (four k-slices, then the butterfly), so its outputs are the cluster
    tile's bit for bit."""
    assert stationary_digests(device) == CLUSTER_TILE_DIGESTS


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stationary_under_capture(device, cell):
    """On its route the stationary tile's one cooperative launch (and the
    wrapper's zeroed scratch, from the graph's pool) is captured into a
    CUDA graph; a replay on new codes equals an eager call bit for bit."""
    gates = 4 if cell == "lstm" else 3
    units = cuda_rnn.CLUSTER_MAX_UNITS
    assert cuda_rnn.avg_tile_name(cell, units) == "stationary"
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    params, codes = random_case(11, gates, 5, 23, units, device)
    static = codes.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        kernel(params, static)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel(params, static)
    other = random_case(12, gates, 5, 23, units, device)[1]
    static.copy_(other)
    graph.replay()
    eager = kernel(params, other)
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stationary_layout_holds_every_window(device, cell):
    """The library's stationary layout at each width of its route: at most
    one CTA an SM of the card (every CTA resident: the launch is
    cooperative), its CTAs cover every unit and its row blocks every
    window, its shared memory within the card's opt-in; the variant of 2
    windows a group up to 8 windows; ``avg_tile`` gives every window to
    each of the layout's CTAs."""
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    for units in (cuda_rnn.STATIONARY_MIN_UNITS, 520, 768,
                  cuda_rnn.CLUSTER_MAX_UNITS):
        for batch in (1, 5, 37, 64, 256, 1024):
            lay = cuda_rnn.stationary_layout(cell, batch, units)
            assert lay["ctas"] <= sms
            assert lay["ctas"] * lay["units_a_cta"] >= units
            assert lay["windows_a_block"] * lay["blocks"] >= batch
            assert lay["threads"] <= 512 and lay["stages"] >= 2
            assert lay["width"] % 64 == 0 and lay["width"] >= units
            if batch <= 8:
                assert lay["variant"] == 0
            assert cuda_rnn.avg_tile(cell, batch, units) == (batch,
                                                            lay["ctas"])
    with pytest.raises(ValueError, match="u=0"):
        cuda_rnn.stationary_layout(cell, 1, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avg_layout_matches_library(device, dtype):
    """``cuda_rnn.avg_layout`` at every width its cluster and stationary
    tiles take (1-1024 in float32, 1-1279 in bfloat16) on this card and
    past them: its tile (pure Python, from the width) agrees with the
    library's CTAs a cluster (one CTA a window up to u=128, past it a
    cluster: in float32 8 CTAs with U in shared memory up to u=256, 16
    reading it through L1/L2 beyond, up to the stationary tile's
    narrowest width, from which no cluster, each CTA's slice of U in
    shared memory and no cap of windows (every CTA serves every window);
    in bfloat16 2 to 16 CTAs, the library's own tile; past them the grid
    tile's library: no cluster, 16 windows a CTA in float32 and 64 in
    bfloat16 (the tensor-core step's 128 rows), tiles of U through L2),
    and the library refuses u=0."""
    ceiling = (cuda_rnn.BF16_CLUSTER_MAX_UNITS if dtype == torch.bfloat16
               else cuda_rnn.CLUSTER_MAX_UNITS)
    for cell in ("gru", "lstm"):
        for units in (ceiling + 1, 4096, 4097, 5000, 8192, 26800):
            assert cuda_rnn.avg_layout(cell, units, dtype) == {
                "tile": "grid", "cluster": 1, "u_in": "L2",
                "max_windows": 16 if dtype == torch.float32 else 64}
        for units in range(1, ceiling + 1):
            layout = cuda_rnn.avg_layout(cell, units, dtype)
            assert (layout["cluster"] > 1) == (layout["tile"] == "cluster")
            if dtype == torch.bfloat16:
                assert layout["tile"] == cuda_rnn.avg_bf16_tile(cell, units)
                assert layout["cluster"] in (1, 2, 4, 8, 16), units
            elif units >= cuda_rnn.STATIONARY_MIN_UNITS:
                assert layout == {"tile": "stationary", "cluster": 1,
                                  "u_in": "shared", "max_windows": None}, units
            elif units > 128:
                assert (layout["cluster"], layout["u_in"]) == (
                    (8, "shared") if units <= 256 else (16, "L1/L2")), units
            else:
                assert layout["u_in"] == ("registers" if units <= 64
                                          else "L1/L2"), units
        with pytest.raises(ValueError, match="u=0"):
            cuda_rnn._library_layout(cell, 0, dtype)


# The grid tile's rows (past the cluster tiles): (kind, dtype) with kind "gru",
# "lstm" (the fused rows) or "seq" (the scan route's GRU).
GRID_ROWS = [(kind, dtype) for kind in ("gru", "lstm", "seq")
             for dtype in (torch.float32, torch.bfloat16)]
# One window, a ragged batch, widths past the cluster tiles (ragged over
# the grid's 32-unit blocks but u=8192), T <= 32.
GRID_SHAPES = [(1, 32, 4097), (5, 23, 5000), (3, 17, 8192)]


def run_grid_row(kind, dtype, params, inputs, grid=False):
    """The row ``kind`` through its wrapper (``grid=True``: forced onto
    the grid tile) and its plain version's function."""
    if kind == "seq":
        if grid:
            got = cuda_rnn._launch_seq(params, inputs, grid=True)
        else:
            got = cuda_rnn.gru_apply(params, inputs)
        return got, rnn.gru_apply
    plain = getattr(rnn, f"{kind}_avg_plain")
    if grid:
        gates = 4 if kind == "lstm" else 3
        return cuda_rnn._launch(f"{kind}_avg", gates, params, inputs, dtype,
                                grid=True), plain
    return getattr(cuda_rnn, f"{kind}_avg")(params, inputs, dtype), plain


def grid_case(kind, dtype, batch, steps, units, device):
    if kind == "seq":
        return random_seq_case(batch, steps, units, dtype, device)
    gates = 4 if kind == "lstm" else 3
    return random_case(batch * steps + units, gates, batch, steps, units,
                       device)


def grid_names(kind, dtype):
    if kind == "seq":
        return "gru_seq", "gru_seq_grid"
    suffix = rnn.dtype_suffix(dtype)
    return f"{kind}_avg{suffix}", f"{kind}_avg_grid{suffix}"


@pytest.mark.parametrize("kind,dtype", GRID_ROWS)
@pytest.mark.parametrize("batch,steps,units", GRID_SHAPES)
def test_grid_matches_plain(device, kind, dtype, batch, steps, units):
    """Past u=4096 each inference row runs the grid tile (its launch
    counted under the row's name and the grid's, no plain version run)
    and agrees with its plain version: atol 1e-5 in float32, 2e-2 in
    bfloat16 (as on the cluster tiles)."""
    params, inputs = grid_case(kind, dtype, batch, steps, units, device)
    launches = cuda_rnn.LAUNCHES.snapshot()
    plain_calls = rnn.PLAIN_CALLS.snapshot()
    got, plain = run_grid_row(kind, dtype, params, inputs)
    torch.cuda.synchronize()
    now = cuda_rnn.LAUNCHES.snapshot()
    for name in grid_names(kind, dtype):
        assert now.get(name, 0) == launches.get(name, 0) + 1, name
    assert rnn.PLAIN_CALLS.snapshot() == plain_calls
    want = (plain(params, inputs) if kind == "seq"
            else plain(params, inputs, dtype))
    atol = ATOL if dtype == torch.float32 else BF16_ATOL
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("kind,units", [("gru", 26800), ("lstm", 23200),
                                        ("seq", 26800)])
def test_grid_past_2_31_elements(device, kind, units):
    """Where U holds more than 2^31 elements (g u^2: GRU u=26,800, LSTM
    u=23,200), B=2, T=4, float32: the grid tile against the plain version
    at atol 1e-5 (64-bit offsets into U, h and the outputs)."""
    gates = 4 if kind == "lstm" else 3
    assert gates * units * units > 2 ** 31
    gen = torch.Generator(device=device).manual_seed(units)
    width = gates * units
    params = {
        "kernel": torch.randn(5, width, generator=gen, device=device) * 0.5,
        "recurrent": torch.randn(units, width, generator=gen,
                                 device=device) * units ** -0.5,
        "bias": torch.randn(*((width,) if gates == 4 else (2, width)),
                            generator=gen, device=device) * 0.3}
    if kind == "seq":
        inputs = torch.rand(2, 4, 5, generator=gen, device=device)
    else:
        inputs = torch.randint(0, 6, (2, 4), generator=gen, device=device,
                               dtype=torch.int8)
    got, plain = run_grid_row(kind, torch.float32, params, inputs)
    torch.cuda.synchronize()
    want = plain(params, inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind,dtype", GRID_ROWS)
def test_grid_window_bits(device, kind, dtype):
    """On the grid tile a window's (row 7: a row's) bits are the same alone,
    inside a batch of 37 (another row block) and at another place in it,
    and a second launch equals the first (each sum runs in an order fixed
    by u)."""
    params, inputs = grid_case(kind, dtype, 37, 20, 4097, device)
    inputs[30] = inputs[13]
    alone = run_grid_row(kind, dtype, params,
                         inputs[13:14].contiguous())[0]
    inside = run_grid_row(kind, dtype, params, inputs)[0]
    again = run_grid_row(kind, dtype, params, inputs)[0]
    torch.cuda.synchronize()
    for got, want in zip(alone, inside):
        assert torch.equal(got[0], want[13])
        assert torch.equal(got[0], want[30])
    for a, b in zip(inside, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,dtype", GRID_ROWS)
def test_grid_below_ceiling_matches_cluster_route(device, kind, dtype):
    """The grid tile forced below its route's widths (as
    ``tools/avg_tile_sweep.py --grid`` times it beside the cluster tiles)
    agrees with the plain version at u=129 and the ragged u=300; the
    routing there is unchanged (the cluster tile runs)."""
    for units in (129, 300):
        params, inputs = grid_case(kind, dtype, 5, 9, units, device)
        got, plain = run_grid_row(kind, dtype, params, inputs, grid=True)
        routed = run_grid_row(kind, dtype, params, inputs)[0]
        torch.cuda.synchronize()
        want = (plain(params, inputs) if kind == "seq"
                else plain(params, inputs, dtype))
        atol = ATOL if dtype == torch.float32 else BF16_ATOL
        for g, r, w in zip(got, routed, want):
            torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                       rtol=0)
            torch.testing.assert_close(r.float(), w.float(), atol=atol,
                                       rtol=0)


@pytest.mark.parametrize("kind,units,grid", [
    ("gru", 1279, False), ("gru", 1280, True), ("lstm", 1279, False),
    ("lstm", 1280, True), ("seq", 767, False), ("seq", 768, True)])
def test_bf16_route_boundary(device, kind, units, grid):
    """Either side of the bf16 routes (``BF16_CLUSTER_MAX_UNITS`` for rows
    1b, 2b; ``SEQ_BF16_CLUSTER_MAX_UNITS`` for row 7 with bf16 IO): the
    cluster tile at the route width, the grid tile's bf16 step one past
    it (counted under the grid's name too), each within 2e-2 of the plain
    version."""
    assert units == grid + (cuda_rnn.SEQ_BF16_CLUSTER_MAX_UNITS
                            if kind == "seq"
                            else cuda_rnn.BF16_CLUSTER_MAX_UNITS)
    params, inputs = grid_case(kind, torch.bfloat16, 5, 23, units, device)
    launches = cuda_rnn.LAUNCHES.snapshot()
    got, plain = run_grid_row(kind, torch.bfloat16, params, inputs)
    torch.cuda.synchronize()
    now = cuda_rnn.LAUNCHES.snapshot()
    row_name, grid_name = grid_names(kind, torch.bfloat16)
    assert now.get(row_name, 0) == launches.get(row_name, 0) + 1
    assert now.get(grid_name, 0) == launches.get(grid_name, 0) + int(grid)
    want = (plain(params, inputs) if kind == "seq"
            else plain(params, inputs, torch.bfloat16))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=BF16_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["gru", "seq"])
def test_grid_under_capture(device, kind):
    """The grid tile's T launches are captured into a CUDA graph (the
    wrapper's zeroed buffers from the graph's pool); a replay on new
    inputs equals an eager call bit for bit."""
    params, inputs = grid_case(kind, torch.float32, 4, 9, 4100, device)
    static = inputs.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run_grid_row(kind, torch.float32, params, static)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run_grid_row(kind, torch.float32, params, static)[0]
    other = grid_case(kind, torch.float32, 4, 9, 4100, device)[1]
    other = other.flip(0).contiguous()
    static.copy_(other)
    graph.replay()
    eager = run_grid_row(kind, torch.float32, params, other)[0]
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_grid_bf16_layout_matches_python(device):
    """The bf16 step's layout from the library (``dg_grid_layout``: 128
    rows a CTA, 32 units or 16 by the grid's CTAs against the card's SMs,
    k 32 a stage, no k-slices, a warp a 32 x 16 tile, 4 stages) is what
    ``grid_mma_units`` and ``grid_tile`` compute in Python."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows, units in ((10, 2049), (128, 2049), (128, 4608), (512, 4608),
                        (32, 8192), (2048, 1025), (4, 26800)):
        unit_block = cuda_rnn.grid_mma_units(rows, units, sms)
        assert cuda_rnn._grid_layout(torch.bfloat16, rows, units) == [
            128, unit_block, 32, 1, 32 * 4 * unit_block // 16, 4, 32, 16]
        assert cuda_rnn.grid_tile(rows, units, torch.bfloat16) == (
            min(rows, 128),
            -(-rows // 128) * (-(-units // 32) * 32 // unit_block))
    with pytest.raises(ValueError, match="u=0"):
        cuda_rnn._grid_layout(torch.bfloat16, 1, 0)


def f32_grid_digests(device) -> dict:
    """sha256 of the float32 grid rows' outputs (rows 1, 2: avg then
    hidden; row 7: seq then last) at B=3, T=9, u=1100, inputs from
    :func:`grid_case`'s seed."""
    digests = {}
    for kind in ("gru", "lstm", "seq"):
        params, inputs = grid_case(kind, torch.float32, 3, 9, 1100, device)
        got = run_grid_row(kind, torch.float32, params, inputs)[0]
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for out in got:
            digest.update(out.cpu().numpy().tobytes())
        digests[kind] = digest.hexdigest()
    return digests


# f32_grid_digests of the float32 step (GridStepKernel) as it ran on an
# NVIDIA H100 80GB HBM3 before the bf16 step moved to the tensor cores.
F32_GRID_DIGESTS = {
    "gru": "f7db520df5ecc2477a54d46ccf89e6253418b0c228ef9422fb6beff6af67c6ef",
    "lstm": "bb175774d7ab4eb906692c002a6f04f339f2ee024d626ec5a2952c9956549e34",
    "seq": "98fcad3fb4a47e470ab8522d1ba11622e6170cce96950b4b6e18eb0e8f8cdae6"}


def test_grid_f32_bits_unchanged(device):
    """The float32 grid rows give the bits they gave before the bf16 step
    got a kernel of its own (the float32 step's machine code is the
    same)."""
    assert f32_grid_digests(device) == F32_GRID_DIGESTS


def test_grid_shape_matches_python(device):
    """The grid tile's layout in Python (``GRID_ROWS``, ``GRID_UNITS``,
    ``grid_tile``) is the library's (``dg_grid_layout``,
    ``dg_grid_shape``)."""
    layout = cuda_rnn._grid_layout()
    assert layout[:2] == [cuda_rnn.GRID_ROWS, cuda_rnn.GRID_UNITS]
    lib = _build.load_kernels("rnn_grid")
    shape = (ctypes.c_longlong * 4)()
    for rows, units in ((1, 4097), (74, 5000), (2048, 8192), (4, 26800)):
        assert lib.dg_grid_shape(rows, units, shape) == 1
        assert shape[2] * shape[3] == cuda_rnn.grid_tile(rows, units)[1]
        assert shape[0] == -(-units // 32) * 32
        assert shape[1] == -(-rows // 32) * 32
    assert lib.dg_grid_shape(1, 0, shape) == 0


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("batch,steps,units", GRID_SHAPES)
def test_grid_train_matches_plain(device, cell, masked, batch, steps,
                                  units):
    """Past u=4096 the training kernels run the grid tile (each call
    counted under the row's name and the grid's) and agree with their
    plain versions as on the other tiles: the forward at atol 1e-5, the
    gradients within 1e-4 of their largest magnitude, a second backward
    bit for bit."""
    launches = cuda_rnn.LAUNCHES.snapshot()
    check_train_pair(device, cell, masked, batch, steps, units)
    now = cuda_rnn.LAUNCHES.snapshot()
    for kind, count in (("fwd", 1), ("bwd", 2)):
        name = f"{cell}_train_{kind}_grid"
        assert now.get(name, 0) == launches.get(name, 0) + count, name


def grid_train_run(cell, params, codes, masks, d_avg, d_hid):
    """The training forward's outputs and the backward recurrence's gate
    cotangents of one call."""
    out = cuda_rnn.train_fwd(cell, params, codes, masks)
    return out + cuda_rnn._bwd_recurrence(cell, params, codes, masks,
                                          tuple(out[2:]), d_avg, d_hid)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_grid_train_bits(device, cell):
    """On the grid tile a window's training forward and gate cotangents
    have the same bits alone, inside a batch of 19 (another row block) and
    repeated, and a captured call (its launches in a CUDA graph, buffers
    from the graph's pool) replayed on new inputs equals an eager call bit
    for bit."""
    gates = 4 if cell == "lstm" else 3
    batch, steps, units = 19, 20, 4100
    params, codes = random_case(units, gates, batch, steps, units, device)
    masks = random_masks(units, gates, batch, device)
    rng = np.random.default_rng(units)
    d_avg = torch.tensor(rng.normal(size=(batch, steps, units)),
                         dtype=torch.float32, device=device)
    d_hid = torch.tensor(rng.normal(size=(batch, units)),
                         dtype=torch.float32, device=device)

    def rows(lo, hi):
        sub_masks = masks.view(gates, 2, batch, 5)[:, :, lo:hi].reshape(
            gates, 2 * (hi - lo), 5).contiguous()
        return (codes[lo:hi].contiguous(), sub_masks,
                d_avg[lo:hi].contiguous(), d_hid[lo:hi].contiguous())

    full = grid_train_run(cell, params, *rows(0, batch))
    again = grid_train_run(cell, params, codes, masks, d_avg, d_hid)
    alone = grid_train_run(cell, params, *rows(11, 12))
    torch.cuda.synchronize()
    for a, b in zip(full, again):
        assert torch.equal(a, b)
    assert torch.equal(alone[0], full[0][11:12])
    assert torch.equal(alone[1], full[1][11:12])
    for got, want in zip(alone[2:], full[2:]):
        assert torch.equal(got, want[[11, batch + 11]])

    static = [t.clone() for t in rows(0, 4)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        grid_train_run(cell, params, *static)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = grid_train_run(cell, params, *static)
    other = rows(5, 9)
    for dst, src in zip(static, other):
        dst.copy_(src)
    graph.replay()
    eager = grid_train_run(cell, params, *other)
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_grid_bwd_blocks_keep_bits(device, cell):
    """The grid's backward step (B) given each count of blocks of 32 units
    a CTA (1-4) gives the same gate cotangents bit for bit at B=19,
    u=3001 (a ragged last CTA at every count); 0 and 5 blocks are
    refused; ``train_tile`` reports the count ``grid_bwd_groups`` picks
    on this card."""
    gates = 4 if cell == "lstm" else 3
    batch, steps, units = 19, 6, 3001
    params, codes = random_case(units, gates, batch, steps, units, device)
    masks = random_masks(units, gates, batch, device)
    rng = np.random.default_rng(units + 3)
    d_avg = torch.tensor(rng.normal(size=(batch, steps, units)),
                         dtype=torch.float32, device=device)
    d_hid = torch.tensor(rng.normal(size=(batch, units)),
                         dtype=torch.float32, device=device)
    seqs = tuple(cuda_rnn.train_fwd(cell, params, codes, masks)[2:])

    def cotangents(groups):
        return cuda_rnn._bwd_recurrence(cell, params, codes, masks, seqs,
                                        d_avg, d_hid, groups=groups)

    runs = [cotangents(groups) for groups in (1, 2, 3, 4)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for got, first in zip(run, runs[0]):
            assert torch.equal(got, first)
    for groups in (0, 5):
        with pytest.raises(RuntimeError, match="invalid argument"):
            cotangents(groups)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = cuda_rnn.train_tile(cell, batch, units, steps)
    assert tile["bwd_units_a_cta"] == 32 * cuda_rnn.grid_bwd_groups(
        2 * batch, units, sms)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_grid_bwd_bits_by_unit_block(device, cell):
    """The grid's backward step sums each (row, unit) in an order fixed by
    u, whatever its blocks of units a CTA: at B=128, u=4097 (4 blocks a
    CTA on 132 SMs, the last CTA ragged) two backward runs give the same
    gradients and cotangents bit for bit, and a window alone (one row
    block, 1 block a CTA) its rows' cotangents in the batch."""
    gates = 4 if cell == "lstm" else 3
    batch, steps, units = 128, 8, 4097
    params, codes = random_case(units + 1, gates, batch, steps, units, device)
    masks = random_masks(units, gates, batch, device)
    rng = np.random.default_rng(units + 2)
    d_avg = torch.tensor(rng.normal(size=(batch, steps, units)),
                         dtype=torch.float32, device=device)
    d_hid = torch.tensor(rng.normal(size=(batch, units)),
                         dtype=torch.float32, device=device)
    out = cuda_rnn.train_fwd(cell, params, codes, masks)
    seqs = tuple(out[2:])
    grads = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                               d_hid)
    again = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                               d_hid)
    cot = cuda_rnn._bwd_recurrence(cell, params, codes, masks, seqs, d_avg,
                                   d_hid)
    w = 41
    sub_masks = masks.view(gates, 2, batch, 5)[:, :, w:w + 1].reshape(
        gates, 2, 5).contiguous()
    alone = cuda_rnn._bwd_recurrence(
        cell, params, codes[w:w + 1].contiguous(), sub_masks,
        tuple(q[[w, batch + w]].contiguous() for q in seqs),
        d_avg[w:w + 1].contiguous(), d_hid[w:w + 1].contiguous())
    torch.cuda.synchronize()
    for g, a in zip(grads, again):
        assert torch.equal(g, a)
    for got, full in zip(alone, cot):
        assert torch.equal(got, full[[w, batch + w]])


@pytest.mark.parametrize("cell,units", [("gru", 26800), ("lstm", 23200)])
def test_grid_train_past_2_31_elements(device, cell, units):
    """Where U (g u^2) and the reduction's partials ((u + 7) g u) hold more
    than 2^31 elements, B=2, T=4, masks at rate 0.0928: the grid tile's
    training forward and gradients against the plain versions, run after
    the port's buffers are freed (atol 1e-5; 1e-4 of each gradient's
    largest magnitude)."""
    gates = 4 if cell == "lstm" else 3
    batch, steps = 2, 4
    assert min(gates * units * units, (units + 7) * gates * units) > 2 ** 31
    gen = torch.Generator(device=device).manual_seed(units)
    width = gates * units
    params = {
        "kernel": torch.randn(5, width, generator=gen, device=device) * 0.5,
        "recurrent": torch.randn(units, width, generator=gen,
                                 device=device) * units ** -0.5,
        "bias": torch.randn(*((width,) if gates == 4 else (2, width)),
                            generator=gen, device=device) * 0.3}
    codes = torch.randint(0, 6, (batch, steps), generator=gen, device=device,
                          dtype=torch.int8)
    masks = random_masks(units, gates, batch, device)
    d_avg = torch.randn(batch, steps, units, generator=gen, device=device)
    d_hid = torch.randn(batch, units, generator=gen, device=device)
    got = cuda_rnn.train_fwd(cell, params, codes, masks)
    grads = cuda_rnn.train_bwd(cell, params, codes, masks, tuple(got[2:]),
                               d_avg, d_hid)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    plain_fwd, plain_bwd = cuda_rnn._PLAIN[cell]
    want = plain_fwd(params, codes, masks)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    assert_grads_close(grads, plain_bwd(params, codes, masks, *want[2:],
                                        d_avg, d_hid))


@pytest.mark.parametrize("name", ["gru_att", "lstm"])
def test_engine_scan_on_card_matches_cpu(device, name):
    """The scan route on the card (the ``gru_seq`` kernel for GRU) against
    the same route on the CPU: classes equal, max probability to 1e-5."""
    config, params = load_model(os.path.join(TORCH_FIXDIR, f"{name}.npz"))
    codes = np.random.default_rng(4).integers(0, 5, 20000).astype(np.int8)
    results = []
    for dev in (device, "cpu"):
        model = DeepGRPModel.from_params(config, params, dev)
        launches = cuda_rnn.LAUNCHES.get("gru_seq")
        results.append(PredictionEngine(
            model, batch_size=64, step_size=50,
            rnn_kernel="scan").predict_scored(codes))
        if dev == device and config.rnn == "GRU":
            assert cuda_rnn.LAUNCHES.get("gru_seq") > launches
    (got_c, got_p), (want_c, want_p) = results
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, atol=ATOL)


@pytest.mark.parametrize("route", ["fused", "scan"])
def test_engine_bf16_on_card_matches_cpu(device, route):
    """The bf16 fast mode on the card against the same mode on the CPU:
    classes agree on >= 99.9 % of positions, max probability to 2e-2."""
    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    codes = np.random.default_rng(5).integers(0, 5, 20000).astype(np.int8)
    results = []
    for dev in (device, "cpu"):
        model = DeepGRPModel.from_params(config, params, dev)
        results.append(PredictionEngine(
            model, batch_size=64, step_size=50, compute_dtype=torch.bfloat16,
            rnn_kernel=route).predict_scored(codes))
    (got_c, got_p), (want_c, want_p) = results
    assert (got_c == want_c).mean() >= 0.999
    np.testing.assert_allclose(got_p, want_p, atol=BF16_ATOL)


def random_train_batch(seed, config, batch, device):
    """Code windows (with N and pad codes), one-hot labels and dropout
    masks of one training step, from a seed."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 6, size=(batch, config.vecsize)).astype(np.int8)
    labels = np.eye(config.n_classes, dtype=np.float32)[
        rng.integers(0, config.n_classes, (batch, config.vecsize))]
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(labels).to(device),
            random_masks(seed, config.gates, batch, device))


def assert_params_close(got, want):
    """Updated parameters within 1e-4 of each one's largest magnitude."""
    for key, value in want.items():
        err = (got[key].detach().cpu() - value.detach().cpu()).abs().max()
        assert err.item() <= 1e-4 * value.abs().max().item(), (key, err)


@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_scan_train_step_on_card_matches_fused(device, rnn_type, attention):
    """One scan-route step on the card (autograd through the plain loop,
    no kernel) against the fused step on the card (the training kernels)
    and against the scan step on the CPU, from the same parameters on the
    same windows and masks: losses at atol 1e-5, gradients within 1e-4 of
    their largest magnitude, updated parameters within 1e-4 of theirs."""
    from deepgrp_tpu_torch.train.training import step_loss

    options = Options(vecsize=60, units=16, batch_size=32, rnn=rnn_type,
                      attention=attention, dropout=0.0928)
    config = ModelConfig.from_options(options)
    params = init_params(config, torch.Generator().manual_seed(3))
    batch = random_train_batch(9, config, 32, "cpu")
    runs = {}
    for dev, fused in ((device, False), (device, True),
                       (torch.device("cpu"), False)):
        model = DeepGRPModel.from_params(config, params, dev)
        opt = get_optimizer(options, model.parameters())
        rnn.PLAIN_CALLS.reset()
        cuda_rnn.LAUNCHES.reset()
        opt.zero_grad()
        loss = step_loss(model, *(t.to(dev) for t in batch), fused=fused)
        loss.backward()
        grads = {k: v.grad.detach().cpu().clone()
                 for k, v in model.params().items()}
        opt.step()
        if dev.type == "cuda":
            assert rnn.PLAIN_CALLS.snapshot() == {}
            cell = "lstm" if rnn_type == "LSTM" else "gru"
            assert (cuda_rnn.LAUNCHES.get(f"{cell}_train_fwd")
                    == int(fused))
            assert cuda_rnn.LAUNCHES.get("gru_seq") == 0
        runs[(dev.type, fused)] = (loss.item(), grads, model.params())
    want_loss, want_grads, want_params = runs[("cuda", False)]
    for other in (("cuda", True), ("cpu", False)):
        loss, grads, updated = runs[other]
        assert abs(loss - want_loss) <= 1e-5, other
        for key, grad in grads.items():
            err = (grad - want_grads[key]).abs().max().item()
            assert err <= 1e-4 * want_grads[key].abs().max().item(), \
                (other, key, err)
        assert_params_close(updated, want_params)


@pytest.mark.parametrize("rnn_type,attention,optimizer", [
    ("GRU", True, "RMSprop"), ("LSTM", False, "Adam")])
def test_fleet_step_on_card_matches_cpu(device, rnn_type, attention,
                                        optimizer):
    """One fleet step of three trials (the second frozen) on the card
    (the training kernels) against the same step on the CPU (the plain
    versions): per-trial losses at atol 1e-5, updated parameters within
    1e-4 of their largest magnitude, the frozen trial's bit for bit."""
    from deepgrp_tpu_torch.hpo.vmapped import fleet_step
    from deepgrp_tpu_torch.train.optimizers import fleet_optimizer

    options = Options(vecsize=60, units=16, batch_size=32, rnn=rnn_type,
                      attention=attention, optimizer=optimizer)
    config = ModelConfig.from_options(options)
    hps = [{"learning_rate": lr, "momentum": m, "rho": r, "epsilon": e}
           for lr, m, r, e in ((1e-3, 0.9, 0.9, 1e-7), (5e-3, 0.5, 0.8, 1e-7),
                               (2e-3, 0.0, 0.95, 1e-6))]
    active = [True, False, True]
    initial = [init_params(config, torch.Generator().manual_seed(i))
               for i in range(3)]
    batches = [random_train_batch(20 + i, config, 32, "cpu")
               for i in range(3)]
    runs = {}
    for dev in (device, torch.device("cpu")):
        models = [DeepGRPModel.from_params(config, p, dev) for p in initial]
        opt = fleet_optimizer(optimizer, [(m.parameters(), hp)
                                          for m, hp in zip(models, hps)])
        rnn.PLAIN_CALLS.reset()
        cuda_rnn.LAUNCHES.reset()
        losses = fleet_step(models, opt, [tuple(t.to(dev) for t in b)
                                          for b in batches], active)
        if dev.type == "cuda":
            cell = "lstm" if rnn_type == "LSTM" else "gru"
            assert rnn.PLAIN_CALLS.snapshot() == {}
            assert cuda_rnn.LAUNCHES.get(f"{cell}_train_fwd") == 2
            assert cuda_rnn.LAUNCHES.get(f"{cell}_train_bwd") == 2
        assert losses[1] is None
        runs[dev.type] = ([None if l is None else l.item() for l in losses],
                          [m.params() for m in models])
    (card_losses, card), (cpu_losses, cpu) = runs["cuda"], runs["cpu"]
    for i in (0, 2):
        assert abs(card_losses[i] - cpu_losses[i]) <= 1e-5
        assert_params_close(card[i], cpu[i])
    for key, value in initial[1].items():
        assert torch.equal(card[1][key].detach().cpu(), value), key


def transform_shaped_scores(seed, n, repeat_frac):
    """A float track shaped like a trained model's MSS scores: confident
    background (-10 t) with stretches of one repeat class (+t), about
    ``repeat_frac`` of the positions, and 5 % unsure positions (p < 0.5,
    so t < 0) of any class."""
    rng = np.random.default_rng(seed)
    labels = np.zeros(n, np.int64)
    for start in rng.integers(0, n, max(1, int(n * repeat_frac / 200))):
        labels[start:start + int(rng.integers(20, 400))] = rng.integers(1, 5)
    unsure = rng.random(n) < 0.05
    labels[unsure] = rng.integers(0, 5, int(unsure.sum()))
    t = np.where(unsure, rng.uniform(-1.0, 1.0, n),
                 rng.uniform(2.0, np.log(99.0), n))
    return np.where(labels > 0, t, -10 * t), labels


@pytest.mark.parametrize("seed,n,repeat_frac,xdrop_len", [
    (0, 1 << 20, 0.05, 50), (1, 200000, 0.3, 50), (2, 5000, 0.5, 0),
    (3, 3, 1.0, 50)])
def test_mss_stack_matches_plain(device, seed, n, repeat_frac, xdrop_len):
    """``dg_mss_stack`` on the card equals its plain version on the same
    candidates, segment for segment (float64 adds and compares in the same
    order), and the whole device search equals the host library."""
    scores, labels = transform_shaped_scores(seed, n, repeat_frac)
    min_score, xdrop = mss.mss_thresholds(50, xdrop_len)
    track = torch.as_tensor(scores, device=device)
    cap = mss_device.run_capacity(mss_device.count_positive_runs(track))
    cand = mss_device.collapse_runs(track, cap)
    mss_device.LAUNCHES.reset()
    seg_s, seg_e, count = mss_device.mss_stack(cand, min_score, xdrop)
    torch.cuda.synchronize()
    assert mss_device.LAUNCHES.snapshot() == {"mss_stack": 1}
    plain = mss_device.mss_stack(
        mss_device.Candidates(*(t.cpu() for t in cand)), min_score, xdrop)
    assert int(count) == int(plain[2])
    assert int(count) > 0 or n < 100
    np.testing.assert_array_equal(seg_s.cpu().numpy(), plain[0].numpy())
    np.testing.assert_array_equal(seg_e.cpu().numpy(), plain[1].numpy())
    got, overflow = mss_device.mss_classes_device(
        track, torch.as_tensor(labels, device=device), 5, 50, xdrop_len,
        max_runs=cap)
    assert not bool(overflow)
    np.testing.assert_array_equal(
        got.cpu().numpy(), mss.find_mss_classes(scores, labels, 5, 50,
                                                xdrop_len))


def test_mss_stack_cuda_never_takes_plain(device, monkeypatch):
    """A CUDA tensor launches the kernel: the plain version is never
    called, on the stack scan or on the whole device route."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain stack scan ran for a CUDA tensor")

    monkeypatch.setattr(mss_device, "mss_stack_from_candidates", refuse)
    scores, labels = transform_shaped_scores(5, 50000, 0.05)
    classes = torch.as_tensor(labels.astype(np.int8), device=device)
    maxp = torch.full((50000,), 0.97, device=device)
    mss_device.LAUNCHES.reset()
    out = postprocess.apply_mss_on_device(classes, maxp, Options(), 5,
                                          50000)
    assert out.shape == (50000,)
    assert mss_device.LAUNCHES.snapshot() == {"mss_stack": 1}
    with pytest.raises(ValueError, match="int32/float64"):
        cand = mss_device.collapse_runs(torch.as_tensor(scores,
                                                        device=device), 64)
        mss_device.mss_stack(cand._replace(l_glob=cand.l_glob.float()),
                             1.0, 1.0)


@pytest.mark.parametrize("route", ["auto", "on", "off"])
def test_mss_routes_on_card_match_cpu(device, route):
    """Each route on the card gives the CPU's host-route classes on the
    ``gru_att`` fixture's records; the 3-shard ``auto`` too.  No route of
    a CUDA track runs the plain stack scan."""
    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    options = Options(vecsize=config.vecsize, batch_size=64, min_mss_len=50,
                      xdrop_len=50)
    codes = np.random.default_rng(11).integers(0, 5, 30000).astype(np.int8)
    cpu = PredictionEngine(DeepGRPModel.from_params(config, params, "cpu"),
                           batch_size=64, step_size=50)
    want = postprocess.predict_sequence(cpu, codes, options,
                                        device_mss="off")
    model = DeepGRPModel.from_params(config, params, device)
    for engine in (PredictionEngine(model, batch_size=64, step_size=50),
                   ShardedPredictionEngine(model, [device] * 3,
                                           batch_size=64, step_size=50)):
        mss_device.LAUNCHES.reset()
        got = postprocess.predict_sequence(engine, codes, options,
                                           device_mss=route)
        assert "mss_stack_plain" not in mss_device.LAUNCHES.snapshot()
        np.testing.assert_array_equal(np.asarray(got, np.int64),
                                      np.asarray(want, np.int64))


def test_api_engine_predict_on_card(device):
    """``engine.predict`` through ``create_model`` on the card equals
    ``PredictionEngine.predict`` on the card bit for bit (``dg_gru_avg``
    launched) and the CPU's merged track to 1e-5."""
    from deepgrp_tpu_torch.models.model import create_model
    from deepgrp_tpu_torch.predict.engine import predict
    from deepgrp_tpu_torch.train.sampler import codes_from_onehot_rows

    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    options = Options(vecsize=config.vecsize, units=config.units,
                      attention=config.attention)
    model = create_model(options)
    assert model.device.type == "cuda"
    rng = np.random.default_rng(5)
    onehot = np.eye(5, dtype=np.int8)[rng.integers(0, 5, 20000)].T.copy()
    shape = (onehot.shape[1], config.n_classes)
    cuda_rnn.LAUNCHES.reset()
    got = predict(model, params, onehot, shape, 50, batch_size=64)
    assert cuda_rnn.LAUNCHES.get("gru_avg") > 0
    loaded = DeepGRPModel.from_params(config, params, device)
    want = PredictionEngine(loaded, batch_size=64, step_size=50).predict(
        codes_from_onehot_rows(onehot))
    np.testing.assert_array_equal(got, want)
    cpu = predict(DeepGRPModel(config, "cpu"), params, onehot, shape, 50,
                  batch_size=64)
    np.testing.assert_allclose(got, cpu, atol=ATOL)


def test_train_h5_without_h5py_raises_at_once(device, tmp_path):
    """Where ``h5py`` is missing (the card's machine), ``train --modelfile
    m.h5`` raises ``ImportError`` naming it before it reads any input or
    trains."""
    try:
        import h5py  # noqa: F401
        pytest.skip("h5py is installed here")
    except ImportError:
        pass
    from deepgrp_tpu_torch import cli

    missing = [str(tmp_path / name) for name in ("p.toml", "a.npz",
                                                 "b.npz", "r.bed")]
    cuda_rnn.LAUNCHES.reset()
    with pytest.raises(ImportError, match="h5py"):
        cli.main(["train", *missing, "--logdir", str(tmp_path / "log"),
                  "--modelfile", str(tmp_path / "m.h5")])
    assert not cuda_rnn.LAUNCHES.snapshot()
    assert not list(tmp_path.iterdir())


# -- the optimization step as a captured CUDA graph ---------------------------


def repeat_data(seed, length=6000):
    """A chromosome's one-hot ``fwd`` and labels from a seed: class-1
    regions poly-A, class-2 regions poly-C, background random."""
    from deepgrp_tpu_torch.data.preprocess import Data

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length)
    truelbl = np.zeros((3, length), dtype=np.int8)
    for start in range(100, length - 300, 400):
        codes[start:start + 100] = 0
        truelbl[1, start:start + 100] = 1
        codes[start + 200:start + 260] = 1
        truelbl[2, start + 200:start + 260] = 1
    truelbl[0] = truelbl[1:].sum(axis=0) == 0
    fwd = np.zeros((5, length), dtype=np.int8)
    fwd[codes, np.arange(length)] = 1
    return Data(fwd=fwd, truelbl=truelbl)


def graph_options(**kwargs):
    base = dict(vecsize=60, units=16, batch_size=32, n_epochs=2,
                n_batches=4, early_stopping_th=10, repeats_to_search=[1, 2],
                learning_rate=0.01)
    base.update(kwargs)
    return Options(**base)


def fit_on_card(device, options, capture, logdir, rnn_kernel="fused"):
    """One ``Trainer.fit`` on the card from seed 0: ``(history, best
    parameters, the generator's state, the launch counts)``."""
    from deepgrp_tpu_torch.train.training import Trainer

    model = DeepGRPModel(ModelConfig.from_options(options), device)
    trainer = Trainer(model, options, logdir, tensorboard=False,
                      rnn_kernel=rnn_kernel, capture=capture)
    cuda_rnn.LAUNCHES.reset()
    rnn.PLAIN_CALLS.reset()
    try:
        best, history = trainer.fit(repeat_data(0), repeat_data(1), seed=0)
    finally:
        trainer.writer.close()
    torch.cuda.synchronize()
    assert rnn.PLAIN_CALLS.snapshot() == {}
    return (history, best, trainer.generator.get_state(),
            cuda_rnn.LAUNCHES.snapshot())


def assert_same_fit(got, want):
    history, best, state, launches = got
    assert history == want[0]
    for key, value in want[1].items():
        assert torch.equal(best[key], value), key
    assert torch.equal(state, want[2])
    assert launches == want[3]


@pytest.mark.parametrize("route", ["fused", "scan"])
@pytest.mark.parametrize("dropout", [0.0, 0.0928])
@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_captured_fit_equals_eager(device, tmp_path, route, dropout,
                                   rnn_type, attention):
    """``Trainer.fit`` with the step captured as a CUDA graph (one eager
    warm-up step, then replays) equals the eager fit bit for bit: history,
    best parameters, the generator's state and the launch counts (each
    kernel once a step, the validation's once an epoch)."""
    options = graph_options(rnn=rnn_type, attention=attention,
                            dropout=dropout)
    eager = fit_on_card(device, options, False, tmp_path / "eager", route)
    captured = fit_on_card(device, options, True, tmp_path / "captured",
                           route)
    assert_same_fit(captured, eager)
    cell = "lstm" if rnn_type == "LSTM" else "gru"
    trained = options.n_epochs * options.n_batches if route == "fused" else 0
    assert eager[3].get(f"{cell}_train_fwd", 0) == trained
    assert eager[3].get(f"{cell}_train_bwd", 0) == trained
    assert eager[3][f"{cell}_avg"] == options.n_epochs


@pytest.mark.parametrize("name", ["RMSprop", "Adam", "adam", "adamw",
                                  "adamax", "adagrad", "adadelta", "rmsprop",
                                  "sgd"])
def test_captured_epoch_of_each_optimizer(device, tmp_path, name):
    """One epoch of each optimizer name the port maps, captured, equals
    the same optimizer's eager epoch bit for bit."""
    options = graph_options(optimizer=name, n_epochs=1, dropout=0.0928,
                            attention=True)
    eager = fit_on_card(device, options, False, tmp_path / "eager")
    captured = fit_on_card(device, options, True, tmp_path / "captured")
    assert_same_fit(captured, eager)


def test_capture_refuses_the_cpu(device, tmp_path):
    from deepgrp_tpu_torch.train.step_graph import StepGraph
    from deepgrp_tpu_torch.train.training import Trainer

    options = graph_options()
    model = DeepGRPModel(ModelConfig.from_options(options), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        Trainer(model, options, tmp_path, tensorboard=False, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda: None, "cpu")


@pytest.mark.parametrize("optimizer", ["RMSprop", "Adam"])
def test_captured_fleet_with_a_freeze_equals_eager(device, optimizer):
    """Fleet steps of three trials, captured (one graph for all three,
    then, after trial 1 freezes, one for the other two), equal the eager
    fleet steps bit for bit: each trial's losses and parameters, the
    generators' states and the launch counts; the frozen trial's
    parameters stay bit for bit where they stopped."""
    from deepgrp_tpu_torch.hpo.vmapped import fleet_steps
    from deepgrp_tpu_torch.train.optimizers import fleet_optimizer
    from deepgrp_tpu_torch.train.sampler import BatchSampler
    from deepgrp_tpu_torch.train.step_graph import StepGraph

    options = graph_options(optimizer=optimizer, attention=True)
    config = ModelConfig.from_options(options)
    hps = [{"learning_rate": lr, "momentum": m, "rho": r, "epsilon": e,
            "dropout": d}
           for lr, m, r, e, d in ((1e-3, 0.9, 0.9, 1e-7, 0.0928),
                                  (5e-3, 0.5, 0.8, 1e-7, 0.0),
                                  (2e-3, 0.0, 0.95, 1e-6, 0.2))]
    sampler = BatchSampler(options, repeat_data(0), device)
    rows = 2 * sampler.batch_size
    runs = {}
    for capture in (False, True):
        models = [DeepGRPModel.from_params(config, init_params(
            config, torch.Generator().manual_seed(i)), device)
            for i in range(3)]
        opt = fleet_optimizer(optimizer, [(m.parameters(), hp)
                                          for m, hp in zip(models, hps)])
        gens = [torch.Generator(device=device).manual_seed(40 + i)
                for i in range(3)]

        def batch(i, gens=gens):
            codes, labels = sampler.batch(gens[i])
            masks = (rnn.input_dropout_masks(gens[i], rows, hps[i]["dropout"],
                                             config.gates)
                     if hps[i]["dropout"] > 0.0 else None)
            return codes, labels, masks

        losses = torch.zeros(3, device=device)
        cuda_rnn.LAUNCHES.reset()
        record = []
        for active in ([True] * 3, [True, False, True]):
            step = fleet_steps(models, opt, batch, active, losses)
            run = (StepGraph(step, device, [g for g, on in zip(gens, active)
                                            if on]) if capture else step)
            for _ in range(5):
                run()
                record.append(losses.cpu().clone())
            if all(active):
                frozen = {k: v.detach().clone() for k, v in
                          models[1].params().items()}
            del run
        torch.cuda.synchronize()
        runs[capture] = (record, [m.params() for m in models],
                         [g.get_state() for g in gens],
                         cuda_rnn.LAUNCHES.snapshot(), frozen)
    eager, captured = runs[False], runs[True]
    for got, want in zip(captured[0], eager[0]):
        assert torch.equal(got, want)
    for got, want in zip(captured[1], eager[1]):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    for got, want in zip(captured[2], eager[2]):
        assert torch.equal(got, want)
    assert captured[3] == eager[3] == {"gru_train_fwd": 25,
                                       "gru_train_bwd": 25}
    for key, value in captured[4].items():
        assert torch.equal(captured[1][1][key], value), key


def test_captured_parallel_trials_equal_eager(device):
    """``run_parallel_trials`` with captured fleet steps equals the eager
    run bit for bit (validation histories, best parameters, stop
    epochs)."""
    from deepgrp_tpu_torch.hpo.vmapped import run_parallel_trials

    options = graph_options(n_epochs=3, early_stopping_th=1)
    trials = [{"learning_rate": 1e-2, "dropout": 0.0928},
              {"learning_rate": 0.0, "dropout": 0.0},
              {"learning_rate": 3e-3, "momentum": 0.5, "dropout": 0.2}]
    runs = {capture: run_parallel_trials(options, trials, repeat_data(0),
                                         repeat_data(1), seed=3,
                                         device=device, capture=capture)
            for capture in (False, True)}
    for got, want in zip(runs[True], runs[False]):
        assert got["val_history"] == want["val_history"]
        assert got["stopped_epoch"] == want["stopped_epoch"]
        for key, value in want["params"].items():
            assert torch.equal(got["params"][key], value), key


# -- the data-parallel epoch as a captured CUDA graph -------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def process_group(backend: str, world: int = 1):
    """The default process group for the ``with`` block: ``"nccl"`` (the
    port's default backend, ``cpu:gloo,cuda:nccl``, one rank) or torch's
    ``"fake"`` backend (rank 0 of ``world``; its collectives make no CUDA
    call and leave their tensors as they are).  Yields the group."""
    import torch.distributed as dist

    from deepgrp_tpu_torch.parallel.mesh import initialize_distributed

    assert not dist.is_initialized()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    else:
        initialize_distributed(f"tcp://127.0.0.1:{free_port()}", world, 0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def dp_options(rnn_type="GRU", attention=True, **kwargs):
    """The flagship's widths (vecsize 342, 60 units, dropout 0.0928) at a
    small batch and depth."""
    base = dict(vecsize=342, units=60, rnn=rnn_type, attention=attention,
                dropout=0.0928, batch_size=32, n_epochs=2, n_batches=3,
                early_stopping_th=10, repeats_to_search=[1, 2])
    base.update(kwargs)
    return Options(**base)


def dp_epochs(device, options, capture, fused, group):
    """``options.n_epochs`` epochs of ``make_dp_train_epoch`` over
    ``group`` from seed 0: (each epoch's step losses, parameters, the
    generator's state, the launch counts)."""
    from deepgrp_tpu_torch.parallel.train import make_dp_train_epoch
    from deepgrp_tpu_torch.train.sampler import BatchSampler

    config = ModelConfig.from_options(options)
    model = DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(0)),
        device)
    optimizer = get_optimizer(options, model.parameters())
    sampler = BatchSampler(options, repeat_data(0, 12000), device)
    gen = torch.Generator(device=device).manual_seed(3)
    loop = make_dp_train_epoch(model, optimizer, options, sampler, gen,
                               options.n_batches, group, fused, capture)
    cuda_rnn.LAUNCHES.reset()
    rnn.PLAIN_CALLS.reset()
    losses = []
    for _ in range(options.n_epochs):
        loop.epoch().item()
        losses.append(loop.losses.clone())
    torch.cuda.synchronize()
    assert rnn.PLAIN_CALLS.snapshot() == {}
    return (losses, model.params(), gen.get_state(),
            cuda_rnn.LAUNCHES.snapshot())


@pytest.mark.parametrize("rnn_type,attention,route", [
    ("GRU", True, "fused"), ("LSTM", False, "fused"),
    ("GRU", True, "scan")])
def test_dp_capture_world1_nccl_equals_eager(device, rnn_type, attention,
                                             route):
    """At world size 1 over NCCL the captured data-parallel epoch (the
    ``all_reduce`` inside the graph) equals the eager one bit for bit:
    step losses, parameters, generator state and launch counts (each
    training kernel once a step on the fused route, none on the scan
    route)."""
    from deepgrp_tpu_torch.parallel.mesh import cuda_backend

    options = dp_options(rnn_type, attention)
    fused = route == "fused"
    with process_group("nccl") as group:
        assert cuda_backend(group) == "nccl"
        eager = dp_epochs(device, options, False, fused, group)
        captured = dp_epochs(device, options, True, fused, group)
    for got, want in zip(captured[0], eager[0]):
        assert torch.equal(got, want)
    for key, value in eager[1].items():
        assert torch.equal(captured[1][key], value), key
    assert torch.equal(captured[2], eager[2])
    cell = "lstm" if rnn_type == "LSTM" else "gru"
    steps = options.n_epochs * options.n_batches if fused else 0
    assert captured[3] == eager[3]
    assert eager[3].get(f"{cell}_train_fwd", 0) == steps
    assert eager[3].get(f"{cell}_train_bwd", 0) == steps


def test_capture_outlasts_a_graph_dying_inside_it(device):
    """A finished run's captured graph, kept in a reference cycle (as a
    ``StepGraph`` and its step's loop keep theirs), dies while the next
    step is captured, with the collector set to run at every allocation:
    the capture pauses the collector, so the dead graph's
    ``cudaGraphExecDestroy`` does not run inside it (where it invalidated
    the capture: ``train/step_graph.py``), and the step replays."""
    import gc

    from deepgrp_tpu_torch.train.step_graph import StepGraph

    x = torch.zeros(4, device=device)
    y = torch.zeros(4, device=device)
    keep = []

    def step():
        if torch.cuda.is_current_stream_capturing():
            keep.clear()  # the finished graph dies inside the capture
            [[] for _ in range(100)]  # allocations that set off the collector
        y.add_(1)

    thresholds = gc.get_threshold()
    gc.freeze()  # the process's objects out of the collector's way,
    gc.collect()  # so that its full collections run again
    try:
        finished = StepGraph(lambda: x.add_(1), device)
        finished()  # eager
        finished()  # captured and replayed
        finished.cycle = finished  # only the collector frees it
        keep.append(finished)
        del finished
        gc.set_threshold(1, 1, 1)
        run = StepGraph(step, device)
        for _ in range(3):
            run()
    finally:
        gc.set_threshold(*thresholds)
        gc.unfreeze()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(y, 3.0))
    assert torch.equal(x, torch.full_like(x, 2.0))


def test_dp_capture_global_mode_outlasts_the_watchdog(device):
    """A capture under ``capture_error_mode="global"`` (the one
    ``StepGraph`` uses) that lasts two seconds of host time, with
    collectives issued just before it still in NCCL's watchdog's list and
    an ``all_reduce`` inside it, ends and replays right: the watchdog
    thread's event queries do not invalidate it."""
    import torch.distributed as dist

    with process_group("nccl"):
        x = torch.ones(1 << 16, device=device)
        dist.all_reduce(x)  # the communicator
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(8):
                dist.all_reduce(x)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="global"):
            y = x * 2
            time.sleep(2.0)
            dist.all_reduce(y)
            z = y + 1
        x.fill_(5.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(z, torch.full_like(z, 11.0))


def test_dp_capture_fake_world2_fit_equals_eager(device, tmp_path):
    """Under torch's fake process group at world size 2 (rank 0; the
    collectives leave their tensors as they are), ``Trainer.fit(group=
    ...)`` with the step captured equals ``capture=False`` bit for bit:
    history, best parameters, generator state and launch counts.  The
    fake backend is not NCCL, so the default stays eager."""
    from deepgrp_tpu_torch.train.training import Trainer

    options = graph_options(attention=True, dropout=0.0928)
    runs = {}
    with process_group("fake", 2) as group:
        for capture in (None, False, True):
            model = DeepGRPModel(ModelConfig.from_options(options), device)
            trainer = Trainer(model, options, tmp_path / str(capture),
                              tensorboard=False, group=group,
                              capture=capture)
            if capture is None:
                assert trainer.capture is False
                trainer.writer.close()
                continue
            cuda_rnn.LAUNCHES.reset()
            rnn.PLAIN_CALLS.reset()
            try:
                best, history = trainer.fit(repeat_data(0), repeat_data(1),
                                            seed=0)
            finally:
                trainer.writer.close()
            torch.cuda.synchronize()
            assert rnn.PLAIN_CALLS.snapshot() == {}
            runs[capture] = (history, best, trainer.generator.get_state(),
                             cuda_rnn.LAUNCHES.snapshot())
    assert_same_fit(runs[True], runs[False])
    steps = options.n_epochs * options.n_batches
    assert runs[True][3] == {"gru_train_fwd": steps, "gru_train_bwd": steps,
                             "gru_avg": options.n_epochs}


def nccl_rank(rank: int, tmp: str) -> None:
    """One of :func:`test_dp_capture_two_nccl_ranks_equal_eager`'s ranks
    (a process of its own, on ``cuda:rank``): ``Trainer.fit`` over an
    NCCL group of two, eager and then with the default (captured); writes
    ``tmp/rank{rank}-{eager|captured}.npz`` and ``tmp/rank{rank}.json``."""
    import torch.distributed as dist

    from deepgrp_tpu_torch.parallel.mesh import initialize_distributed
    from deepgrp_tpu_torch.train.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    initialize_distributed(f"file://{tmp}/rdzv", 2, rank)
    info = {}
    try:
        options = graph_options(attention=True, dropout=0.0928)
        for capture in (False, None):
            name = "eager" if capture is False else "captured"
            model = DeepGRPModel(ModelConfig.from_options(options), device)
            trainer = Trainer(model, options,
                              os.path.join(tmp, f"{name}-{rank}"),
                              tensorboard=False, group=dist.group.WORLD,
                              capture=capture)
            cuda_rnn.LAUNCHES.reset()
            best, history = trainer.fit(repeat_data(0), repeat_data(1),
                                        seed=0)
            torch.cuda.synchronize()
            if trainer.writer is not None:
                trainer.writer.close()
            np.savez(os.path.join(tmp, f"rank{rank}-{name}.npz"),
                     generator=trainer.generator.get_state().numpy(),
                     **{k: v.numpy() for k, v in best.items()})
            info[name] = {"history": history, "capture": trainer.capture,
                          "launches": cuda_rnn.LAUNCHES.snapshot()}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(info, fh)
    finally:
        dist.destroy_process_group()


def test_dp_capture_two_nccl_ranks_equal_eager(device, tmp_path):
    """Two NCCL ranks on two cards: ``Trainer.fit`` captured by default
    (the gradient ``all_reduce`` inside the replayed graph, NCCL's sum of
    two ranks, exact in either order) equals the eager fit bit for bit on
    each rank (history, best parameters, generator state, launch counts),
    and the ranks' parameters and histories are equal."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two CUDA cards; this machine has {count}")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; "
            "import test_torch_cuda; "
            "test_torch_cuda.nccl_rank(int(sys.argv[3]), sys.argv[4])")
    procs = [subprocess.Popen([sys.executable, "-c", code, here,
                               os.path.dirname(here), str(rank),
                               str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, text in zip(procs, outputs):
        assert proc.returncode == 0, text
    ranks = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as fh:
            info = json.load(fh)
        runs = {}
        for name in ("eager", "captured"):
            with np.load(tmp_path / f"rank{rank}-{name}.npz") as data:
                runs[name] = {k: data[k] for k in data.files}
        assert info["eager"]["capture"] is False
        assert info["captured"]["capture"] is True
        assert info["captured"]["history"] == info["eager"]["history"]
        assert info["captured"]["launches"] == info["eager"]["launches"]
        for key, value in runs["eager"].items():
            assert runs["captured"][key].tobytes() == value.tobytes(), key
        ranks.append((info, runs))
    assert ranks[0][0]["captured"]["history"] == \
        ranks[1][0]["captured"]["history"]
    for key, value in ranks[0][1]["captured"].items():
        if key != "generator":
            assert ranks[1][1]["captured"][key].tobytes() == \
                value.tobytes(), key


# -- the examples on the card --------------------------------------------------


def test_train_and_evaluate_example_on_card(device, tmp_path):
    """``examples/train_and_evaluate.py`` for 1 x 3 steps on the card: each
    training kernel launched once a step (counted at each replay of the
    captured step), the inference kernel on the validation and on every
    chunk of the evaluation, no plain version; one CSV row (after 3
    steps the MCC may be NaN: no repeat predicted), and ``model00.npz``
    loads."""
    import csv

    import torch_dist_worker as worker
    from deepgrp_tpu_torch.examples import train_and_evaluate
    from deepgrp_tpu_torch.predict.engine import window_starts

    toml, train_npz, val_npz, bed = worker.write_cli_train_inputs(tmp_path)
    options = graph_options(n_epochs=1, n_batches=3, attention=True,
                            dropout=0.0928)
    with open(toml, "w") as fh:
        options.to_toml(fh)
    val_len = worker.train_data(seed=1).fwd.shape[1] - 1  # drop_start_end_n
    windows = window_starts(val_len, options.vecsize, 50).size
    chunks = -(-windows // options.batch_size)
    cuda_rnn.LAUNCHES.reset()
    rnn.PLAIN_CALLS.reset()
    train_and_evaluate.main([train_npz, val_npz, bed, "--runs", "1",
                             "--outdir", str(tmp_path / "out"), "--config",
                             toml])
    torch.cuda.synchronize()
    launches = cuda_rnn.LAUNCHES.snapshot()
    assert rnn.PLAIN_CALLS.snapshot() == {}
    assert launches["gru_train_fwd"] == launches["gru_train_bwd"] == 3
    assert launches["gru_avg"] == 1 + chunks
    with open(tmp_path / "out" / "training_times.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1 and int(rows[0]["epochs"]) == 1
    float(rows[0]["MCC"])
    config, _ = load_model(str(tmp_path / "out" / "model00.npz"))
    assert config == ModelConfig.from_options(options)
