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
tiny widths (also at u=96 and u=128, past the register tile), with
and without dropout masks: forward outputs at atol 1e-5;
gradients at a max abs difference of 1e-4 times the largest magnitude of
that gradient (sums over B x T terms taken in other orders); two backward
runs give bitwise-equal gradients (no float atomics).

The fused inference kernels (one register tile for both cells) also run
at the CLI's default batch (256 windows: two a CTA), at u=96 and u=128
(past the register tile) and at u=200 (two windows a CTA, 4u threads).
The GRU sequence kernel (``gru_seq``) is held against its plain version
(``rnn.gru_apply``) on uniform random input at the scan route's shape
(2048 rows, T=342, u=60), at the CLI's default 512 rows, at u=64 and u=65
(either side of U in registers), u=128 (U through L1/L2), u=256 and
u=512 (two k-slices a unit), u=1024 (one), and at ragged shapes; a second
launch is bitwise equal to the first and u=1025 is refused.  The bf16
variants of the fused kernels are held against their plain versions.
Tolerance in bfloat16: atol 2e-2 (the plain version rounds as the kernel
does; the outputs are bf16).

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
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

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
                                               (5, 20, 128)])
def test_train_kernels_match_plain_wide(device, cell, masked, batch, steps,
                                        units):
    """Widths past the register tile (U read through L2), up to the
    backward's ceiling (4u threads a CTA, at most 512: u=128)."""
    check_train_pair(device, cell, masked, batch, steps, units)


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
def test_backward_width_ceiling(device, cell):
    """The window kernels (forward and backward recurrence) launch up to
    u=128 at T=342 (4u threads a CTA) and not at u=129."""
    tile = cuda_rnn.train_tile(cell, 8, 128, 342)
    assert tile["bwd_ctas_per_sm"] >= 1 and tile["fwd_ctas_per_sm"] >= 1
    tile = cuda_rnn.train_tile(cell, 8, 129, 342)
    assert tile["bwd_ctas_per_sm"] == 0 and tile["fwd_ctas_per_sm"] == 0


def test_gru_backward_refuses_u129(device):
    """The GRU backward raises at u=129 (past its 4u <= 512 threads)."""
    batch, steps, units = 2, 5, 129
    params, codes = random_case(5, 3, batch, steps, units, device)
    hseq = torch.zeros(2 * batch, steps, units, device=device)
    with pytest.raises(RuntimeError, match="u=129"):
        cuda_rnn.train_bwd("gru", params, codes, None, (hseq,),
                           torch.zeros(batch, steps, units, device=device),
                           torch.zeros(batch, units, device=device))


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


def test_gru_avg_tile_fills_the_card(device):
    """The GRU inference tile: one wave at the engine's 1024 windows and at
    the fixtures' 64 (8 and 1 windows a CTA on a 132-SM card)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in (1024, 64):
        windows, n_cta = cuda_rnn.avg_tile("gru", batch, 60)
        assert windows * n_cta >= batch and windows <= 8
        assert n_cta <= sms or windows == 8
    assert cuda_rnn.avg_tile("gru", 64, 60) == (1, 64)
    assert cuda_rnn.avg_tile("gru", 1024, 200)[0] <= 2


def test_lstm_avg_tile_fills_the_card(device):
    """The LSTM runs on the GRU's tile: one wave at the engine's 1024
    windows and at the CLI's default 256 (128 CTAs of 2 windows on a
    132-SM card, where the first design ran 32 CTAs of 8)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in (1024, 256):
        windows, n_cta = cuda_rnn.avg_tile("lstm", batch, 60)
        assert windows * n_cta >= batch and windows <= 8
        assert n_cta <= sms or windows == 8
        assert cuda_rnn.avg_tile("lstm", batch, 60) == cuda_rnn.avg_tile(
            "gru", batch, 60)
    if sms == 132:
        assert cuda_rnn.avg_tile("lstm", 256, 60) == (2, 128)


def test_lstm_avg_refuses_u257(device):
    """The inference kernels take 4u <= 1,024 threads: u=257 raises, naming
    the shape."""
    params, codes = random_case(6, 4, 3, 5, 257, device)
    with pytest.raises(RuntimeError, match="u=257"):
        cuda_rnn.lstm_avg(params, codes)


@pytest.mark.parametrize("cell,batch,steps,units", [
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in ((1024, 342, 60), (1000, 150, 32), (3, 7, 5), (9, 1, 17))),
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in ((256, 342, 60), (1024, 342, 96), (1024, 342, 128),
                    (37, 50, 200)))])
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


@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_train_step_on_card_matches_cpu(device, rnn_type, attention):
    """One optimization step on the card (kernels) against the same step
    on the CPU (plain versions): loss at atol 1e-5, gradients as above,
    updated parameters at atol 1e-5."""
    options = Options(vecsize=60, units=16, batch_size=32, rnn=rnn_type,
                      attention=attention, dropout=0.0928)
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
    # Two slices a unit (u=512; u=256 above) and one (u=1024).
    (torch.float32, 6, 40, 512), (torch.float32, 5, 20, 1024),
    (torch.bfloat16, 5, 20, 1024), (torch.bfloat16, 2048, 342, 128)])
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


def test_gru_seq_refuses_u1025(device):
    """The sequence kernel takes u <= 1024 (one slice a unit, u threads):
    u=1025 raises, naming the shape."""
    params, x = random_seq_case(2, 3, 1025, torch.float32, device)
    with pytest.raises(RuntimeError, match="u=1025"):
        cuda_rnn.gru_apply(params, x)


def test_gru_seq_layout(device):
    """The layout the kernel launches by width and rows a CTA, and the
    cap of :func:`cuda_rnn.seq_tile` is the kernel's own."""
    cases = {(60, 16): (8, 4, "registers"), (60, 4): (4, 4, "registers"),
             (64, 12): (8, 4, "registers"), (65, 12): (16, 4, "L1/L2"),
             (128, 3): (4, 4, "L1/L2"), (129, 4): (4, 2, "L1/L2"),
             (512, 1): (4, 2, "L1/L2"), (1024, 4): (4, 1, "L1/L2")}
    for (units, rows), want in cases.items():
        layout = cuda_rnn.seq_layout(units, rows)
        assert (layout["rows_a_group"], layout["slices"],
                layout["u_in"]) == want
    for units in (60, 128, 129, 1024):
        most = cuda_rnn.seq_tile(10 ** 6, units, 1)[0]
        cuda_rnn.seq_layout(units, most)
        with pytest.raises(ValueError):
            cuda_rnn.seq_layout(units, most + 1)
    with pytest.raises(ValueError):
        cuda_rnn.seq_layout(1025, 1)


@pytest.mark.parametrize("cell,batch,steps,units", [
    *((cell, *shape) for cell in ("gru", "lstm")
      for shape in ((1024, 342, 60), (1000, 150, 32), (3, 7, 5),
                    (1024, 342, 96), (1024, 342, 128)))])
def test_avg_bf16_kernel_matches_plain(device, cell, batch, steps, units):
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(batch * units + steps, gates, batch, steps,
                                units, device)
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    plain = getattr(rnn, f"{cell}_avg_plain")
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
