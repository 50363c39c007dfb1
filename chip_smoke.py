#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepgrp_tpu_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Environment: the card's name and power limit, the torch and CUDA
   versions; builds the CUDA kernels (``csrc/``, nvcc) and the host library
   (``native/``, g++) in parallel and prints their build times.
2. Kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, at the flagship shape (B=1024 windows, T=342, u=60) and at a
   ragged one (B=1000, T=150, u=32), also at u=96 and u=128 (past the
   register tile; each cell's tile is printed), random weights and codes
   (with N and pad codes) from a seed; max abs difference <= 1e-5 on both
   outputs (the JAX package's kernel tolerance).  Times the kernel, the
   plain version and the cuDNN recurrence (``torch.nn.GRU``/``LSTM`` on the
   doubled one-hot batch, TF32 off) with CUDA events.
3. Fixture BEDs: ``python -m deepgrp_tpu_torch predict`` (through
   ``cli.main``) on ``tests/fixtures/reference/{gru_att,gru,lstm}.fa`` with
   the reference settings and the ``.npz`` weights in
   ``tests/fixtures/torch``; the rows must equal ``{name}.bed`` exactly.
4. Real size: the 4.9 Mbp chromosome of ``tests/synth_mbp.py`` (seed and
   size from ``mbp_manifest.json``) through ``gru_att`` at ``-b 1024``;
   all 1456 rows must equal ``mbp.bed``.  Prints windows/s end to end.
5. Where the time goes: the same chromosome stage by stage on the host
   clock, the engine and the streaming host MSS as one overlapped stage
   (``-t 1``) with the MSS's tail after the last slice's bytes landed, the
   host time the chunk loop's thread takes to enqueue the engine stage, the
   serial engine + whole-array MSS beside it (labels equal), and the
   engine's device time by kernel name (``torch.profiler``).
6. Training kernels vs plain: the four training kernels (GRU and LSTM,
   forward and backward) against their plain versions at the flagship
   training shape (B=256 windows, T=342, u=60) and a ragged one (B=37,
   T=150, u=32), with dropout masks (rate 0.0928) and without: forward
   outputs at atol 1e-5, gradients within 1e-4 x the largest magnitude of
   each gradient, and a second backward bitwise equal to the first.  Times
   each kernel, its plain version and cuDNN (``torch.nn.GRU``/``LSTM``
   forward, and forward + backward, on the doubled one-hot batch without
   masks, TF32 off) with CUDA events.  For both cells it prints the window
   tile of the forward and of the backward's recurrence kernel (threads,
   CTAs and warps an SM) and the backward's split (recurrence kernel ms,
   reduction kernel ms), and checks the pair again past the register
   tile: at u=96 (B=64, T=342) and, for the GRU, at u=128.
7. Training on the card: ``python -m deepgrp_tpu_torch -b 256 train``
   (through ``cli.main``) with the flagship ``gru_att`` configuration
   (vecsize 342, 60 units, attention, dropout 0.0928, RMSprop defaults),
   3 epochs of 20 steps, on synthetic learnable chromosomes written from a
   seed (2 Mbp training, 0.5 Mbp validation, four repeat classes of
   class-specific motifs, and their BED); the training kernels must have
   launched on every step, the inference kernel once per epoch, no plain
   version, every loss finite and the last epoch's below the first's; the
   written model then predicts a BED of the validation sequence.  Then
   steps/s, one epoch's stream time by stage and device time by kernel
   name with the idle share, one step through the kernels against the
   same step through the plain versions, and LSTM at 2 epochs of 5
   steps (60 units, then 128, whose model then predicts a BED of the
   validation sequence), then the same breakdown (steps/s, stream time by
   stage with the backward's share, device time and idle share, one step
   against the plain versions) for the LSTM model at batch 256, one epoch
   of 20 steps.  For both models the epoch with its step captured as a
   CUDA graph (``train/step_graph.py``: one eager warm-up step, the
   capture, replays) against the eager epoch, from the same parameters
   and generator seed, in 4 turns (the first a warm-up; eager first in
   turns 1 and 3, captured first in 2 and 4) and one profiled epoch each:
   step losses, parameters and generator state equal bit for bit after
   every turn; steps/s, the graph's memory and each one's device busy and
   idle share printed.  Then ``Trainer.fit`` of 2 epochs captured against
   eager: history, best parameters, generator state and launch counts
   equal bit for bit.
8. One-hot kernels vs plain versions: the GRU sequence kernel
   (``gru_seq``, ``csrc/rnn_seq.cu``; its ``ptxas -v`` registers and
   spills, and at each shape its tile: rows a CTA, CTAs, rows a lane
   group, k-slices a unit and where U sits) against ``rnn.gru_apply`` on
   uniform random input at (2048, 342, 60) in float32 and bfloat16,
   (2048, 342, 128), (512, 342, 256) and (16, 342, 512) in float32 (U
   through L1/L2; two k-slices a unit past u=128) and a ragged (7, 23, 60);
   the bf16 variants of the fused kernels
   (``gru_avg_bf16``, ``lstm_avg_bf16``) against their plain versions at
   (1024, 342, 60) and (1000, 150, 32), also at u=96 and u=128.
   atol 1e-5 in float32, 2e-2 in
   bfloat16.  Times each kernel, its plain version and cuDNN
   (``torch.nn.GRU``/``LSTM`` in the same dtype, TF32 off).
9. The scan route and the fast mode: ``predict --rnn-kernel scan`` on the
   three fixtures (rows equal to the reference BEDs; ``gru_seq`` launched
   for the GRU models) and once on the 4.9 Mbp chromosome (windows/s, the
   rows against ``mbp.bed``, and the largest max-probability difference to
   phase 4's fused run, at most 1e-5); ``--precision bfloat16`` on the
   fused and the scan route against the float32 runs of phase 3: raw class
   agreement >= 0.95, post-MSS agreement >= 0.98 and R_K MCC >= 0.95 on
   ``gru_att`` and ``gru`` (the JAX package's contract), recorded for
   ``lstm``; then ``--precision bfloat16`` (fused) on the 4.9 Mbp
   chromosome: windows/s, and agreement and MCC against phase 4 (recorded,
   not gated).
10. ``predict -m`` (no MSS): on the three fixtures the card's BED rows must
    equal the same call's with ``--device cpu``; on the 4.9 Mbp chromosome
    ``engine.predict``'s row argmax and row max must equal
    ``predict_scored``'s classes and max probability bit for bit, on the
    fused and the scan route (seconds of the track and of the host softmax
    printed); then the seconds and windows/s of ``-m`` beside the MSS
    route's (MSS, -m, -m, MSS).
11. The training scan route: on phase 7's synthetic chromosomes, one step
    of ``gru_att`` and of the LSTM at u=60 (batch 256) through
    ``forward_logits(..., train=True)`` (autograd through the plain loop,
    no kernel) against the same step through the fused kernels on the
    same windows, masks and parameters: loss to 1e-5, every gradient to
    1e-4 of its largest magnitude; then ``train --rnn-kernel scan`` and
    ``--rnn-kernel fused`` through the CLI (2 epochs of 3 steps), with
    their steps/s.  Between them, the scan route's step captured as a
    CUDA graph against the eager step (``gru_att``, batch 256, epochs of
    5 steps in turns, as phase 7), and a captured ``Trainer.fit
    --rnn-kernel scan`` of 2 x 3 steps against the eager one.
12. HPO on phase 7's chromosome pair, in the reference search space
    (vecsize about 200, 34 units), each trial 2 epochs of 100 steps at
    batch 256 (cut from the reference's 200 x 250): ``run_a_trial`` with 2
    TPE evaluations, then 1 more (``results.pkl`` must resume to 3);
    ``run_bucketed_sweep`` with 4 proposals a round, at the first seed
    whose round puts two proposals in one shape bucket (a fleet).  Every
    trial must be ``STATUS_OK`` with a finite loss, its logdir holding
    ``hparams.json``, ``metrics.jsonl`` with ``hpo/MCC`` and an events
    file, and every training step must have gone through the kernels.
    Then one fleet step of 4 trials (one frozen) through the kernels
    against the same step through the plain versions on the card (losses
    to 1e-5, updated parameters to 1e-4 of their largest magnitude, the
    frozen trial's bit for bit), the fleet's steps/s against one trial's
    serial steps/s, and one fleet epoch's device time by kernel name.
    Then the fleet step of 4 trials captured as one CUDA graph against
    the eager fleet step, epochs of 20 steps in turns as phase 7, then 2
    more epochs with trial 1 frozen (the captured run drops its graph and
    captures the other three's): losses, parameters and generator states
    equal bit for bit after every epoch, the frozen trial's parameters
    unchanged, every trial step counted once.
13. Several shards and ranks on the one card (``deepgrp_tpu_torch/
    parallel``): the sharded engine over ``["cuda:0"] * 4`` and ``* 3``
    on phase 4's chromosome (batch 1024): the MSS labels give the 1456
    rows of ``mbp.bed``, classes and max probability equal phase 4's bit
    for bit, the boundary combined on the device and on the host agree,
    and the bf16 track equals the single engine's bf16 track; the
    ``lstm`` fixture (f32, bf16) and ``gru_att`` on the scan route over 3
    shards against the single engine and the reference BEDs; the engine
    stage's seconds with 1, 4 and 3 shards in turn (the cost of
    splitting; one card says nothing of scaling).  Then two ranks on
    ``cuda:0`` over gloo (processes the script starts, ``dp_worker``):
    one DP step of ``gru_att`` and of the LSTM of its width at batch 256
    (128 a rank) against one process's step on the whole batch (loss to
    1e-5, parameters to 1e-4 of their largest magnitude), then 2 x 3 DP
    training steps of ``gru_att`` after which the ranks' parameters and
    histories are bitwise equal and only rank 0 wrote a logdir; the gloo
    ranks stay eager (no graph captured) and refuse ``capture=True``.
    Then the default backend (``cpu:gloo,cuda:nccl``) at world size 1: an
    NCCL all-reduce, and ``predict`` (the ``gru_att`` fixture BED) and
    ``train`` (2 x 3 steps) through the CLI's launch flags.
14. The MSS routes of ``predict``: phase 4's chromosome through the CLI
    with ``--device-mss auto`` at ``-t 1`` and ``-t 0`` (the streaming
    host MSS), ``on`` (the whole MSS on the card, ``dg_mss_stack``,
    ``csrc/mss_stack.cu``) and ``off``, two turns each (seconds, the MSS
    tail), all 1456 rows equal to ``mbp.bed``; the three fixture BEDs on
    each route; 4 shards on ``cuda:0`` with ``auto``, which must run the
    MSS on the card (``dg_mss_stack``) on this sparse track (its runs
    printed); in bf16 every
    route's classes equal to the ``off`` route's bit for bit;
    ``dg_mss_stack`` against its plain version on the track's collapsed
    runs (segments equal; timed, with its byte bound); the count of
    positions where the card's score transform differs from numpy's (not
    gated); the copy rate of a slice and of the whole track to pinned host
    memory; and on a noisy 1 Mbp track (random weights at full width) a
    capacity overflow at 64 runs and the doubling retry, whose classes
    must equal the ``off`` route's.

15. The port-only workflow on the card: phase 7's chromosomes (same seed)
    as gzip FASTA files in lines of 60 bases and their regions as a
    RepeatMasker ``.out`` file (classic and tab-separated rows, class 1 as
    ``(GGAAT)n`` rows and one mutated motif, other families to drop)
    through ``python -m deepgrp_tpu_torch.data.preprocess_sequence`` (run
    twice: the second run must write nothing) and ``...data.parse_rm -o``:
    each npz's ``fwd`` must equal phase 7's one-hot and ``preprocess_y``
    over the tool's BED phase 7's labels.  Then ``train`` through the CLI
    with ``--profile DIR --xla -t 2`` (``gru_att``, 1 x 20 steps): 20
    launches of each training kernel, no plain call, finite losses, and
    the trace names both kernels; 5 steps with ``optimizer = "adamw"``;
    2 x 20 steps at ``-t 1`` and ``-t 0`` in turns (the second epoch's
    steps/s with torch on one host thread and on its default);
    ``predict`` of chrValid with the trained model, plain, with
    ``--profile`` (the trace names ``AvgKernel``) and plain again (seconds
    of each: the profiler's overhead); ``engine.predict`` with
    ``create_model(options)`` on the card equal to
    ``PredictionEngine.predict`` bit for bit; and, where ``h5py`` is
    missing, ``train --modelfile m.h5`` raising ``ImportError`` before it
    trains or writes anything.
16. The examples on the card, on phase 7's chromosomes (same seed):
    ``examples.train_and_evaluate`` with ``--runs 1`` on the tuned
    ``gru_att`` (vecsize 342, 60 units, attention, dropout 0.0928, batch
    256; depth cut from 200 x 250 to 2 x 100 steps, from a TOML): 200
    launches of each training kernel, ``gru_avg`` on the two validations
    and every evaluation chunk, no plain call, one CSV row with a finite
    MCC equal to the scored route's on the same weights, and
    ``model00.npz`` loads; ``examples.hpo_sweep --space quick --seed 0``
    on the same TOML, 2 serial trials saved after each, then a fleet
    round of 2 that resumes ``results.pkl`` (every trial ``STATUS_OK``
    with a finite loss); ``examples.multihost_sim --device cuda --nproc
    2`` (two gloo ranks holding 1 and 2 shards on ``cuda:0``, bit-identical
    to one process); and the native library's self-test built on this
    host (``make -C deepgrp_tpu_torch/native selftest``, ``-march=native``)
    printing ``native selftest OK``.  Prints each step's seconds and the
    phase's launches.
17. The data-parallel epoch as one captured graph
    (``parallel/train.py:make_dp_train_epoch``, the gradient ``all_reduce``
    inside): on phase 7's chromosomes (same seed), under the default
    backend at world size 1 (NCCL for CUDA tensors), ``gru_att`` and the
    LSTM of its width at batch 256, the captured epoch against the eager
    one in turns as phase 7 (5 x 20 steps each): losses, parameters and
    generator state bit for bit after every turn, each training kernel
    launched 20 times an epoch on both sides (counted at each replay),
    steps/s, idle share and the replayed graph's NCCL kernels, copies and
    sets (from the profiled epoch); then, under torch's fake process group
    at world size 2 (rank 0), ``Trainer.fit`` of ``gru_att`` (2 x 20
    steps, 128 windows a rank) captured against eager: history, best
    parameters, generator state and launch counts bit for bit.  Fails if
    torch lacks the fake backend.

A captured step's launches are counted at each replay, as an eager
step's are (``_build.recording_launches``).
Before each predict or train run every launch count is set to 0; after it,
the kernels of that path must have launched and the plain versions must
not have run (``dg_mss_stack`` on the ``on`` route and the sharded
engine's ``auto`` on a sparse track only).  The line before
the last lists each kernel (``{"kernels": [...]}``); the last line is
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "tests", "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "tests", "fixtures", "torch")
REF_ARGS = ["-b", "64", "-s", "50", "-x", "50", "-l", "50"]

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bfloat16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3
TOL = 1e-5
BF16_TOL = 2e-2

KERNELS = {
    # name: (gates, TPU kernel it replaces)
    "gru_avg": (3, "deepgrp_tpu/models/pallas_rnn.py:178"),
    "lstm_avg": (4, "deepgrp_tpu/models/pallas_rnn.py:309"),
}
SHAPES = {"flagship": (1024, 342, 60), "ragged": (1000, 150, 32)}
# The inference kernels past their register tile (U through L1/L2).
WIDE_SHAPES = {"u96": (1024, 342, 96), "u128": (1024, 342, 128)}

TRAIN_KERNELS = {
    # name: TPU kernel it replaces
    "gru_train_fwd": "deepgrp_tpu/models/pallas_rnn_train.py:97",
    "gru_train_bwd": "deepgrp_tpu/models/pallas_rnn_train.py:135",
    "lstm_train_fwd": "deepgrp_tpu/models/pallas_rnn_train.py:496",
    "lstm_train_bwd": "deepgrp_tpu/models/pallas_rnn_train.py:542",
}
TRAIN_SHAPES = {"flagship": (256, 342, 60), "ragged": (37, 150, 32)}
LSTM_WIDE_SHAPE = (64, 342, 96)
# Widths past the window tile's registers, up to its ceiling (4u <= 512).
TRAIN_WIDE_SHAPES = {"u96": LSTM_WIDE_SHAPE, "u128": (64, 342, 128)}
# The LSTM trained through the CLI at the training ceiling, past the
# u=113 at which the first inference kernel stopped.
LSTM_WIDE_UNITS = 128

# The GRU sequence kernel: (label, dtype name, (rows, T, u)); 2048 rows is
# the doubled batch of the engine's -b 1024.
SEQ_REPLACES = "deepgrp_tpu/models/pallas_rnn.py:43"
SEQ_SHAPES = [("flagship", "float32", (2048, 342, 60)),
              ("flagship_bf16", "bfloat16", (2048, 342, 60)),
              ("u128", "float32", (2048, 342, 128)),
              ("u256", "float32", (512, 342, 256)),
              ("u512", "float32", (16, 342, 512)),
              ("ragged", "float32", (7, 23, 60))]
# The bf16 quality contract (tests/test_reference_parity.py:110-180).
BF16_RAW_AGREE, BF16_POST_AGREE, BF16_MCC = 0.95, 0.98, 0.95
GRAD_RTOL = 1e-4  # max abs difference / largest magnitude of the gradient
# The flagship model (bench.py:37-42): vecsize 342, 60 units, attention,
# dropout 0.0928; the reference's RMSprop defaults.
FLAGSHIP = {"vecsize": 342, "units": 60, "attention": True,
            "dropout": 0.0928}
# HPO trials: depth cut from the reference's 200 epochs x 250 steps.  At
# the reference space's widths a trial needs about 80 steps on these
# chromosomes before it predicts any repeat on chrValid; with fewer its
# MCC is NaN and the trial fails by the reference's rule.  The
# evaluation's window step is the CLI default.
HPO_EPOCHS, HPO_STEPS, HPO_STEP_SIZE = 2, 100, 50
# Steps an epoch of the captured-against-eager turns: the scan route (a
# slow eager step) and the fleet.
SCAN_GRAPH_STEPS, FLEET_GRAPH_STEPS = 5, 20
# The fleet's epoch at which trial 1 freezes: after compare_captured's 4
# turns and profiled epoch.
FLEET_FREEZE_EPOCH = 5


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def build_all():
    """Build every CUDA library (one nvcc each) and the host library
    concurrently; seconds each."""
    from deepgrp_tpu_torch import _build, native

    seconds, errors = {}, []

    def run(name, fn):
        start = time.perf_counter()
        try:
            fn()
        except BaseException as err:  # re-raised below, in the main thread
            errors.append(err)
        seconds[name] = time.perf_counter() - start

    jobs = [(name, lambda name=name: _build.load_kernels(name))
            for name in _build.CUDA_SOURCES]
    jobs.append(("native", native.load))
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    return seconds


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_rnn(torch, gen, gates: int, batch: int, steps: int, units: int):
    width = gates * units
    params = {
        "kernel": torch.randn(5, width, generator=gen) * 0.5,
        "recurrent": torch.randn(units, width, generator=gen) / units ** 0.5,
        "bias": torch.randn(*((2, width) if gates == 3 else (width,)),
                            generator=gen) * 0.3,
    }
    codes = torch.randint(0, 6, (batch, steps), generator=gen,
                          dtype=torch.int8)
    return ({k: v.cuda() for k, v in params.items()}, codes.cuda())


def cudnn_cell(torch, gates: int, params, codes, dtype=None):
    """cuDNN recurrence with the kernel's weights and the doubled one-hot
    batch it runs on (timed only; it has no per-gate input masks)."""
    from deepgrp_tpu_torch.models.rnn import _doubled_codes

    both = _doubled_codes(codes)
    onehot = torch.eye(6, device=codes.device,
                       dtype=dtype)[both][..., :5].contiguous()
    return cudnn_module(torch, gates, params, dtype), onehot


def cudnn_module(torch, gates: int, params, dtype=None):
    """``torch.nn.GRU``/``LSTM`` (cuDNN) holding the Keras-layout weights,
    in ``dtype`` (float32 by default)."""
    units = params["recurrent"].shape[0]
    in_dim = params["kernel"].shape[0]
    if gates == 3:
        cell = torch.nn.GRU(in_dim, units, batch_first=True).cuda()

        def reorder(mat):  # Keras (z, r, h) -> torch (r, z, n)
            return torch.cat([mat[..., units:2 * units], mat[..., :units],
                              mat[..., 2 * units:]], dim=-1)

        w_ih, w_hh = reorder(params["kernel"]), reorder(params["recurrent"])
        b_ih, b_hh = reorder(params["bias"][0]), reorder(params["bias"][1])
    else:
        cell = torch.nn.LSTM(in_dim, units, batch_first=True).cuda()
        w_ih, w_hh = params["kernel"], params["recurrent"]
        b_ih, b_hh = params["bias"], torch.zeros_like(params["bias"])
    with torch.no_grad():
        cell.weight_ih_l0.copy_(w_ih.T)
        cell.weight_hh_l0.copy_(w_hh.T)
        cell.bias_ih_l0.copy_(b_ih)
        cell.bias_hh_l0.copy_(b_hh)
    return cell.to(dtype) if dtype is not None else cell


def library_rnn(torch, gates: int, params, codes, dtype=None):
    """cuDNN recurrence computing the same function (timed only)."""
    cell, onehot = cudnn_cell(torch, gates, params, codes, dtype)
    batch = codes.shape[0]

    @torch.no_grad()
    def run():
        seq, _ = cell(onehot)
        return (seq[:batch] + seq[batch:]) * 0.5

    return run


def library_rnn_train(torch, gates: int, params, codes):
    """cuDNN training forward, and forward + backward, on the same batch
    (timed only)."""
    cell, onehot = cudnn_cell(torch, gates, params, codes)
    units = params["recurrent"].shape[0]
    d_seq = torch.randn(onehot.shape[0], onehot.shape[1], units,
                        device=onehot.device)

    def forward():
        return cell(onehot)[0]

    def forward_backward():
        torch.autograd.backward(cell(onehot)[0], d_seq)

    return forward, forward_backward


def kernel_phase(torch):
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    gen = torch.Generator().manual_seed(2024)
    results = {}
    for name, (gates, _) in KERNELS.items():
        kernel = getattr(cuda_rnn, name)
        plain = getattr(rnn, f"{name}_plain")
        for label, (batch, steps, units) in {**SHAPES,
                                             **WIDE_SHAPES}.items():
            params, codes = random_rnn(torch, gen, gates, batch, steps,
                                       units)
            windows, n_cta = cuda_rnn.avg_tile(name.split("_")[0], batch,
                                             units)
            print(f"{name} {label}: tile {n_cta} CTAs x {windows} "
                  f"windows ({4 * units}-thread lane groups)", flush=True)
            avg, hidden = kernel(params, codes)
            torch.cuda.synchronize()
            p_avg, p_hidden = plain(params, codes)
            torch.cuda.synchronize()
            err = max((avg - p_avg).abs().max().item(),
                      (hidden - p_hidden).abs().max().item())
            lib = library_rnn(torch, gates, params, codes)
            lib_err = (lib() - p_avg).abs().max().item()
            ms = cuda_ms(torch, lambda: kernel(params, codes), 20)
            plain_ms = cuda_ms(torch, lambda: plain(params, codes), 3)
            library_ms = cuda_ms(torch, lib, 20)
            flops = 2.0 * (2 * batch) * steps * units * gates * units
            n_bytes = (codes.numel() + 4 * sum(p.numel()
                                               for p in params.values())
                       + 4 * (avg.numel() + hidden.numel()))
            t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": 1e3 * max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            print(f"{name} {label} B={batch} T={steps} u={units}: "
                  f"max_abs_err={err:.3g} (cuDNN vs plain {lib_err:.3g}) "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"library_ms={library_ms:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})",
                  flush=True)
            if not err <= TOL:
                raise AssertionError(f"{name} {label}: kernel differs from "
                                     f"its plain version by {err}")
            results[(name, label)] = row
    return results


def predict_rows(argv, out_path):
    """Run the port's CLI; return the BED rows without the file column."""
    from deepgrp_tpu_torch import cli

    cli.main(argv + ["--output", out_path])
    with open(out_path) as fh:
        return [line.split("\t", 1)[1] for line in fh.read().splitlines()]


def expected_rows(name):
    with open(os.path.join(FIXDIR, f"{name}.bed")) as fh:
        return fh.read().splitlines()


def check_path(kernel: str):
    """Launch counts of the run just made; the kernel must have launched,
    the plain versions must not have run."""
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    launches, plain = cuda_rnn.LAUNCHES.snapshot(), rnn.PLAIN_CALLS.snapshot()
    print(f"  launches={launches} plain_calls={plain}", flush=True)
    if launches.get(kernel, 0) <= 0:
        raise AssertionError(f"{kernel} was not launched on this path")
    if plain:
        raise AssertionError(f"plain versions ran on the path: {plain}")
    return launches[kernel]


def reset_counts():
    from deepgrp_tpu_torch.models import cuda_rnn, rnn
    from deepgrp_tpu_torch.ops import mss_device

    cuda_rnn.LAUNCHES.reset()
    rnn.PLAIN_CALLS.reset()
    mss_device.LAUNCHES.reset()


class LandingClock:
    """Host-clock time at which the last slice copy a reader waited for
    had reached the host (``last``; wraps ``ScoredTrack.wait``), and at
    which the last call of ``postprocess.predict_sequence`` returned
    (``returned``): ``returned - last`` is the MSS tail, also of a CLI run
    (which looks the function up at call time)."""

    def __enter__(self):
        from deepgrp_tpu_torch.predict import postprocess
        from deepgrp_tpu_torch.predict.engine import ScoredTrack

        self.last = self.returned = None
        self._saved = (ScoredTrack.wait, postprocess.predict_sequence)
        wait_fn, sequence_fn = self._saved

        def wait(track, i):
            wait_fn(track, i)
            self.last = time.perf_counter()

        def predict_sequence(*args, **kwargs):
            out = sequence_fn(*args, **kwargs)
            self.returned = time.perf_counter()
            return out

        ScoredTrack.wait = wait
        postprocess.predict_sequence = predict_sequence
        return self

    def __exit__(self, *exc):
        from deepgrp_tpu_torch.predict import postprocess
        from deepgrp_tpu_torch.predict.engine import ScoredTrack

        ScoredTrack.wait, postprocess.predict_sequence = self._saved
        return False


def breakdown_phase(torch, fasta: str, man: dict) -> None:
    """Where the time of the real-size run goes: host clock around each
    stage of the predict path, the engine and the streaming host MSS as one
    stage (``predict_sequence`` at ``-t 1``, as the CLI runs it), with the
    MSS's tail after the last slice's bytes reached the host; then the
    engine alone (its copies landed) and the whole-array host MSS alone,
    the serial stages the overlap replaces; then one engine run under
    ``torch.profiler`` for the device time by kernel name."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.data.fasta import read_multi_fasta
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.ops import mss
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.ops.segments import yield_segments
    from deepgrp_tpu_torch.predict.engine import PredictionEngine
    from deepgrp_tpu_torch.predict.postprocess import predict_sequence

    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    engine = PredictionEngine(DeepGRPModel.from_params(config, params),
                              batch_size=1024, step_size=man["step_size"])
    options = Options(vecsize=config.vecsize, batch_size=1024,
                      min_mss_len=man["min_mss_len"],
                      xdrop_len=man["xdrop_len"])
    with open(fasta) as fh:  # warm-up at the real size (pinned memory)
        predict_sequence(engine, encode_codes_trimmed(
            next(read_multi_fasta(fh))[1])[1], options, threads=1)
    stages = {}
    clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        stages[name] = now - clock
        clock = now

    with open(fasta) as fh:
        _, sequence = next(read_multi_fasta(fh))
    lap("read")
    start, codes = encode_codes_trimmed(sequence)
    lap("encode")
    with LandingClock() as landed:
        labels = predict_sequence(engine, codes, options, threads=1)
    lap("engine + streaming MSS")
    tail = clock - landed.last
    rows = sum(1 for seg in yield_segments(labels, start) if seg[2] > 0)
    lap("segments")
    total = sum(stages.values())
    print(f"stages of the predict path ({rows} rows, {total:.4f} s): "
          + ", ".join(f"{k} {v:.4f} s ({100 * v / total:.1f}%)"
                      for k, v in stages.items()), flush=True)
    overlapped = stages["engine + streaming MSS"]
    print(f"MSS tail after the last slice landed: {tail:.4f} s "
          f"({100 * tail / overlapped:.1f}% of the overlapped stage)",
          flush=True)
    torch.cuda.synchronize()
    start_s = time.perf_counter()
    engine.scored_tracks(codes).finish()
    enqueue_s = time.perf_counter() - start_s
    torch.cuda.synchronize()
    print(f"the chunk loop's thread enqueues the whole engine stage in "
          f"{enqueue_s:.4f} s of host time (no copies; the card then finishes "
          f"it)", flush=True)
    start_s = time.perf_counter()
    classes, maxp = engine.predict_scored(codes)
    engine_s = time.perf_counter() - start_s
    scores = engine.predict_mss_scores(codes)[1].astype(np.float64)
    start_s = time.perf_counter()
    serial = mss.find_mss_classes(scores, classes.astype(np.int64),
                                  config.n_classes, man["min_mss_len"],
                                  man["xdrop_len"], threads=1)
    mss_s = time.perf_counter() - start_s
    print(f"serial, for comparison: engine alone {engine_s:.4f} s + "
          f"whole-array host MSS (-t 1) {mss_s:.4f} s = "
          f"{engine_s + mss_s:.4f} s; overlapped {overlapped:.4f} s; "
          f"labels equal: {bool(np.array_equal(serial, labels))}",
          flush=True)
    if not np.array_equal(serial, labels):
        raise AssertionError("the streaming MSS's labels differ from the "
                             "whole-array search's")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.predict_scored(codes)
        torch.cuda.synchronize()
    by_name = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    engine_ms = 1e3 * engine_s
    if busy_ms == 0:
        print("device time by kernel: not measured (the profiler saw no "
              "device events)", flush=True)
        return
    print(f"device busy {busy_ms:.2f} ms of the unprofiled engine stage's "
          f"{engine_ms:.2f} ms = {100 * busy_ms / engine_ms:.1f}% "
          f"(idle {100 - 100 * busy_ms / engine_ms:.1f}%)", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:90]}",
              flush=True)


def train_case(torch, gen, gates: int, batch: int, steps: int,
               units: int):
    """Random weights and codes, dropout masks and output cotangents."""
    params, codes = random_rnn(torch, gen, gates, batch, steps, units)
    keep = 1.0 - FLAGSHIP["dropout"]
    masks = torch.bernoulli(torch.full((gates, 2 * batch, 5), keep),
                            generator=gen) / keep
    d_avg = torch.randn(batch, steps, units, generator=gen)
    d_hid = torch.randn(batch, units, generator=gen)
    return params, codes, masks.cuda(), d_avg.cuda(), d_hid.cuda()


def check_train_kernels(torch, cell: str, case, masks):
    """A training kernel pair against its plain versions; returns the max
    abs differences of the forward outputs and of the gradients."""
    from deepgrp_tpu_torch.models import cuda_rnn

    params, codes, _, d_avg, d_hid = case
    plain_fwd, plain_bwd = cuda_rnn._PLAIN[cell]
    got = cuda_rnn.train_fwd(cell, params, codes, masks)
    torch.cuda.synchronize()
    want = plain_fwd(params, codes, masks)
    torch.cuda.synchronize()
    fwd_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    seqs = tuple(want[2:])
    grads = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                               d_hid)
    again = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                               d_hid)
    torch.cuda.synchronize()
    want_g = plain_bwd(params, codes, masks, *seqs, d_avg, d_hid)
    bwd_err = max((g - w).abs().max().item() for g, w in zip(grads, want_g))
    rel = max((g - w).abs().max().item() / w.abs().max().item()
              for g, w in zip(grads, want_g))
    bitwise = all(torch.equal(g, a) for g, a in zip(grads, again))
    tag = f"{cell} {'with' if masks is not None else 'without'} masks"
    print(f"  {tag}: forward max_abs_err={fwd_err:.3g}; gradients "
          f"max_abs_err={bwd_err:.3g} (max relative to the gradient's "
          f"largest magnitude {rel:.3g}); second backward bitwise equal: "
          f"{bitwise}", flush=True)
    if not fwd_err <= TOL:
        raise AssertionError(f"{tag}: train forward differs by {fwd_err}")
    if not rel <= GRAD_RTOL:
        raise AssertionError(f"{tag}: train backward relative error {rel}")
    if not bitwise:
        raise AssertionError(f"{tag}: train backward not deterministic")
    return fwd_err, bwd_err


def time_train_kernels(torch, cell: str, case, errors):
    """Times of a training kernel pair (with masks), its plain versions
    and cuDNN; the bound of each kernel; one result row each."""
    from deepgrp_tpu_torch.models import cuda_rnn

    params, codes, masks, d_avg, d_hid = case
    gates = 4 if cell == "lstm" else 3
    plain_fwd, plain_bwd = cuda_rnn._PLAIN[cell]
    out = cuda_rnn.train_fwd(cell, params, codes, masks)
    seqs = tuple(out[2:])
    grads = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                               d_hid)
    lib_fwd, lib_fwd_bwd = library_rnn_train(torch, gates, params, codes)
    ms = {
        "fwd": cuda_ms(torch, lambda: cuda_rnn.train_fwd(
            cell, params, codes, masks), 20),
        "bwd": cuda_ms(torch, lambda: cuda_rnn.train_bwd(
            cell, params, codes, masks, seqs, d_avg, d_hid), 20),
        "plain_fwd": cuda_ms(torch, lambda: plain_fwd(params, codes, masks),
                             3),
        "plain_bwd": cuda_ms(torch, lambda: plain_bwd(
            params, codes, masks, *seqs, d_avg, d_hid), 3),
        "lib_fwd": cuda_ms(torch, lib_fwd, 20),
        "lib_bwd": cuda_ms(torch, lib_fwd_bwd, 20),
    }
    # The backward's two parts: the recurrence kernel, then the reduction
    # kernel with the sum of its partials.
    cotangents = cuda_rnn._bwd_recurrence(cell, params, codes, masks, seqs,
                                          d_avg, d_hid)
    split = {
        "recurrence": cuda_ms(torch, lambda: cuda_rnn._bwd_recurrence(
            cell, params, codes, masks, seqs, d_avg, d_hid), 20),
        "reduction": cuda_ms(torch, lambda: cuda_rnn._train_reduce(
            seqs[0], codes, masks, gates, list(grads), *cotangents), 20),
    }
    print(f"  {cell}_train_bwd split: recurrence_ms="
          f"{split['recurrence']:.4f} reduction_ms="
          f"{split['reduction']:.4f} (backward kernel_ms={ms['bwd']:.4f})",
          flush=True)
    # Multiply-adds of the recurrent products: the forward's h U over both
    # rows; the backward recomputes them and adds d_rp U^T and
    # h_prev^T d_rp (3x).  Bytes: each input read once, each output
    # written once.
    batch, steps = codes.shape
    units = params["recurrent"].shape[0]
    fwd_flops = 2.0 * (2 * batch) * steps * units * gates * units
    in_bytes = (codes.numel() + 4 * masks.numel()
                + 4 * sum(p.numel() for p in params.values()))
    seq_bytes = 4 * sum(q.numel() for q in seqs)
    work = {
        "fwd": (fwd_flops, in_bytes + seq_bytes
                + 4 * (out[0].numel() + out[1].numel())),
        "bwd": (3 * fwd_flops, in_bytes + seq_bytes
                + 4 * (d_avg.numel() + d_hid.numel()
                       + sum(g.numel() for g in grads))),
    }
    rows = {}
    for kind, err in zip(("fwd", "bwd"), errors):
        flops, n_bytes = work[kind]
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
        row = {"max_abs_err": err, "ms": ms[kind],
               "plain_ms": ms[f"plain_{kind}"],
               "library_ms": ms[f"lib_{kind}"],
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"  {cell}_train_{kind}: kernel_ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.3f} library_ms="
              f"{row['library_ms']:.4f} (cuDNN "
              f"{'forward' if kind == 'fwd' else 'fwd+bwd'}) "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})",
              flush=True)
        rows[f"{cell}_train_{kind}"] = row
    return rows


def train_kernel_phase(torch):
    """Phase 6: each training kernel against its plain version; times."""
    from deepgrp_tpu_torch.models import cuda_rnn

    gen = torch.Generator().manual_seed(2025)
    results = {}
    for cell in ("gru", "lstm"):
        gates = 4 if cell == "lstm" else 3
        for label, (batch, steps, units) in TRAIN_SHAPES.items():
            case = train_case(torch, gen, gates, batch, steps, units)
            print_train_tile(cuda_rnn, cell, label, batch, steps, units)
            errors = check_train_kernels(torch, cell, case, case[2])
            check_train_kernels(torch, cell, case, None)
            for name, row in time_train_kernels(torch, cell, case,
                                                errors).items():
                results[(name, label)] = row
    # Widths past the window tile's registers, which the block-row
    # backward refused (dU beside U in shared memory stopped it at u=82 for LSTM
    # and u=94 for GRU); the LSTM at u=96 only, as before.
    for cell in ("gru", "lstm"):
        gates = 4 if cell == "lstm" else 3
        for label, (batch, steps, units) in TRAIN_WIDE_SHAPES.items():
            if cell == "lstm" and label != "u96":
                continue
            print_train_tile(cuda_rnn, cell, label, batch, steps, units)
            case = train_case(torch, gen, gates, batch, steps, units)
            check_train_kernels(torch, cell, case, case[2])
            check_train_kernels(torch, cell, case, None)
    return results


def print_train_tile(cuda_rnn, cell: str, label: str, batch: int,
                     steps: int, units: int) -> None:
    """The window tile of the training kernels (forward and the backward's
    recurrence)."""
    print(f"{cell} train {label} B={batch} T={steps} u={units}: window "
          f"tile {cuda_rnn.train_tile(cell, batch, units, steps)}",
          flush=True)


def check_counts(expected):
    """Launch counts of the run just made: each kernel of the path exactly
    as often as ``expected`` says; the plain versions must not have run."""
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    launches, plain = cuda_rnn.LAUNCHES.snapshot(), rnn.PLAIN_CALLS.snapshot()
    print(f"  launches={launches} plain_calls={plain}", flush=True)
    for kernel, count in expected.items():
        if launches.get(kernel, 0) != count:
            raise AssertionError(f"{kernel}: {launches.get(kernel, 0)} "
                                 f"launches on this path, expected {count}")
    if plain:
        raise AssertionError(f"plain versions ran on the path: {plain}")
    return launches


def write_training_files(np, tmp: str, seed: int = 7):
    """Synthetic learnable chromosomes (one-hot ``fwd`` .npz files) and
    their BED: random ACGT with, for each repeat class 1-4, 40 regions of
    300-1500 bp filled with a class-specific motif (5, 171, 300 and 1000
    bp long), in disjoint 5 kb slots, and a run of Ns at each end."""
    rng = np.random.default_rng(seed)
    motifs = {cls: rng.integers(0, 4, size) for cls, size in
              ((1, 5), (2, 171), (3, 300), (4, 1000))}
    bed, paths = [], {}
    for chrom, length in (("chrTrain", 2_000_000), ("chrValid", 500_000)):
        codes = rng.integers(0, 4, length).astype(np.int8)
        n_regions = 40 if length >= 1_000_000 else 10
        slots = rng.choice(length // 5000 - 2, 4 * n_regions,
                           replace=False) + 1
        for j, slot in enumerate(slots):
            cls = 1 + j // n_regions
            size = int(rng.integers(300, 1500))
            begin = int(slot) * 5000
            codes[begin:begin + size] = np.resize(motifs[cls], size)
            bed.append(f"{chrom}\t{begin}\t{begin + size}\t{cls}\n")
        codes[:1000] = 4
        codes[-1000:] = 4
        fwd = np.zeros((5, length), np.int8)
        fwd[codes, np.arange(length)] = 1
        paths[chrom] = os.path.join(tmp, f"{chrom}.npz")
        np.savez(paths[chrom], fwd=fwd)
        with open(os.path.join(tmp, f"{chrom}.fa"), "w") as fh:
            fh.write(f">{chrom}\n" + "".join("ACGTN"[c] for c in codes)
                     + "\n")
    with open(os.path.join(tmp, "repeats.bed"), "w") as fh:
        fh.writelines(bed)
    return paths["chrTrain"], paths["chrValid"], os.path.join(tmp,
                                                              "repeats.bed")


def run_train_cli(tmp: str, files, name: str, cli_args=(), **options):
    """``train ... --honor-toml`` through ``cli.main`` (``cli_args``: global
    flags before ``train``); returns the model path, the metrics records
    and the host seconds."""
    from deepgrp_tpu_torch import cli
    from deepgrp_tpu_torch.config import Options

    toml = os.path.join(tmp, f"{name}.toml")
    with open(toml, "w") as fh:
        Options(**options).to_toml(fh)
    logdir = os.path.join(tmp, f"{name}_log")
    model = os.path.join(tmp, f"{name}.npz")
    start = time.perf_counter()
    cli.main(["-b", "256", *cli_args, "train", toml, *files,
              "--honor-toml", "--logdir", logdir, "--modelfile", model])
    seconds = time.perf_counter() - start
    with open(os.path.join(logdir, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    return model, records, seconds


def check_losses(name: str, records, n_epochs: int) -> None:
    losses = [r["loss"] for r in records]
    print(f"{name}: epoch losses {losses}, val_losses "
          f"{[r['val_loss'] for r in records]}", flush=True)
    if len(records) != n_epochs:
        raise AssertionError(f"{name}: {len(records)} epochs, expected "
                             f"{n_epochs}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["val_loss"])
               for r in records):
        raise AssertionError(f"{name}: a loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall ({losses})")


def load_training_data(np, npz: str, bed: str, options):
    from deepgrp_tpu_torch.data import preprocess

    with np.load(npz) as arrays:
        fwd = arrays["fwd"]
    chrom = os.path.basename(npz).split(".")[0]
    labels = preprocess.preprocess_y(bed, chrom, fwd.shape[1],
                                     options.repeats_to_search)
    return preprocess.Data(*preprocess.drop_start_end_n(fwd, labels))


def plain_avg_train(torch, cell: str):
    """An autograd Function over the plain forward and backward of the
    training recurrence, for CUDA tensors (the port's Functions take the
    plain versions only for CPU tensors)."""
    from deepgrp_tpu_torch.models import cuda_rnn

    fwd, bwd = cuda_rnn._PLAIN[cell]

    class PlainAvgTrain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kernel, recurrent, bias, codes, masks):
            params = {"kernel": kernel, "recurrent": recurrent, "bias": bias}
            avg, hidden, *seqs = fwd(params, codes, masks)
            ctx.save_for_backward(kernel, recurrent, bias, codes, masks,
                                  *seqs)
            return avg, hidden

        @staticmethod
        def backward(ctx, d_avg, d_hidden):
            kernel, recurrent, bias, codes, masks, *seqs = ctx.saved_tensors
            params = {"kernel": kernel, "recurrent": recurrent, "bias": bias}
            return (*bwd(params, codes, masks, *seqs, d_avg, d_hidden), None,
                    None)

    return PlainAvgTrain


def step_parity(torch, model, codes, labels, masks) -> None:
    """One optimization step's loss and gradients through the kernels
    against the same through the plain versions."""
    from deepgrp_tpu_torch.models.model import (
        forward_logits_from_codes_train, head_logits)
    from deepgrp_tpu_torch.train.training import categorical_crossentropy

    config = model.config
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.params().items()}
    loss_k = categorical_crossentropy(forward_logits_from_codes_train(
        params, codes, config, masks), labels)
    grads_k = torch.autograd.grad(loss_k, list(params.values()))
    fn = plain_avg_train(torch, "lstm" if config.rnn == "LSTM" else "gru")
    avg, hidden = fn.apply(params["rnn.kernel"], params["rnn.recurrent"],
                           params["rnn.bias"], codes, masks)
    loss_p = categorical_crossentropy(
        head_logits(params, avg, hidden, config), labels)
    grads_p = torch.autograd.grad(loss_p, list(params.values()))
    loss_err = abs(loss_k.item() - loss_p.item())
    rel = {k: (a - b).abs().max().item() / b.abs().max().item()
           for k, a, b in zip(params, grads_k, grads_p)}
    print(f"one step, kernels vs plain versions: loss {loss_k.item():.6f} "
          f"vs {loss_p.item():.6f} (diff {loss_err:.3g}); gradient max abs "
          f"diff / largest magnitude: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()), flush=True)
    if not loss_err <= TOL:
        raise AssertionError(f"step loss differs by {loss_err}")
    if not max(rel.values()) <= GRAD_RTOL:
        raise AssertionError(f"step gradients differ: {rel}")


def train_breakdown_phase(torch, model_path: str, train_data, val_data,
                          options, tmp: str, label: str = "gru_att"):
    """Where one eager epoch's time goes: stream time between the stage
    boundaries of each step (CUDA events), device time by kernel name
    (``torch.profiler``) and the idle share against the host clock; then
    one step through the kernels against the plain versions; then the
    epoch with its step captured as a CUDA graph against the eager epoch
    (:func:`compare_captured`), and a captured ``Trainer.fit`` of 2 epochs
    against the eager one (:func:`fit_pair`)."""
    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.models import rnn
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import (
        DeepGRPModel, forward_logits_from_codes_train)
    from deepgrp_tpu_torch.train.optimizers import get_optimizer
    from deepgrp_tpu_torch.train.sampler import BatchSampler
    from deepgrp_tpu_torch.train.training import (categorical_crossentropy,
                                                  train_step)

    config, params = load_model(model_path)
    model = DeepGRPModel.from_params(config, params)
    optimizer = get_optimizer(options, model.parameters())
    device = model.device
    sampler = BatchSampler(options, train_data, device)
    gen = torch.Generator(device=device).manual_seed(11)
    rows, n_steps = 2 * sampler.batch_size, options.n_batches

    def batch():
        codes, labels = sampler.batch(gen)
        masks = rnn.input_dropout_masks(gen, rows, config.dropout,
                                        config.gates)
        return codes, labels, masks

    def epoch():
        losses = [train_step(model, optimizer, *batch())
                  for _ in range(n_steps)]
        return torch.stack(losses).mean().item()

    epoch()  # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    epoch()
    wall = time.perf_counter() - start
    print(f"{label}: one epoch of {n_steps} steps (batch "
          f"{sampler.batch_size}): {wall:.4f} s = {n_steps / wall:.2f} "
          f"steps/s", flush=True)

    names = ("sample + gather", "masks", "forward (recurrence + head)",
             "loss", "backward", "optimizer")
    stage_ms = dict.fromkeys(names, 0.0)
    for _ in range(n_steps):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 1)]
        events[0].record()
        codes, labels = sampler.batch(gen)
        events[1].record()
        masks = rnn.input_dropout_masks(gen, rows, config.dropout,
                                        config.gates)
        events[2].record()
        optimizer.zero_grad(set_to_none=True)
        logits = forward_logits_from_codes_train(model.params(), codes,
                                                 config, masks)
        events[3].record()
        loss = categorical_crossentropy(logits, labels)
        events[4].record()
        loss.backward()
        events[5].record()
        optimizer.step()
        events[6].record()
        torch.cuda.synchronize()
        for j, name in enumerate(names):
            stage_ms[name] += events[j].elapsed_time(events[j + 1])
    total = sum(stage_ms.values())
    print(f"{label}: stream time by stage over {n_steps} steps "
          f"({total:.3f} ms): "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in stage_ms.items())
          + f"; backward share {100 * stage_ms['backward'] / total:.1f}%",
          flush=True)

    print_device_time(label, device_time(torch, epoch), wall)
    step_parity(torch, model, *batch())

    compare_captured(torch, label, single_run(torch, config, params,
                                              options, sampler, seed=11),
                     n_steps)
    fit_pair(torch, Options(**{**options.todict(), "n_epochs": 2}),
             train_data, val_data, tmp, label)


def training_phase(torch, np, tmp: str):
    """Phase 7: train the flagship gru_att (and LSTM, shallower) through
    the CLI; returns the launch counts of each run."""
    from deepgrp_tpu_torch.config import Options

    start = time.perf_counter()
    train_npz, val_npz, bed = write_training_files(np, tmp)
    print(f"wrote the training files in {time.perf_counter() - start:.2f} s",
          flush=True)
    epochs, steps = 3, 20
    reset_counts()
    model, records, seconds = run_train_cli(
        tmp, (train_npz, val_npz, bed), "gru_att", n_epochs=epochs,
        n_batches=steps, **FLAGSHIP)
    launches = check_counts({"gru_train_fwd": epochs * steps,
                             "gru_train_bwd": epochs * steps,
                             "gru_avg": epochs})
    check_losses("gru_att", records, epochs)
    print(f"gru_att train CLI: {seconds:.3f} s for {epochs} x {steps} steps "
          f"(data, build of the samplers and model file included); epoch "
          f"seconds {[round(r['epoch_seconds'], 4) for r in records]}; "
          f"steps/s after the first epoch "
          f"{[round(steps / r['epoch_seconds'], 2) for r in records[1:]]}",
          flush=True)

    reset_counts()
    out = os.path.join(tmp, "valid.bed")
    rows = predict_rows(["-b", "1024", "predict", model,
                         os.path.join(tmp, "chrValid.fa")], out)
    check_path("gru_avg")
    print(f"predict with the trained model on chrValid: {len(rows)} BED "
          f"rows", flush=True)

    options = Options(n_epochs=epochs, n_batches=steps, batch_size=256,
                      **FLAGSHIP)
    train_breakdown_phase(torch, model,
                          load_training_data(np, train_npz, bed, options),
                          load_training_data(np, val_npz, bed, options),
                          options, tmp)

    lstm_epochs, lstm_steps = 2, 5
    lstm_options = {**FLAGSHIP, "attention": False, "rnn": "LSTM"}
    reset_counts()
    lstm_model, records, seconds = run_train_cli(
        tmp, (train_npz, val_npz, bed), "lstm", n_epochs=lstm_epochs,
        n_batches=lstm_steps, **lstm_options)
    lstm_launches = check_counts({
        "lstm_train_fwd": lstm_epochs * lstm_steps,
        "lstm_train_bwd": lstm_epochs * lstm_steps,
        "lstm_avg": lstm_epochs})
    check_losses("lstm", records, lstm_epochs)
    print(f"lstm train CLI: {seconds:.3f} s", flush=True)

    # The same run at the training ceiling, which each epoch's validation
    # (the inference kernel) and predict with the written model must
    # reach too.
    wide = LSTM_WIDE_UNITS
    reset_counts()
    wide_model, records, seconds = run_train_cli(
        tmp, (train_npz, val_npz, bed), f"lstm_u{wide}",
        n_epochs=lstm_epochs, n_batches=lstm_steps,
        **{**lstm_options, "units": wide})
    check_counts({"lstm_train_fwd": lstm_epochs * lstm_steps,
                  "lstm_train_bwd": lstm_epochs * lstm_steps,
                  "lstm_avg": lstm_epochs})
    check_losses(f"lstm u={wide}", records, lstm_epochs)
    print(f"lstm u={wide} train CLI: {seconds:.3f} s", flush=True)
    reset_counts()
    rows = predict_rows(["-b", "1024", "predict", wide_model,
                         os.path.join(tmp, "chrValid.fa")],
                        os.path.join(tmp, f"valid_lstm_u{wide}.bed"))
    check_path("lstm_avg")
    print(f"predict with the trained lstm u={wide} model on chrValid: "
          f"{len(rows)} BED rows", flush=True)

    options = Options(n_epochs=1, n_batches=steps, batch_size=256,
                      **lstm_options)
    train_breakdown_phase(torch, lstm_model,
                          load_training_data(np, train_npz, bed, options),
                          load_training_data(np, val_npz, bed, options),
                          options, tmp, label="lstm")
    return launches, lstm_launches


def bound(flops: float, n_bytes: float, peak_flops: float) -> dict:
    """The least time of the work on this card, and what bounds it."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def ptxas_usage(log: str, template: str) -> dict:
    """Registers and spill bytes of each instantiation of the kernel
    template ``template`` (keyed by its template arguments), from a build
    log of ``nvcc -Xptxas -v``."""
    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(template + r"I((?:L[ib]\d+E)+)E", m.group(1))
            entry = (", ".join(re.findall(r"L[ib](\d+)E", t.group(1)))
                     if t else None)
            continue
        if entry is None:
            continue
        usage = found.setdefault(entry, {"registers": 0, "spill_stores": 0,
                                         "spill_loads": 0})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage["spill_stores"] = int(m.group(1))
            usage["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage["registers"] = int(m.group(1))
    return found


def seq_kernel_phase(torch):
    """Phase 8a: the GRU sequence kernel against its plain version."""
    from deepgrp_tpu_torch import _build
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    _build.load_kernels("rnn_seq")
    log = (_build.BUILD_DIR / "rnn_seq.log").read_text()
    for args, usage in sorted(ptxas_usage(log, "SeqKernel").items()):
        print(f"ptxas SeqKernel<{args}> (slices, rows a group, U in "
              f"registers, bf16): {usage}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(2026)
    results = {}
    for label, dtype_name, (batch, steps, units) in SEQ_SHAPES:
        dtype = getattr(torch, dtype_name)
        params, _ = random_rnn(torch, gen, 3, 1, 1, units)
        x = torch.rand(batch, steps, 5, generator=gen).cuda().to(dtype)
        seq, last = cuda_rnn.gru_apply(params, x)
        torch.cuda.synchronize()
        p_seq, p_last = rnn.gru_apply(params, x)
        torch.cuda.synchronize()
        err = max((seq.float() - p_seq.float()).abs().max().item(),
                  (last.float() - p_last.float()).abs().max().item())
        cell = cudnn_module(torch, 3, params, dtype)
        reps = 5 if units > 128 else 20
        with torch.no_grad():
            lib_err = (cell(x)[0].float() - p_seq.float()).abs().max().item()
            library_ms = cuda_ms(torch, lambda: cell(x), reps)
        ms = cuda_ms(torch, lambda: cuda_rnn.gru_apply(params, x), reps)
        plain_ms = cuda_ms(torch, lambda: rnn.gru_apply(params, x), 3)
        # Multiply-adds of the input dot and the recurrent products; each
        # input read once (weights in x's dtype, biases float32), each
        # output written once.
        flops = 2.0 * batch * steps * (5 + units) * 3 * units
        size = x.element_size()
        n_bytes = (size * (x.numel() + params["kernel"].numel()
                           + params["recurrent"].numel())
                   + 4 * params["bias"].numel()
                   + size * (seq.numel() + last.numel()))
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, **bound(flops, n_bytes, peak)}
        tol = TOL if dtype == torch.float32 else BF16_TOL
        rows_a_cta, n_cta = cuda_rnn.seq_tile(batch, units, sms)
        layout = cuda_rnn.seq_layout(units, rows_a_cta)
        print(f"gru_seq {label} B={batch} T={steps} u={units} {dtype_name} "
              f"(tile {n_cta} CTAs x {rows_a_cta} rows, "
              f"{layout['rows_a_group']} rows a lane group of "
              f"{layout['slices']} slices a unit, U in {layout['u_in']}): "
              f"max_abs_err={err:.3g} (tolerance {tol:g}; "
              f"cuDNN vs plain {lib_err:.3g}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})",
              flush=True)
        if not err <= tol:
            raise AssertionError(f"gru_seq {label}: kernel differs from its "
                                 f"plain version by {err}")
        results[("gru_seq", label)] = row
    return results


def bf16_kernel_phase(torch):
    """Phase 8b: the bf16 variants of the fused kernels against their
    plain versions."""
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    gen = torch.Generator().manual_seed(2027)
    results = {}
    for name, (gates, _) in KERNELS.items():
        kernel = getattr(cuda_rnn, name)
        plain = getattr(rnn, f"{name}_plain")
        for label, (batch, steps, units) in {**SHAPES,
                                             **WIDE_SHAPES}.items():
            params, codes = random_rnn(torch, gen, gates, batch, steps,
                                       units)
            avg, hidden = kernel(params, codes, torch.bfloat16)
            torch.cuda.synchronize()
            p_avg, p_hidden = plain(params, codes, torch.bfloat16)
            torch.cuda.synchronize()
            err = max((avg.float() - p_avg.float()).abs().max().item(),
                      (hidden.float() - p_hidden.float()).abs().max().item())
            lib = library_rnn(torch, gates, params, codes, torch.bfloat16)
            ms = cuda_ms(torch, lambda: kernel(params, codes,
                                               torch.bfloat16), 20)
            plain_ms = cuda_ms(torch, lambda: plain(params, codes,
                                                    torch.bfloat16), 3)
            library_ms = cuda_ms(torch, lib, 20)
            flops = 2.0 * (2 * batch) * steps * units * gates * units
            n_bytes = (codes.numel() + 4 * sum(p.numel()
                                               for p in params.values())
                       + 2 * (avg.numel() + hidden.numel()))
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   **bound(flops, n_bytes, PEAK_BF16_FLOPS)}
            print(f"{name}_bf16 {label} B={batch} T={steps} u={units}: "
                  f"max_abs_err={err:.3g} (tolerance {BF16_TOL:g}) "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"library_ms={library_ms:.4f} (cuDNN bf16) "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, "
                  f"bf16 peak)", flush=True)
            if not err <= BF16_TOL:
                raise AssertionError(f"{name}_bf16 {label}: kernel differs "
                                     f"from its plain version by {err}")
            results[(f"{name}_bf16", label)] = row
    return results


class Recorder:
    """Keeps, for the CLI runs made inside it, each sequence's engine
    scores ``(classes, maxp)`` on the host and its MSS labels (wraps the
    engine's ``scored_tracks``, which every MSS route reads, and
    ``postprocess.predict_sequence``)."""

    def __enter__(self):
        from deepgrp_tpu_torch.predict import engine, postprocess

        self._tracks, self.labels = [], []
        self._saved = (engine.PredictionEngine.scored_tracks,
                       postprocess.predict_sequence)
        tracks_fn, sequence_fn = self._saved

        def scored_tracks(eng, codes):
            track = tracks_fn(eng, codes)
            self._tracks.append((track, codes.shape[0]))
            return track

        def predict_sequence(*args, **kwargs):
            out = sequence_fn(*args, **kwargs)
            self.labels.append(out)
            return out

        engine.PredictionEngine.scored_tracks = scored_tracks
        postprocess.predict_sequence = predict_sequence
        return self

    def __exit__(self, *exc):
        import numpy as np

        from deepgrp_tpu_torch.predict import engine, postprocess

        engine.PredictionEngine.scored_tracks = self._saved[0]
        postprocess.predict_sequence = self._saved[1]
        self.scored = [track.host_scored() if track is not None else
                       (np.zeros(n, np.int8), np.zeros(n, np.float32))
                       for track, n in self._tracks]
        self._tracks = []
        return False


def compare_runs(np, ref: "Recorder", got: "Recorder"):
    """Raw class agreement, post-MSS agreement and R_K MCC of ``got``
    against ``ref`` (one sequence each)."""
    from deepgrp_tpu_torch.predict import metrics

    raw_ref, raw_got = ref.scored[0][0], got.scored[0][0]
    lab_ref = np.asarray(ref.labels[0], np.int64)
    lab_got = np.asarray(got.labels[0], np.int64)
    mcc = metrics.calculate_multiclass_matthews_cc(
        metrics.confusion_matrix(lab_ref, lab_got))
    return (float((raw_ref == raw_got).mean()),
            float((lab_ref == lab_got).mean()), float(mcc))


def scan_and_bf16_phase(torch, np, tmp: str, fixture_runs, mbp_run,
                        man: dict, mbp_args):
    """Phase 9: the scan route and the bf16 fast mode through the CLI;
    returns the launch counts of the main-path runs of the new kernels."""
    launches = {}
    for name in ("gru_att", "gru", "lstm"):
        reset_counts()
        got = predict_rows(
            REF_ARGS + ["--rnn-kernel", "scan", "predict",
                        os.path.join(TORCH_FIXDIR, f"{name}.npz"),
                        os.path.join(FIXDIR, f"{name}.fa")],
            os.path.join(tmp, f"{name}_scan.bed"))
        if name == "lstm":  # no kernel: the LSTM over x is plain torch
            check_counts({})
        else:
            check_path("gru_seq")
        want = expected_rows(name)
        print(f"{name} --rnn-kernel scan: {len(got)} rows, expected "
              f"{len(want)}, identical={got == want}", flush=True)
        if got != want:
            raise AssertionError(f"{name} scan route: BED rows differ")

    reset_counts()
    start = time.perf_counter()
    with Recorder() as scan_run:
        got = predict_rows(["--rnn-kernel", "scan"] + mbp_args,
                           os.path.join(tmp, "mbp_scan.bed"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches["gru_seq"] = check_path("gru_seq")
    want = expected_rows("mbp")
    diff_p = float(np.abs(scan_run.scored[0][1]
                          - mbp_run.scored[0][1]).max())
    diff_c = int((scan_run.scored[0][0] != mbp_run.scored[0][0]).sum())
    print(f"mbp --rnn-kernel scan: {seconds:.3f} s = "
          f"{man['n_windows'] / seconds:.1f} windows/s; {len(got)} rows, "
          f"expected {len(want)}, identical={got == want}; largest max-"
          f"probability difference to the fused route {diff_p:.3g}, "
          f"{diff_c} positions of another class", flush=True)
    for row in sorted(set(got) ^ set(want))[:20]:
        print(f"  differing row: {row}", flush=True)
    if not diff_p <= TOL:
        raise AssertionError(f"mbp scan route: max probability differs "
                             f"from the fused route by {diff_p}")

    for name in ("gru_att", "gru", "lstm"):
        routes = ("fused",) if name == "lstm" else ("fused", "scan")
        for route in routes:
            reset_counts()
            with Recorder() as run:
                predict_rows(
                    REF_ARGS + ["--precision", "bfloat16", "--rnn-kernel",
                                route, "predict",
                                os.path.join(TORCH_FIXDIR, f"{name}.npz"),
                                os.path.join(FIXDIR, f"{name}.fa")],
                    os.path.join(tmp, f"{name}_{route}_bf16.bed"))
            cell = "lstm" if name == "lstm" else "gru"
            kernel = f"{cell}_avg_bf16" if route == "fused" else "gru_seq"
            count = check_path(kernel)
            if name == "lstm":
                launches["lstm_avg_bf16"] = count
            raw, post, mcc = compare_runs(np, fixture_runs[name], run)
            gated = name != "lstm"
            print(f"{name} --precision bfloat16 --rnn-kernel {route} vs "
                  f"float32: raw agreement {raw:.4f}, post-MSS {post:.4f}, "
                  f"R_K MCC {mcc:.4f} ({'gated' if gated else 'recorded'})",
                  flush=True)
            if gated and not (raw >= BF16_RAW_AGREE
                              and post >= BF16_POST_AGREE
                              and mcc >= BF16_MCC):
                raise AssertionError(f"{name} bf16 {route}: below the "
                                     "quality contract")

    reset_counts()
    start = time.perf_counter()
    with Recorder() as bf16_run:
        got = predict_rows(["--precision", "bfloat16"] + mbp_args,
                           os.path.join(tmp, "mbp_bf16.bed"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches["gru_avg_bf16"] = check_path("gru_avg_bf16")
    raw, post, mcc = compare_runs(np, mbp_run, bf16_run)
    print(f"mbp --precision bfloat16 (fused): {seconds:.3f} s = "
          f"{man['n_windows'] / seconds:.1f} windows/s; {len(got)} rows "
          f"(float32: {len(want)}); vs float32: raw agreement {raw:.4f}, "
          f"post-MSS {post:.4f}, R_K MCC {mcc:.4f} (recorded)", flush=True)
    return launches


def no_mss_phase(torch, np, tmp: str, man: dict, mbp_args, seq: str):
    """Phase 10: ``predict -m`` on the card against the CPU, the merged-
    probability track against the scored route on the 4.9 Mbp chromosome,
    and the seconds of ``-m`` beside the MSS route's."""
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.predict import postprocess
    from deepgrp_tpu_torch.predict.engine import PredictionEngine

    for name in ("gru_att", "gru", "lstm"):
        args = REF_ARGS + ["predict", os.path.join(TORCH_FIXDIR,
                                                   f"{name}.npz"),
                           os.path.join(FIXDIR, f"{name}.fa"), "-m"]
        reset_counts()
        card = predict_rows(args, os.path.join(tmp, f"{name}_m.bed"))
        check_path("lstm_avg" if name == "lstm" else "gru_avg")
        cpu = predict_rows(["--device", "cpu"] + args,
                           os.path.join(tmp, f"{name}_m_cpu.bed"))
        print(f"{name} predict -m: {len(card)} rows on the card, "
              f"{len(cpu)} with --device cpu, identical={card == cpu} "
              f"(the MSS route: {len(expected_rows(name))} rows)",
              flush=True)
        if card != cpu or not card:
            raise AssertionError(f"{name} predict -m: the card's BED rows "
                                 "differ from the CPU's")

    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    model = DeepGRPModel.from_params(config, params)
    codes = encode_codes_trimmed(seq)[1]
    for route in ("fused", "scan"):
        engine = PredictionEngine(model, batch_size=1024,
                                  step_size=man["step_size"],
                                  rnn_kernel=route)
        reset_counts()
        start = time.perf_counter()
        track = engine.predict(codes)
        predict_s = time.perf_counter() - start
        check_path("gru_avg" if route == "fused" else "gru_seq")
        start = time.perf_counter()
        postprocess.softmax(track).argmax(axis=1)
        softmax_s = time.perf_counter() - start
        classes, maxp = engine.predict_scored(codes)
        same_c = bool(np.array_equal(track.argmax(axis=1), classes))
        same_p = bool(np.array_equal(track.max(axis=1), maxp))
        print(f"mbp {route}: engine.predict track {track.shape} "
              f"{track.dtype} in {predict_s:.4f} s (the copy to the host "
              f"included), the host softmax + argmax {softmax_s:.4f} s; "
              f"row argmax == predict_scored classes: {same_c}, row max == "
              f"maxp: {same_p}", flush=True)
        if not (same_c and same_p):
            raise AssertionError(f"mbp {route}: the merged track disagrees "
                                 "with the scored route")

    for label, extra in (("MSS", []), ("-m", ["-m"]), ("-m", ["-m"]),
                         ("MSS", [])):
        reset_counts()
        start = time.perf_counter()
        rows = predict_rows(mbp_args + extra,
                            os.path.join(tmp, "mbp_route.bed"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        check_path("gru_avg")
        print(f"mbp predict {label}: {seconds:.4f} s = "
              f"{man['n_windows'] / seconds:.1f} windows/s; {len(rows)} "
              f"rows", flush=True)


def scan_training_phase(torch, np, tmp: str):
    """Phase 11: one step of the training scan route against one through
    the fused kernels at full width (gru_att, and LSTM at u=60), then
    ``train --rnn-kernel scan`` through the CLI beside the fused route."""
    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.models import cuda_rnn, rnn
    from deepgrp_tpu_torch.models.model import (DeepGRPModel, ModelConfig,
                                                init_params)
    from deepgrp_tpu_torch.train.sampler import BatchSampler
    from deepgrp_tpu_torch.train.training import step_loss

    files = write_training_files(np, tmp)
    for label, overrides in (("gru_att", {}),
                             ("lstm", {"rnn": "LSTM", "attention": False})):
        options = Options(batch_size=256, **{**FLAGSHIP, **overrides})
        config = ModelConfig.from_options(options)
        model = DeepGRPModel.from_params(
            config, init_params(config, torch.Generator().manual_seed(5)))
        sampler = BatchSampler(options, load_training_data(
            np, files[0], files[2], options), model.device)
        gen = torch.Generator(device=model.device).manual_seed(13)
        codes, labels = sampler.batch(gen)
        masks = rnn.input_dropout_masks(gen, 2 * sampler.batch_size,
                                        config.dropout, config.gates)
        runs = {}
        for fused in (True, False, True, False):
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss = step_loss(model, codes, labels, masks, fused)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = (cuda_rnn.LAUNCHES.snapshot(),
                      rnn.PLAIN_CALLS.snapshot())
            runs[fused] = (loss.item(), grads, seconds, counts)
        cell = "lstm" if label == "lstm" else "gru"
        want = {f"{cell}_train_fwd": 1, f"{cell}_train_bwd": 1}
        if runs[True][3] != (want, {}) or runs[False][3] != ({}, {}):
            raise AssertionError(f"{label}: launches (kernels, plain) of "
                                 f"the fused step {runs[True][3]}, of the "
                                 f"scan step {runs[False][3]}")
        loss_err = abs(runs[True][0] - runs[False][0])
        rel = {name: (a - b).abs().max().item() / b.abs().max().item()
               for (name, _), a, b in zip(model.named_parameters(),
                                          runs[False][1], runs[True][1])}
        print(f"{label} one step, scan route vs fused kernels: loss "
              f"{runs[False][0]:.6f} vs {runs[True][0]:.6f} (diff "
              f"{loss_err:.3g}); gradient max abs diff / largest magnitude: "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
              + f"; step seconds (forward + backward, second of two): scan "
              f"{runs[False][2]:.4f}, fused {runs[True][2]:.4f}",
              flush=True)
        if not loss_err <= TOL:
            raise AssertionError(f"{label}: scan-route loss differs by "
                                 f"{loss_err}")
        if not max(rel.values()) <= GRAD_RTOL:
            raise AssertionError(f"{label}: scan-route gradients differ: "
                                 f"{rel}")

    # The scan route's step captured as a CUDA graph against the eager
    # step: epochs of SCAN_GRAPH_STEPS steps in turns, then a captured
    # Trainer.fit of 2 x 3 steps against the eager one.
    options = Options(batch_size=256, n_epochs=2, n_batches=SCAN_GRAPH_STEPS,
                      **FLAGSHIP)
    config = ModelConfig.from_options(options)
    data = [load_training_data(np, path, files[2], options)
            for path in files[:2]]
    compare_captured(torch, "gru_att scan route", single_run(
        torch, config, init_params(config, torch.Generator().manual_seed(5)),
        options, BatchSampler(options, data[0], "cuda"), seed=13,
        fused=False), SCAN_GRAPH_STEPS)
    fit_pair(torch, Options(**{**options.todict(), "n_batches": 3}), *data,
             tmp, "gru_att scan", rnn_kernel="scan")

    epochs, steps = 2, 3
    for route in ("scan", "fused"):
        reset_counts()
        _, records, seconds = run_train_cli(
            tmp, files, f"gru_att_{route}", cli_args=("--rnn-kernel", route),
            n_epochs=epochs, n_batches=steps, **FLAGSHIP)
        trained = 0 if route == "scan" else epochs * steps
        check_counts({"gru_train_fwd": trained, "gru_train_bwd": trained,
                      "gru_seq": 0, "gru_avg": epochs})
        if len(records) != epochs or not all(
                math.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"train --rnn-kernel {route}: {records}")
        print(f"gru_att train --rnn-kernel {route}: {seconds:.3f} s for "
              f"{epochs} x {steps} steps; losses "
              f"{[r['loss'] for r in records]}; steps/s of epoch 2 "
              f"(its validation included) "
              f"{steps / records[-1]['epoch_seconds']:.2f}", flush=True)


@contextlib.contextmanager
def plain_training(torch):
    """The training recurrence through its plain versions on the card
    (``cuda_rnn.avg_train`` swapped for :func:`plain_avg_train`)."""
    from deepgrp_tpu_torch.models import cuda_rnn

    saved = cuda_rnn.avg_train

    def avg_train(cell, params, codes, masks):
        return plain_avg_train(torch, cell).apply(
            params["kernel"], params["recurrent"], params["bias"], codes,
            masks)

    cuda_rnn.avg_train = avg_train
    try:
        yield
    finally:
        cuda_rnn.avg_train = saved


def device_time(torch, fn):
    """Device time by kernel name (ms) of ``fn()`` under
    ``torch.profiler``; user annotations mirrored on the device timeline
    (e.g. ``Optimizer.step#RMSprop.step``) span kernels counted on their
    own and are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for event in prof.events():
        if (event.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(event, "is_user_annotation", False)):
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.time_range.elapsed_us() / 1e3)
    return by_name


def print_device_time(label: str, by_name: dict, wall: float) -> None:
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        print("device time by kernel: not measured (the profiler saw no "
              "device events)", flush=True)
        return
    print(f"{label}: device busy {busy_ms:.2f} ms of the unprofiled "
          f"epoch's {1e3 * wall:.2f} ms = {100 * busy_ms / (1e3 * wall):.1f}% "
          f"(idle {100 - 100 * busy_ms / (1e3 * wall):.1f}%)", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:90]}",
              flush=True)


def compare_captured(torch, label: str, make, n_steps: int,
                     turns: int = 4) -> dict:
    """A run's epochs eager and the same run's epochs with the step
    captured as a CUDA graph, in turns (eager first in even turns,
    captured first in odd ones).  ``make(capture)`` gives ``(epoch,
    state)``: ``epoch()`` runs one epoch of ``n_steps`` steps (ending in a
    host read, as a real epoch does) and returns its step losses,
    ``state()`` the tensors to hold equal (parameters, generator states).
    After every turn the two runs' losses and states must be equal bit for
    bit.  The first turn is the warm-up (the captured run's eager step and
    capture; the graph's memory is read there); steps/s from the others;
    then one more epoch of each under the profiler, its device busy share
    against that run's median unprofiled epoch."""
    runs = {capture: make(capture) for capture in (False, True)}
    walls = {False: [], True: []}
    graph_mb = None

    def check(when: str, losses) -> None:
        states = [runs[capture][1]() for capture in (False, True)]
        same = (all(torch.equal(a, b) for a, b in zip(*losses))
                and all(torch.equal(a, b) for a, b in zip(*states)))
        if not same:
            raise AssertionError(f"{label}: the captured run differs from "
                                 f"the eager one {when}")

    for turn in range(turns):
        order = (False, True) if turn % 2 == 0 else (True, False)
        losses = {}
        for capture in order:
            torch.cuda.synchronize()
            if turn == 0 and capture:
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
            start = time.perf_counter()
            losses[capture] = runs[capture][0]()
            torch.cuda.synchronize()
            walls[capture].append(time.perf_counter() - start)
            if turn == 0 and capture:
                torch.cuda.empty_cache()
                graph_mb = (torch.cuda.memory_reserved() - reserved) / 2**20
        check(f"after turn {turn + 1}", (losses[False], losses[True]))
    rates = {c: [n_steps / w for w in walls[c][1:]] for c in walls}
    medians = {c: sorted(walls[c][1:])[len(walls[c][1:]) // 2]
               for c in walls}
    print(f"{label}: captured vs eager, {turns - 1} timed turns of "
          f"{n_steps} steps after a warm-up turn, losses and states equal "
          f"bit for bit after every turn; steps/s eager "
          f"{[round(r, 2) for r in rates[False]]}, captured "
          f"{[round(r, 2) for r in rates[True]]}; median epoch eager "
          f"{medians[False]:.4f} s, captured {medians[True]:.4f} s "
          f"({medians[False] / medians[True]:.2f}x); warm-up turn eager "
          f"{walls[False][0]:.4f} s, captured (eager step, capture, "
          f"replays) {walls[True][0]:.4f} s; graph memory (its pool and "
          f"the run's state) {graph_mb:.1f} MiB", flush=True)
    losses, device_ms = {}, {}
    for capture in (False, True):
        def profiled(capture=capture):
            losses[capture] = runs[capture][0]()

        device_ms[capture] = device_time(torch, profiled)
        print_device_time(f"{label} {'captured' if capture else 'eager'}",
                          device_ms[capture], medians[capture])
    check("after the profiled epochs", (losses[False], losses[True]))
    return {"runs": runs, "steps_per_s": rates, "median_s": medians,
            "graph_mib": graph_mb, "device_ms": device_ms}


def single_run(torch, config, params, options, sampler, seed: int,
               fused: bool = True):
    """``make(capture)`` of :func:`compare_captured` for a single-device
    run: the model from ``params``, the options' optimizer, draws from a
    generator seeded ``seed``, and ``options.n_batches`` steps an epoch
    through ``EpochLoop``."""
    from deepgrp_tpu_torch.models import rnn
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.train.optimizers import get_optimizer
    from deepgrp_tpu_torch.train.training import EpochLoop, train_step

    def make(capture: bool):
        model = DeepGRPModel.from_params(config, params)
        optimizer = get_optimizer(options, model.parameters())
        gen = torch.Generator(device=model.device).manual_seed(seed)
        rows, rate = 2 * sampler.batch_size, float(config.dropout)

        def step():
            codes, labels = sampler.batch(gen)
            masks = (rnn.input_dropout_masks(gen, rows, rate, config.gates)
                     if rate > 0.0 else None)
            return train_step(model, optimizer, codes, labels, masks, fused)

        loop = EpochLoop(step, options.n_batches, model.device, capture,
                         [gen])

        def epoch():
            loop.epoch().item()
            return [loop.losses.clone()]

        return epoch, lambda: [*model.params().values(), gen.get_state()]

    return make


def fit_pair(torch, options, train_data, val_data, tmp: str, label: str,
             rnn_kernel: str = "fused", group=None) -> dict:
    """``Trainer.fit`` eager and captured from seed 0 (over ``group``
    when given): history, best parameters, the generator's state and the
    launch counts must be equal bit for bit, and no plain version may run.
    Returns the captured fit's launch counts."""
    from deepgrp_tpu_torch.models import cuda_rnn, rnn
    from deepgrp_tpu_torch.models.model import DeepGRPModel, ModelConfig
    from deepgrp_tpu_torch.train.training import Trainer

    runs = {}
    for capture in (False, True):
        model = DeepGRPModel(ModelConfig.from_options(options))
        trainer = Trainer(model, options,
                          os.path.join(tmp, f"{label}_fit_{capture}"),
                          tensorboard=False, rnn_kernel=rnn_kernel,
                          group=group, capture=capture)
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            best, history = trainer.fit(train_data, val_data, seed=0)
        finally:
            trainer.writer.close()
        seconds = time.perf_counter() - start
        runs[capture] = (history, best, trainer.generator.get_state(),
                         cuda_rnn.LAUNCHES.snapshot(),
                         rnn.PLAIN_CALLS.snapshot(), seconds)
    (history, best, state, launches, plain, _), want = runs[True], runs[False]
    same = (history == want[0] and launches == want[3]
            and torch.equal(state, want[2])
            and all(torch.equal(best[k], v) for k, v in want[1].items()))
    print(f"{label} Trainer.fit {options.n_epochs} x {options.n_batches} "
          f"steps (--rnn-kernel {rnn_kernel}), captured vs eager: history, "
          f"best parameters, generator state and launches equal bit for "
          f"bit: {same}; launches {launches}; seconds eager "
          f"{want[5]:.4f}, captured {runs[True][5]:.4f}; losses "
          f"{history['loss']}", flush=True)
    if not same or plain or want[4]:
        raise AssertionError(f"{label}: the captured fit differs from the "
                             f"eager one (plain calls {plain}, {want[4]})")
    return launches


def check_trials(trials, label: str) -> None:
    """Every trial ``STATUS_OK`` with a finite loss, and its logdir holds
    ``hparams.json``, ``metrics.jsonl`` with ``hpo/MCC`` and an events
    file."""
    from deepgrp_tpu_torch.hpo import STATUS_OK

    for trial in trials.trials:
        result = trial["result"]
        shown = {k: (round(v, 5) if isinstance(v, float) else v)
                 for k, v in trial["params"].items()}
        print(f"  {label}: {shown} -> {result['status']}, loss "
              f"{result['loss']}, error {result['error']!r}", flush=True)
        if result["status"] != STATUS_OK or not math.isfinite(
                result["loss"]):
            raise AssertionError(f"{label}: a trial failed: {result}")
        logdir = result["logdir"]
        names = os.listdir(logdir)
        with open(os.path.join(logdir, "metrics.jsonl")) as fh:
            mccs = [json.loads(line) for line in fh]
        if ("hparams.json" not in names
                or not any("hpo/MCC" in r for r in mccs)
                or not any(n.startswith("events.out.tfevents")
                           for n in names)):
            raise AssertionError(f"{label}: logdir {logdir} holds {names}")


def hpo_phase(torch, np, tmp: str):
    """Phase 12: the TPE sweep (serial trials with resume), the shape-
    bucketed sweep with a fleet, one fleet step against its plain
    versions, and the fleet's speed and device time."""
    import pickle

    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.hpo import (run_a_trial, run_bucketed_sweep,
                                       space, tpe, vmapped)
    from deepgrp_tpu_torch.hpo.bucketed import _group_by_bucket
    from deepgrp_tpu_torch.hpo.optimization import build_and_optimize
    from deepgrp_tpu_torch.models import cuda_rnn, rnn
    from deepgrp_tpu_torch.models.model import (DeepGRPModel, ModelConfig,
                                                init_params)
    from deepgrp_tpu_torch.train.optimizers import (fleet_optimizer,
                                                    get_optimizer)
    from deepgrp_tpu_torch.train.sampler import BatchSampler
    from deepgrp_tpu_torch.train.step_graph import StepGraph
    from deepgrp_tpu_torch.train.training import train_step

    train_npz, val_npz, bed = write_training_files(np, tmp)
    base = dict(batch_size=256, n_epochs=HPO_EPOCHS, n_batches=HPO_STEPS)
    probe = Options(**base)
    train_data = load_training_data(np, train_npz, bed, probe)
    val_data = load_training_data(np, val_npz, bed, probe)
    ref_space = space.reference_search_space()
    print(f"reference search space, each trial {HPO_EPOCHS} epochs x "
          f"{HPO_STEPS} steps at batch 256 (the reference's 200 x 250); "
          f"evaluation on chrValid ({val_data.fwd.shape[1]} bp) at step "
          f"{HPO_STEP_SIZE}", flush=True)

    serial_root = os.path.join(tmp, "serial")
    os.makedirs(serial_root)

    def objective(trial):
        options = Options(**base, project_root_dir=serial_root)
        return build_and_optimize(train_data, val_data, HPO_STEP_SIZE,
                                  options, trial)

    reset_counts()
    start = time.perf_counter()
    first = run_a_trial(ref_space, objective, serial_root, 2, seed=0)
    total = run_a_trial(ref_space, objective, serial_root, 1, seed=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    with open(os.path.join(serial_root, "results.pkl"), "rb") as fh:
        trials = pickle.load(fh)
    print(f"run_a_trial: {first} trials, resumed to {total} "
          f"(results.pkl: {len(trials)}); {seconds:.3f} s = "
          f"{seconds / total:.3f} s a serial trial", flush=True)
    if (first, total, len(trials)) != (2, 3, 3):
        raise AssertionError("results.pkl did not resume to 3 trials")
    check_trials(trials, "serial")
    check_counts({"gru_train_fwd": total * HPO_EPOCHS * HPO_STEPS,
                  "gru_train_bwd": total * HPO_EPOCHS * HPO_STEPS})

    # The first seed whose first round (4 startup proposals) puts two or
    # more of them in one shape bucket, so that a fleet trains.
    options = Options(**base)
    for seed in range(1 << 16):
        rng = np.random.default_rng(seed)
        proposals = [tpe.suggest(ref_space, tpe.Trials(), rng)
                     for _ in range(4)]
        buckets = _group_by_bucket(options, proposals)
        if max(len(v) for v in buckets.values()) >= 2:
            break
    bucket_root = os.path.join(tmp, "bucketed")
    os.makedirs(bucket_root)
    reset_counts()
    start = time.perf_counter()
    trials = run_bucketed_sweep(
        ref_space, Options(**base, project_root_dir=bucket_root),
        train_data, val_data, HPO_STEP_SIZE, bucket_root, max_evals=4,
        batch_evals=4, seed=seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    sizes = {key: len(members) for key, members in sorted(buckets.items())}
    print(f"run_bucketed_sweep (seed {seed}): {len(trials)} trials in "
          f"buckets (vecsize, units, one_class_size): trials {sizes}; "
          f"{seconds:.3f} s", flush=True)
    check_trials(trials, "bucketed")
    check_counts({"gru_train_fwd": 4 * HPO_EPOCHS * HPO_STEPS,
                  "gru_train_bwd": 4 * HPO_EPOCHS * HPO_STEPS})

    # One fleet step through the kernels against the plain versions.
    fleet_options = Options(**base, vecsize=200, units=34)
    config = ModelConfig.from_options(fleet_options)
    hp = vmapped.stack_trial_hyperparams(
        fleet_options, [{k: p[k] for k in vmapped.VARYING_KEYS if k in p}
                        for p in proposals])
    n_trials = len(proposals)
    trial_hp = [vmapped.trial_hyperparams(hp, i) for i in range(n_trials)]
    initial = [init_params(config, torch.Generator().manual_seed(i))
               for i in range(n_trials)]
    sampler = BatchSampler(fleet_options, train_data, "cuda")
    rows = 2 * sampler.batch_size
    generators = [torch.Generator(device="cuda").manual_seed(100 + i)
                  for i in range(n_trials)]

    def batch(i):
        codes, labels = sampler.batch(generators[i])
        rate = trial_hp[i]["dropout"]
        masks = (rnn.input_dropout_masks(generators[i], rows, rate,
                                         config.gates)
                 if rate > 0.0 else None)
        return codes, labels, masks

    def fleet():
        models = [DeepGRPModel.from_params(config, p) for p in initial]
        return models, fleet_optimizer(
            str(fleet_options.optimizer),
            [(m.parameters(), trial_hp[i]) for i, m in enumerate(models)])

    batches = [batch(i) for i in range(n_trials)]
    active = [i != 1 for i in range(n_trials)]
    runs = {}
    for plain in (False, True):
        models, optimizer = fleet()
        reset_counts()
        if plain:
            with plain_training(torch):
                losses = vmapped.fleet_step(models, optimizer, batches,
                                            active)
        else:
            losses = vmapped.fleet_step(models, optimizer, batches, active)
            check_counts({"gru_train_fwd": n_trials - 1,
                          "gru_train_bwd": n_trials - 1})
        runs[plain] = ([None if l is None else l.item() for l in losses],
                       [m.params() for m in models])
    loss_err = max(abs(a - b) for a, b in zip(runs[False][0], runs[True][0])
                   if a is not None)
    rel = max((a[k] - b[k]).abs().max().item() / b[k].abs().max().item()
              for i, (a, b) in enumerate(zip(runs[False][1], runs[True][1]))
              if active[i] for k in b)
    frozen = all(torch.equal(runs[False][1][1][k].cpu(), v)
                 for k, v in initial[1].items())
    print(f"one fleet step of {n_trials} trials (trial 1 frozen), kernels "
          f"vs plain versions: losses {runs[False][0]} vs {runs[True][0]} "
          f"(largest diff {loss_err:.3g}); updated parameters' max abs diff "
          f"/ largest magnitude {rel:.3g}; frozen trial unchanged bit for "
          f"bit: {frozen}", flush=True)
    if not (loss_err <= TOL and rel <= GRAD_RTOL and frozen):
        raise AssertionError("the fleet step through the kernels differs "
                             "from its plain versions")

    # Fleet speed: HPO_STEPS fleet steps of all trials against as many
    # serial steps of one, and the device time of a fleet epoch.
    models, optimizer = fleet()
    every = [True] * n_trials

    def fleet_epoch():
        for _ in range(HPO_STEPS):
            vmapped.fleet_step(models, optimizer,
                               [batch(i) for i in range(n_trials)], every)

    serial = DeepGRPModel.from_params(config, initial[0])
    serial_opt = get_optimizer(fleet_options, serial.parameters())

    def serial_epoch():
        for _ in range(HPO_STEPS):
            train_step(serial, serial_opt, *batch(0))

    walls = {}
    for name, fn in (("fleet", fleet_epoch), ("serial", serial_epoch)):
        fn()  # warm-up
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - start
    fleet_rate = HPO_STEPS / walls["fleet"]
    serial_rate = HPO_STEPS / walls["serial"]
    print(f"fleet of {n_trials} (vecsize 200, u=34, batch 256): "
          f"{fleet_rate:.2f} fleet steps/s = {n_trials * fleet_rate:.2f} "
          f"trial steps/s; one trial alone: {serial_rate:.2f} steps/s; "
          f"{n_trials} serial steps take {n_trials / serial_rate:.4f} s, a "
          f"fleet step {1 / fleet_rate:.4f} s", flush=True)
    reset_counts()
    by_name = device_time(torch, fleet_epoch)
    print(f"  fleet epoch launches={cuda_rnn.LAUNCHES.snapshot()} "
          f"plain_calls={rnn.PLAIN_CALLS.snapshot()}", flush=True)
    print_device_time(f"fleet epoch ({HPO_STEPS} steps)", by_name,
                      walls["fleet"])

    # The fleet step captured as one CUDA graph against the eager fleet
    # step, FLEET_GRAPH_STEPS steps an epoch, all trials active in the
    # timed and profiled epochs; then trial 1 freezes for two more epochs
    # (the captured run drops its graph and captures the other three's).
    fleets, frozen = {}, {}

    def fleet_run(capture):
        models, optimizer = fleet()
        gens = [torch.Generator(device="cuda").manual_seed(300 + i)
                for i in range(n_trials)]
        losses = torch.zeros(n_trials, device="cuda")
        active = [True] * n_trials
        run, epochs = [None], [0]
        fleets[capture] = models

        def trial_batch(i):
            codes, labels = sampler.batch(gens[i])
            rate = trial_hp[i]["dropout"]
            masks = (rnn.input_dropout_masks(gens[i], rows, rate,
                                             config.gates)
                     if rate > 0.0 else None)
            return codes, labels, masks

        def epoch():
            if epochs[0] == FLEET_FREEZE_EPOCH:
                active[1], run[0] = False, None
                frozen[capture] = [p.detach().clone()
                                   for p in models[1].parameters()]
            if run[0] is None:
                step = vmapped.fleet_steps(models, optimizer, trial_batch,
                                           active, losses)
                run[0] = (StepGraph(step, "cuda", [
                    g for g, on in zip(gens, active) if on])
                    if capture else step)
            record = []
            for _ in range(FLEET_GRAPH_STEPS):
                run[0]()
                record.append(losses.clone())
            losses.cpu()
            epochs[0] += 1
            return record

        return epoch, lambda: ([p for m in models for p in m.parameters()]
                               + [g.get_state() for g in gens])

    reset_counts()
    runs = compare_captured(torch, f"fleet of {n_trials}", fleet_run,
                            FLEET_GRAPH_STEPS)["runs"]
    for _ in range(2):
        losses = [runs[capture][0]() for capture in (False, True)]
        states = [runs[capture][1]() for capture in (False, True)]
        if not (all(torch.equal(a, b) for a, b in zip(*losses))
                and all(torch.equal(a, b) for a, b in zip(*states))):
            raise AssertionError("the captured fleet differs from the "
                                 "eager one after the freeze")
    # A run's epochs: FLEET_FREEZE_EPOCH of every trial, 2 without trial 1.
    trial_steps = 2 * FLEET_GRAPH_STEPS * (FLEET_FREEZE_EPOCH * n_trials
                                           + 2 * (n_trials - 1))
    check_counts({"gru_train_fwd": trial_steps,
                  "gru_train_bwd": trial_steps})
    for capture in (False, True):
        if not all(torch.equal(a, b) for a, b in zip(
                frozen[capture], fleets[capture][1].parameters())):
            raise AssertionError("the frozen trial's parameters moved")
    print("fleet: trial 1 frozen for 2 more epochs (a new graph of the "
          "other three): losses and states equal bit for bit, the frozen "
          "trial's parameters unchanged, every trial step counted once",
          flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_phase(torch, np, man: dict, seq: str, mbp_run: "Recorder"):
    """Phase 13a: the sharded engine over 4 and 3 shards on the one card
    against phase 4's single engine (the scored track in f32 and bf16,
    the boundary on the device and on the host) and ``mbp.bed``, and the
    ``lstm`` (f32, bf16) and ``gru_att`` (scan route) fixtures over 3
    shards; returns each kernel's launches on its first sharded run."""
    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.parallel.predict import ShardedPredictionEngine
    from deepgrp_tpu_torch.predict.engine import PredictionEngine

    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    model = DeepGRPModel.from_params(config, params, "cuda:0")
    startpos, codes = encode_codes_trimmed(seq)
    step, batch = man["step_size"], 1024
    options = Options(vecsize=config.vecsize, batch_size=batch,
                      min_mss_len=man["min_mss_len"],
                      xdrop_len=man["xdrop_len"])
    want_c, want_p = mbp_run.scored[0]
    want_rows = expected_rows("mbp")

    def same(a, b) -> bool:
        return a.shape == b.shape and bool(np.array_equal(
            a.view(np.uint8), b.view(np.uint8)))

    def engine(n_shards, dtype=torch.float32, collective=True):
        if n_shards == 1:
            return PredictionEngine(model, batch, step, dtype)
        return ShardedPredictionEngine(model, ["cuda:0"] * n_shards, batch,
                                       step, dtype, collective=collective)

    launches = {}
    for n_shards in (4, 3):
        sharded = engine(n_shards)
        reset_counts()
        rows = bed_rows(sharded, [(startpos, codes, man["header"])],
                        options)
        count = check_path("gru_avg")
        launches.setdefault("gru_avg", count)
        got_c, got_p = sharded.predict_scored(codes)
        other = engine(n_shards, collective=False).predict_scored(codes)
        ok = {"mbp.bed rows": rows == want_rows,
              "classes == phase 4": same(got_c, want_c),
              "maxp == phase 4": same(got_p, want_p),
              "collective False == True": (same(other[0], got_c)
                                           and same(other[1], got_p))}
        print(f"{n_shards} shards on cuda:0 (f32): {len(rows)} rows, "
              f"gru_avg launched {count} times; {ok}", flush=True)
        if not all(ok.values()):
            raise AssertionError(f"{n_shards} shards: {ok}")

    for name, dtype, route, kernel in (
            ("lstm", torch.float32, "fused", "lstm_avg"),
            ("lstm", torch.bfloat16, "fused", "lstm_avg_bf16"),
            ("gru_att", torch.float32, "scan", "gru_seq")):
        fixture_sharded(torch, np, name, dtype, route, kernel, launches)

    single_bf16 = engine(1, torch.bfloat16).predict_scored(codes)
    for n_shards in (4, 3):
        reset_counts()
        got = engine(n_shards, torch.bfloat16).predict_scored(codes)
        launches.setdefault("gru_avg_bf16", check_path("gru_avg_bf16"))
        ok = same(got[0], single_bf16[0]) and same(got[1], single_bf16[1])
        print(f"{n_shards} shards bf16: track == single bf16 track: {ok}",
              flush=True)
        if not ok:
            raise AssertionError(f"{n_shards} shards bf16: tracks differ")

    n_windows = man["n_windows"]
    engines = {n: engine(n) for n in (1, 4, 3)}
    for n_shards in (1, 4, 3, 3, 4, 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        engines[n_shards].predict_scored(codes)
        seconds = time.perf_counter() - start
        print(f"predict_scored, {n_shards} shard(s) on cuda:0: "
              f"{seconds:.4f} s = {n_windows / seconds:.1f} windows/s "
              f"(the engine stage only; phase 4 reads the CLI end to end)",
              flush=True)
    return launches


def bed_rows(engine, records, options) -> list:
    """The BED rows (without the file column) that ``predict`` writes for
    ``records`` of ``(startpos, codes, header)`` through ``engine`` (the
    CLI's loop, ``-t 1``)."""
    from deepgrp_tpu_torch.ops.segments import yield_segments
    from deepgrp_tpu_torch.predict.postprocess import predict_sequence

    rows = []
    for startpos, codes, header in records:
        classes = predict_sequence(engine, codes, options, threads=1)
        rows += ["{}\t{}\t{}\t{}".format(header, *segment)
                 for segment in yield_segments(classes, startpos)
                 if segment[2] > 0]
    return rows


def fixture_sharded(torch, np, name: str, dtype, route: str, kernel: str,
                    launches: dict) -> None:
    """A fixture through 3 shards on cuda:0 at the reference settings:
    each record's scored track bit for bit the single engine's and, in
    float32, the BED rows the reference's; ``kernel`` launched (its
    count lands in ``launches``) and no plain version."""
    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.data.fasta import read_multi_fasta
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.parallel.predict import ShardedPredictionEngine
    from deepgrp_tpu_torch.predict.engine import PredictionEngine

    config, params = load_model(os.path.join(TORCH_FIXDIR, f"{name}.npz"))
    model = DeepGRPModel.from_params(config, params, "cuda:0")
    args = dict(batch_size=64, step_size=50, compute_dtype=dtype,
                rnn_kernel=route)
    single = PredictionEngine(model, **args)
    sharded = ShardedPredictionEngine(model, ["cuda:0"] * 3, **args)
    options = Options(vecsize=config.vecsize, batch_size=64, min_mss_len=50,
                      xdrop_len=50)
    with open(os.path.join(FIXDIR, f"{name}.fa")) as fh:
        records = [encode_codes_trimmed(seq) + (header,)
                   for header, seq in read_multi_fasta(fh)]
    reset_counts()
    rows = bed_rows(sharded, records, options)
    launches.setdefault(kernel, check_path(kernel))
    same = all(
        all(a.tobytes() == b.tobytes() for a, b in
            zip(sharded.predict_scored(codes), single.predict_scored(codes)))
        for _, codes, _ in records)
    bed = rows == expected_rows(name) if dtype == torch.float32 else None
    print(f"{name} ({route}, {str(dtype).split('.')[-1]}) over 3 shards: "
          f"{len(records)} records, {len(rows)} rows; tracks == single "
          f"engine: {same}; rows == {name}.bed: {bed}", flush=True)
    if not same or bed is False:
        raise AssertionError(f"{name} over 3 shards differs")


def dp_batch(np, torch, gates: int):
    """The DP phase's global batch on the CPU: flagship windows (256 x
    342 codes), one-hot labels, dropout masks ``[gates, 512, 5]``."""
    from deepgrp_tpu_torch.models import rnn

    rng = np.random.default_rng(13)
    batch, steps = 256, FLAGSHIP["vecsize"]
    codes = torch.from_numpy(rng.integers(0, 6, (batch, steps))
                             .astype(np.int8))
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 5, (batch, steps))),
        5).to(torch.float32)
    masks = rnn.input_dropout_masks(torch.Generator().manual_seed(14),
                                    2 * batch, FLAGSHIP["dropout"], gates)
    return codes, labels, masks


def dp_model(torch, options):
    from deepgrp_tpu_torch.models.model import (DeepGRPModel, ModelConfig,
                                                init_params)

    config = ModelConfig.from_options(options)
    return DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(0)),
        "cuda:0")


#: The DP phase's models: the flagship, and the LSTM of its width.
DP_CELLS = {"gru": FLAGSHIP,
            "lstm": {**FLAGSHIP, "attention": False, "rnn": "LSTM"}}


def dp_worker(rank: int, tmp: str) -> None:
    """One of phase 13b's two ranks (a process of its own, both on
    cuda:0, gloo): one DP step of each of :data:`DP_CELLS` on its half of
    :func:`dp_batch`, then 2 x 3 DP training steps of the flagship on the
    synthetic chromosomes; writes ``tmp/rank{rank}.npz`` and ``.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import torch_dist_worker  # tests/: the rank's slice of a batch

    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.parallel.mesh import initialize_distributed
    from deepgrp_tpu_torch.parallel.train import dp_train_step
    from deepgrp_tpu_torch.train.optimizers import get_optimizer
    from deepgrp_tpu_torch.train.step_graph import StepGraph
    from deepgrp_tpu_torch.train.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Gloo runs the collectives on the host, which a graph cannot hold:
    # every graph captured in this process is counted, and must be none.
    graphs = []
    capture_fn = StepGraph._capture
    StepGraph._capture = lambda self: (graphs.append(1), capture_fn(self))
    initialize_distributed(f"file://{tmp}/rdzv", 2, rank, backend="gloo")
    try:
        out, step_launches = {}, {}
        for cell, widths in DP_CELLS.items():
            options = Options(batch_size=256, **widths)
            model = dp_model(torch, options)
            optimizer = get_optimizer(options, model.parameters())
            part = torch_dist_worker.rank_slice(
                dp_batch(np, torch, model.config.gates), rank, 2)
            reset_counts()
            loss = dp_train_step(model, optimizer,
                                 *(t.to("cuda:0") for t in part))
            step_launches.update(check_counts({f"{cell}_train_fwd": 1,
                                               f"{cell}_train_bwd": 1}))
            out.update({f"{cell}/{k}": v.detach().cpu().numpy()
                        for k, v in model.params().items()})
            out[f"{cell}/loss"] = loss.cpu().numpy()

        options = Options(batch_size=256, n_epochs=2, n_batches=3,
                          **FLAGSHIP)
        train_npz, val_npz, bed = (os.path.join(tmp, name) for name in
                                   ("chrTrain.npz", "chrValid.npz",
                                    "repeats.bed"))
        train = load_training_data(np, train_npz, bed, options)
        val = load_training_data(np, val_npz, bed, options)
        try:
            Trainer(dp_model(torch, options), options,
                    os.path.join(tmp, f"refused-{rank}"), tensorboard=False,
                    group=dist.group.WORLD, capture=True)
            refused = ""
        except ValueError as err:
            refused = str(err)
        trainer = Trainer(dp_model(torch, options), options,
                          os.path.join(tmp, f"log-{rank}"),
                          tensorboard=False, group=dist.group.WORLD)
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        best, history = trainer.fit(train, val)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        fit_launches = check_counts({"gru_train_fwd": 6, "gru_train_bwd": 6,
                                     "gru_avg": 2})
        if trainer.writer is not None:
            trainer.writer.close()
        out.update({f"fit/{k}": v.numpy() for k, v in best.items()})
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump({"history": history, "seconds": seconds,
                       "step_launches": step_launches,
                       "fit_launches": fit_launches,
                       "capture": trainer.capture, "graphs": len(graphs),
                       "refused": refused}, fh)
    finally:
        dist.destroy_process_group()


def dp_phase(torch, np, tmp: str) -> dict:
    """Phase 13b: two gloo ranks on the one card (processes of their own,
    :func:`dp_worker`) against one process on the whole batch; returns
    rank 0's launch counts of the 2 x 3 steps."""
    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.train.optimizers import get_optimizer
    from deepgrp_tpu_torch.train.training import train_step

    write_training_files(np, tmp)
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import chip_smoke; chip_smoke.dp_worker(int(sys.argv[3]), "
            "sys.argv[4])")
    start = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, HERE,
                               os.path.join(HERE, "tests"), str(rank), tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        print(f"-- rank {rank} (exit {proc.returncode}):\n{text.strip()}",
              flush=True)
        if proc.returncode:
            raise AssertionError(f"DP rank {rank} failed")
    print(f"two ranks: {time.perf_counter() - start:.2f} s, process start "
          f"included", flush=True)

    ranks, infos = [], []
    for rank in range(2):
        with np.load(os.path.join(tmp, f"rank{rank}.npz")) as data:
            ranks.append({k: data[k] for k in data.files})
        with open(os.path.join(tmp, f"rank{rank}.json")) as fh:
            infos.append(json.load(fh))
    for cell, widths in DP_CELLS.items():
        options = Options(batch_size=256, **widths)
        model = dp_model(torch, options)
        batch = dp_batch(np, torch, model.config.gates)
        loss = train_step(model, get_optimizer(options, model.parameters()),
                          *(t.to("cuda:0") for t in batch))
        loss_err = max(abs(float(r[f"{cell}/loss"]) - loss.item())
                       for r in ranks)
        rel = {}
        for key, value in model.params().items():
            want = value.detach().cpu().numpy()
            rel[key] = max(float(np.abs(r[f"{cell}/{key}"] - want).max())
                           for r in ranks) / float(np.abs(want).max())
        print(f"{cell} DP step (2 ranks x 128) vs one process (256): loss "
              f"{loss.item():.6f}, max diff {loss_err:.3g}; parameters max "
              f"abs diff / largest magnitude: "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()),
              flush=True)
        if not (loss_err <= TOL and max(rel.values()) <= GRAD_RTOL):
            raise AssertionError(f"{cell} DP step differs: loss "
                                 f"{loss_err}, {rel}")
    same = all(ranks[0][k].tobytes() == ranks[1][k].tobytes()
               for k in ranks[0])
    print(f"after 2 x 3 DP steps: parameters bitwise equal across ranks: "
          f"{same}; histories {infos[0]['history']} / "
          f"{infos[1]['history']}; fit seconds "
          f"{[round(i['seconds'], 4) for i in infos]}", flush=True)
    if not same or infos[0]["history"] != infos[1]["history"]:
        raise AssertionError("the ranks' parameters or histories differ")
    print(f"gloo ranks: capture {[i['capture'] for i in infos]}, graphs "
          f"captured {[i['graphs'] for i in infos]}; capture=True refused: "
          f"{infos[0]['refused']!r}", flush=True)
    if any(i["capture"] or i["graphs"] or "gloo" not in i["refused"]
           for i in infos):
        raise AssertionError("a gloo rank captured a graph, or took "
                             "capture=True")
    if os.path.exists(os.path.join(tmp, "log-1")):
        raise AssertionError("rank 1 wrote a logdir")
    return {"step": infos[0]["step_launches"],
            "fit": infos[0]["fit_launches"]}


def nccl_cli_phase(torch, np, tmp: str) -> None:
    """Phase 13c: the default backend (``cpu:gloo,cuda:nccl``) at world
    size 1: one NCCL all_reduce, then ``predict`` and ``train`` through
    the CLI's launch flags."""
    import torch.distributed as dist

    from deepgrp_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        value = torch.ones(4, device="cuda:0")
        dist.all_reduce(value)
        torch.cuda.synchronize()
        print(f"world 1, backend {dist.get_backend()}: all_reduce on "
              f"cuda:0 -> {value.tolist()}", flush=True)
    finally:
        dist.destroy_process_group()

    def flags():
        return ["--coordinator", f"127.0.0.1:{free_port()}",
                "--num-processes", "1", "--process-id", "0"]

    reset_counts()
    got = predict_rows(REF_ARGS + flags() + [
        "predict", os.path.join(TORCH_FIXDIR, "gru_att.npz"),
        os.path.join(FIXDIR, "gru_att.fa")],
        os.path.join(tmp, "gru_att_nccl.bed"))
    check_path("gru_avg")
    print(f"predict with the launch flags: {len(got)} rows, identical="
          f"{got == expected_rows('gru_att')}", flush=True)
    if got != expected_rows("gru_att") or dist.is_initialized():
        raise AssertionError("predict with the launch flags")

    files = write_training_files(np, tmp)
    reset_counts()
    _, records, seconds = run_train_cli(tmp, files, "nccl", flags(),
                                        n_epochs=2, n_batches=3, **FLAGSHIP)
    check_counts({"gru_train_fwd": 6, "gru_train_bwd": 6, "gru_avg": 2})
    print(f"train with the launch flags: 2 x 3 steps in {seconds:.3f} s, "
          f"losses {[r['loss'] for r in records]}", flush=True)
    if len(records) != 2 or dist.is_initialized():
        raise AssertionError("train with the launch flags")


MSS_STACK_REPLACES = "deepgrp_tpu/ops/mss_device.py:160"
MSS_ROUTES = {"auto -t 1": (["-t", "1"], "auto"),
              "auto -t 0": (["-t", "0"], "auto"),
              "on": ([], "on"), "off": ([], "off")}
# The noisy track of phase 14: random weights at the flagship's width.
NOISY_BP = 1 << 20


def mss_launches():
    from deepgrp_tpu_torch.ops import mss_device

    return mss_device.LAUNCHES.snapshot()


def check_mss_route(route: str, on_card: bool = False) -> int:
    """``dg_mss_stack``'s launches on the run just made: at least one on
    the ``on`` route (and where ``on_card`` says the route runs the MSS on
    the card), none on the others; never the plain scan."""
    counts = mss_launches()
    launched = counts.get("mss_stack", 0)
    if counts.get("mss_stack_plain", 0):
        raise AssertionError(f"{route}: the plain stack scan ran: {counts}")
    if (launched > 0) != (route == "on" or on_card):
        raise AssertionError(f"{route}: dg_mss_stack launched {launched} "
                             "times")
    return launched


def mss_routes_phase(torch, np, tmp: str, man: dict, seq: str) -> dict:
    """Phase 14: the MSS routes of ``predict`` on the card; returns
    ``dg_mss_stack``'s kernel row, with its launches on the main path (the
    ``on`` route of the 4.9 Mbp run)."""
    import synth_mbp  # numpy only

    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import (DeepGRPModel, ModelConfig,
                                                init_params)
    from deepgrp_tpu_torch.ops import mss, mss_device
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.parallel.predict import ShardedPredictionEngine
    from deepgrp_tpu_torch.predict import engine as engine_lib, postprocess
    from deepgrp_tpu_torch.predict.engine import (PredictionEngine,
                                                  mss_score_transform)

    fasta = os.path.join(tmp, "mbp.fa")
    synth_mbp.write_fasta(fasta, man["header"], seq)
    mbp_args = ["-b", "1024", "-s", str(man["step_size"]), "-x",
                str(man["xdrop_len"]), "-l", str(man["min_mss_len"])]
    model_path = os.path.join(TORCH_FIXDIR, "gru_att.npz")
    want = expected_rows("mbp")
    seconds = {}
    main_launches = None
    # The 4.9 Mbp chromosome through the CLI on every route, in turns.
    order = list(MSS_ROUTES) + list(reversed(MSS_ROUTES))
    for route in order:
        flags, choice = MSS_ROUTES[route]
        argv = flags + mbp_args + ["predict", model_path, fasta,
                                   "--device-mss", choice]
        reset_counts()
        with LandingClock() as landed:
            start = time.perf_counter()
            rows = predict_rows(argv, os.path.join(tmp, "mbp_mss.bed"))
            torch.cuda.synchronize()
            end = time.perf_counter()
        check_path("gru_avg")
        count = check_mss_route(route)
        if route == "on" and main_launches is None:
            main_launches = count
        seconds.setdefault(route, []).append(end - start)
        tail = (f"; MSS tail after the last slice landed "
                f"{landed.returned - landed.last:.4f} s (then "
                f"{end - landed.returned:.4f} s to the written BED)"
                if choice == "auto" else "")
        print(f"mbp --device-mss {route}: {len(rows)} rows, identical="
              f"{rows == want}, {end - start:.4f} s = "
              f"{man['n_windows'] / (end - start):.1f} windows/s end to "
              f"end{tail}; dg_mss_stack launches {count}", flush=True)
        if rows != want:
            raise AssertionError(f"mbp --device-mss {route}: rows differ")
    print("mbp seconds by route (two turns): " + ", ".join(
        f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in seconds.items()),
        flush=True)

    # The three fixtures through each route.
    for name in ("gru_att", "gru", "lstm"):
        for route in ("auto", "on", "off"):
            reset_counts()
            rows = predict_rows(
                REF_ARGS + ["predict", os.path.join(TORCH_FIXDIR,
                                                    f"{name}.npz"),
                            os.path.join(FIXDIR, f"{name}.fa"),
                            "--device-mss", route],
                os.path.join(tmp, f"{name}_{route}.bed"))
            check_path("lstm_avg" if name == "lstm" else "gru_avg")
            check_mss_route(route)
            if rows != expected_rows(name):
                raise AssertionError(f"{name} --device-mss {route}: rows "
                                     "differ")
        print(f"{name}: rows == {name}.bed on auto, on and off", flush=True)

    config, params = load_model(model_path)
    model = DeepGRPModel.from_params(config, params, "cuda:0")
    startpos, codes = encode_codes_trimmed(seq)
    step, batch = man["step_size"], 1024
    options = Options(vecsize=config.vecsize, batch_size=batch,
                      min_mss_len=man["min_mss_len"],
                      xdrop_len=man["xdrop_len"])

    # The routes inside one process, without the FASTA read and encoding:
    # predict_sequence on the encoded chromosome, in turns.
    single = PredictionEngine(model, batch, step)
    by_route = {route: [] for route in MSS_ROUTES}
    for turn in range(3):
        for route in (order if turn % 2 == 0 else reversed(order)):
            flags, choice = MSS_ROUTES[route]
            torch.cuda.synchronize()
            start = time.perf_counter()
            postprocess.predict_sequence(single, codes, options,
                                         threads=int(flags[1]) if flags
                                         else 1, device_mss=choice)
            torch.cuda.synchronize()
            by_route[route].append(time.perf_counter() - start)
    print("predict_sequence seconds by route (engine and MSS, 6 runs each, "
          "median): " + ", ".join(
              f"{k} {float(np.median(v)):.4f} (min {min(v):.4f}, max "
              f"{max(v):.4f})" for k, v in by_route.items()), flush=True)

    # 4 shards on cuda:0, auto: this sparse track's MSS runs on the card.
    sharded = ShardedPredictionEngine(model, ["cuda:0"] * 4, batch, step)
    runs = sharded.scored_tracks(codes).count_runs()
    taken = []
    real_on_device = postprocess.apply_mss_on_device

    def spy(*args, **kwargs):
        taken.append(kwargs.get("runs"))
        return real_on_device(*args, **kwargs)

    postprocess.apply_mss_on_device = spy
    try:
        reset_counts()
        start = time.perf_counter()
        rows = bed_rows(sharded, [(startpos, codes, man["header"])],
                        options)
        shard_s = time.perf_counter() - start
    finally:
        postprocess.apply_mss_on_device = real_on_device
    check_path("gru_avg")
    shard_launches = check_mss_route("4 shards auto", on_card=True)
    print(f"4 shards on cuda:0, auto: {runs} positive runs (threshold "
          f"{postprocess.DEVICE_MSS_AUTO_MAX_RUNS}), MSS on the card for "
          f"runs {taken}, dg_mss_stack launches {shard_launches}, "
          f"{len(rows)} rows, identical={rows == want}, {shard_s:.4f} s "
          f"(engine and MSS)", flush=True)
    if taken != [runs] or rows != want:
        raise AssertionError("4 shards auto: not the MSS on the card, or "
                             "rows differ")

    # bf16: every route's classes equal the off route's, bit for bit.
    single16 = PredictionEngine(model, batch, step, torch.bfloat16)
    sharded16 = ShardedPredictionEngine(model, ["cuda:0"] * 4, batch, step,
                                        torch.bfloat16)
    want16 = postprocess.predict_sequence(single16, codes, options,
                                          threads=1, device_mss="off")
    for label, engine, route, threads in (
            ("auto -t 1", single16, "auto", 1),
            ("auto -t 0", single16, "auto", 0), ("on", single16, "on", 1),
            ("4 shards auto", sharded16, "auto", 1)):
        mss_device.LAUNCHES.reset()
        got = postprocess.predict_sequence(engine, codes, options,
                                           threads=threads, device_mss=route)
        check_mss_route(label, on_card=label == "4 shards auto")
        same = bool(np.array_equal(np.asarray(got, np.int64),
                                   np.asarray(want16, np.int64)))
        print(f"bf16 {label}: classes == bf16 off: {same}", flush=True)
        if not same:
            raise AssertionError(f"bf16 {label}: classes differ from off")

    # dg_mss_stack against its plain version on the track's runs.
    track = single.scored_tracks(codes)
    classes_d, maxp_d = track.device()
    scores_d, _ = mss_device.scored_to_scores(classes_d, maxp_d,
                                              codes.shape[0])
    covered = min(codes.shape[0], classes_d.shape[0])
    host_c, host_p = track.host_scored()
    host_scores = mss_score_transform(host_c[:covered], host_p[:covered])
    dev_scores = scores_d[:covered].cpu().numpy()
    ulps = np.abs(dev_scores.view(np.int32).astype(np.int64)
                  - host_scores.view(np.int32).astype(np.int64))
    print(f"device score transform against the host's: {int((ulps > 0).sum())}"
          f" of {ulps.size} positions differ, by at most {int(ulps.max())} "
          f"ulp (recorded, not gated: the gate is the BED)", flush=True)
    n_runs = mss_device.count_positive_runs(scores_d)
    cand = mss_device.collapse_runs(scores_d, mss_device.run_capacity(n_runs))
    min_score, xdrop = mss.mss_thresholds(man["min_mss_len"],
                                          man["xdrop_len"])
    seg_s, seg_e, count = mss_device.mss_stack(cand, min_score, xdrop)
    torch.cuda.synchronize()
    cpu_cand = mss_device.Candidates(*(t.cpu() for t in cand))
    start = time.perf_counter()
    plain = mss_device.mss_stack(cpu_cand, min_score, xdrop)
    plain_ms = 1e3 * (time.perf_counter() - start)
    n_seg = int(count)
    err = max(abs(n_seg - int(plain[2])),
              int((seg_s.cpu() - plain[0]).abs().max()),
              int((seg_e.cpu() - plain[1]).abs().max()))
    ms = cuda_ms(torch, lambda: mss_device.mss_stack(cand, min_score, xdrop),
                 20)
    n_bytes = 24 * n_runs + 8 * n_seg
    row = {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * n_bytes / PEAK_BYTES, "bound_by": "bytes",
           "library_ms": None, "launches": main_launches}
    print(f"dg_mss_stack on the 4.9 Mbp track: {n_runs} runs, {n_seg} "
          f"segments, max_abs_err={err} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.6f} (bytes; "
          f"the chain of dependent loads bounds it in fact)", flush=True)
    if err:
        raise AssertionError("dg_mss_stack differs from its plain version")

    # The slice copy rate: one slice's bytes, and the whole track's,
    # device to pinned host on a side stream.
    maxp_size = 4
    slice_bytes = (maxp_size + 1) * engine_lib.SLICE_CHUNKS * batch * step
    for label, n in (("a slice", slice_bytes),
                     ("the track", track.rows.buf.numel())):
        n = min(n, track.rows.buf.numel())
        src = track.rows.buf[:n]
        dst = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            copy_ms = cuda_ms(
                torch, lambda: dst.copy_(src, non_blocking=True), 20)
        print(f"copy of {label} ({n} B) to pinned host memory: "
              f"{copy_ms:.4f} ms = {n / copy_ms / 1e6:.2f} GB/s", flush=True)

    # A noisy track (random weights): a forced overflow and its retry.
    noisy_config = ModelConfig(vecsize=config.vecsize, units=config.units,
                               attention=True, dropout=0.0)
    noisy = DeepGRPModel.from_params(
        noisy_config, init_params(noisy_config,
                                  torch.Generator().manual_seed(5)),
        "cuda:0")
    noisy_codes = np.random.default_rng(5).integers(
        0, 5, NOISY_BP).astype(np.int8)
    engine = PredictionEngine(noisy, batch, step)
    classes_d, maxp_d, _ = engine.predict_scored_device(noisy_codes)
    runs = postprocess.scored_run_count(classes_d, maxp_d, NOISY_BP)
    _, overflow = mss_device.mss_classes_from_scored(
        classes_d, maxp_d, NOISY_BP, config.n_classes, options.min_mss_len,
        options.xdrop_len, max_runs=64)
    capacities = []
    real_from_scored = mss_device.mss_classes_from_scored

    def count_capacity(*args, max_runs):
        capacities.append(max_runs)
        return real_from_scored(*args, max_runs=max_runs)

    mss_device.mss_classes_from_scored = count_capacity
    try:
        start = time.perf_counter()
        got = postprocess.apply_mss_on_device(classes_d, maxp_d, options,
                                              config.n_classes, NOISY_BP,
                                              runs=1)
        retry_s = time.perf_counter() - start
    finally:
        mss_device.mss_classes_from_scored = real_from_scored
    want_noisy = postprocess.predict_sequence(engine, noisy_codes, options,
                                              device_mss="off")
    same = bool(np.array_equal(np.asarray(got, np.int64),
                               np.asarray(want_noisy, np.int64)))
    print(f"noisy track ({NOISY_BP} bp, random weights): {runs} positive "
          f"runs; capacity 64 overflows: {bool(overflow)}; the retry went "
          f"through capacities {capacities} in {retry_s:.4f} s; classes == "
          f"off: {same}", flush=True)
    if not (bool(overflow) and capacities[-1] >= runs and same):
        raise AssertionError("noisy track: overflow or retry failed")
    return row


#: Phase 15's RepeatMasker families by class (rep, family) and rows of
#: families ``parse_rm`` drops.
RM_FAMILIES = {1: ("(GGAAT)n", "Satellite"),
               2: ("ALR/Alpha", "Satellite/centr"),
               3: ("AluY", "SINE/Alu"), 4: ("L1PA2", "LINE/L1")}
RM_DROPPED = [("MER5A", "DNA/hAT-Charlie"), ("(CACAC)n", "Simple_repeat"),
              ("Tigger1", "DNA/TcMar-Tigger"), ("(GGAATG)n", "Satellite")]


def write_workflow_inputs(np, tmp: str, seed: int = 7):
    """Phase 7's chromosomes as gzip FASTA files (60 bases a line) and
    their regions as one RepeatMasker ``.out`` file: classic rows
    (1-based) and every fifth region as a tab-separated row (0-based),
    class 1 as ``(GGAAT)n`` Satellite rows and one mutated-motif
    ``(GGAATGGAGT)n`` row, and rows of families ``parse_rm`` drops.
    Returns phase 7's files and the new ones."""
    import gzip

    train_npz, val_npz, bed = write_training_files(np, tmp, seed)
    fasta = {}
    for chrom in ("chrTrain", "chrValid"):
        with open(os.path.join(tmp, f"{chrom}.fa")) as fh:
            header, seq = fh.read().split("\n")[:2]
        fasta[chrom] = os.path.join(tmp, f"{chrom}.fa.gz")
        with gzip.open(fasta[chrom], "wt", compresslevel=1) as fh:
            fh.write(header + "\n")
            fh.writelines(seq[i:i + 60] + "\n"
                          for i in range(0, len(seq), 60))
    rows = []
    with open(bed) as fh:
        regions = [line.split() for line in fh]
    for i, (chrom, begin, end, cls) in enumerate(regions):
        rep, family = RM_FAMILIES[int(cls)]
        if i == 0:
            rep = "(GGAATGGAGT)n"  # one exact chunk, one mutated chunk
        if i % 5 == 4:
            fam, _, sub = family.partition("/")
            rows.append("\t".join([str(i), "0", "0", "0", "0", chrom, begin,
                                   end, "0", "+", rep, fam, sub or fam]))
        else:
            rows.append(f"  {100 + i} 1.0 0.5 0.5 {chrom} {int(begin) + 1} "
                        f"{end} (0) + {rep} {family} 1 100 (0) {i}")
    for j, (rep, family) in enumerate(RM_DROPPED):
        rows.append(f"  50 2.0 0.0 0.0 chrTrain {1000 + 300 * j} "
                    f"{1200 + 300 * j} (0) C {rep} {family} (0) 200 1 {j}")
    out = os.path.join(tmp, "genome.fa.out")
    with open(out, "w") as fh:
        fh.write("   SW  perc perc perc  query   position in query\n\n")
        fh.writelines(row + "\n" for row in rows)
    return (train_npz, val_npz, bed), fasta, out


def run_tool(module: str, *args: str) -> float:
    """``python -m deepgrp_tpu_torch.data.<module> ARGS`` in a process of
    its own; its host seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([HERE, env.get("PYTHONPATH", "")])
    start = time.perf_counter()
    subprocess.run([sys.executable, "-m", f"deepgrp_tpu_torch.data.{module}",
                    *args], env=env, check=True, timeout=300)
    return time.perf_counter() - start


def trace_names(directory: str, command: str, names) -> dict:
    """Which of ``names`` the one ``torch.profiler`` trace of ``command``
    under ``directory`` holds (its size too)."""
    traces = [f for f in os.listdir(directory)
              if f.startswith(f"{command}.") and f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"{directory}: traces {traces}")
    path = os.path.join(directory, traces[0])
    with open(path) as fh:
        text = fh.read()
    found = {name: name in text for name in names}
    print(f"  trace {traces[0]}: {os.path.getsize(path)} bytes, names "
          f"{found}", flush=True)
    if not all(found.values()):
        raise AssertionError(f"{path} lacks {found}")
    return found


def workflow_phase(torch, np, tmp: str) -> dict:
    """Phase 15: the port-only workflow on the card, from gzip FASTA files
    and a RepeatMasker ``.out`` file to a trained model and a BED; returns
    the launch counts on its paths."""
    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.data import preprocess
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel, create_model
    from deepgrp_tpu_torch.predict import engine
    from deepgrp_tpu_torch.train.sampler import codes_from_onehot_rows

    seconds = {}
    start = time.perf_counter()
    phase7, fasta, rm_out = write_workflow_inputs(np, tmp)
    print(f"wrote phase 7's files, the gzip FASTA files and the .out file "
          f"in {time.perf_counter() - start:.2f} s", flush=True)

    # The tools: preprocess_sequence twice (the second run skips), parse_rm.
    seconds["preprocess_sequence"] = sum(run_tool("preprocess_sequence", p)
                                         for p in fasta.values())
    mtimes = {p: os.stat(p + ".npz").st_mtime_ns for p in fasta.values()}
    seconds["preprocess_sequence (skip)"] = sum(
        run_tool("preprocess_sequence", p) for p in fasta.values())
    for path, mtime in mtimes.items():
        if os.stat(path + ".npz").st_mtime_ns != mtime:
            raise AssertionError(f"{path}.npz was written again")
    rm_bed = os.path.join(tmp, "repeats_rm.bed")
    seconds["parse_rm"] = run_tool("parse_rm", rm_out, "-o", rm_bed)
    options = Options(n_epochs=1, n_batches=20, batch_size=256, **FLAGSHIP)
    for chrom, want_npz in (("chrTrain", phase7[0]), ("chrValid", phase7[1])):
        with np.load(fasta[chrom] + ".npz") as got, \
                np.load(want_npz) as want:
            same = np.array_equal(got["fwd"], want["fwd"])
            length = got["fwd"].shape[1]
        labels = [preprocess.preprocess_y(bed, chrom, length,
                                          options.repeats_to_search)
                  for bed in (rm_bed, phase7[2])]
        print(f"{chrom}: npz fwd == phase 7's: {same}; preprocess_y over "
              f"parse_rm's BED == over phase 7's: "
              f"{np.array_equal(*labels)}", flush=True)
        if not (same and np.array_equal(*labels)):
            raise AssertionError(f"{chrom}: the tools' data differ")
    with open(rm_bed) as fh:
        n_rows = sum(1 for _ in fh)
    with open(phase7[2]) as fh:
        if n_rows != sum(1 for _ in fh):
            raise AssertionError(f"parse_rm kept {n_rows} rows")

    # Train through the CLI with the reference's flags, traced.
    files = (fasta["chrTrain"] + ".npz", fasta["chrValid"] + ".npz", rm_bed)
    train_trace = os.path.join(tmp, "train_trace")
    reset_counts()
    model, records, seconds["train 1 x 20 (--profile)"] = run_train_cli(
        tmp, files, "workflow", ("--profile", train_trace, "--xla", "-t",
                                 "2"), n_epochs=1, n_batches=20, **FLAGSHIP)
    launches = {"train": check_counts({"gru_train_fwd": 20,
                                       "gru_train_bwd": 20, "gru_avg": 1})}
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["val_loss"])
               for r in records):
        raise AssertionError(f"workflow: a loss is not finite: {records}")
    print(f"workflow train: losses {[r['loss'] for r in records]}",
          flush=True)
    trace_names(train_trace, "train", ("GruTrainFwdKernel",
                                       "GruBwdRecurrenceKernel"))
    reset_counts()
    _, records, seconds["train 1 x 5 adamw"] = run_train_cli(
        tmp, files, "workflow_adamw", n_epochs=1, n_batches=5,
        optimizer="adamw", **FLAGSHIP)
    launches["train adamw"] = check_counts({"gru_train_fwd": 5,
                                            "gru_train_bwd": 5,
                                            "gru_avg": 1})
    if not all(math.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"adamw: a loss is not finite: {records}")
    print(f"adamw train: losses {[r['loss'] for r in records]}", flush=True)
    # -t on the card: the second epoch's steps/s with torch's host threads
    # at 1 (-t 1, the CLI default) and at torch's default (-t 0), in turns.
    steps_s = {"1": [], "0": []}
    for turn, flag in enumerate(("1", "0", "0", "1")):
        reset_counts()
        _, records, _ = run_train_cli(tmp, files, f"threads_{turn}",
                                      ("-t", flag), n_epochs=2,
                                      n_batches=20, **FLAGSHIP)
        check_counts({"gru_train_fwd": 40, "gru_train_bwd": 40,
                      "gru_avg": 2})
        steps_s[flag].append(round(20 / records[1]["epoch_seconds"], 2))
    print(f"train steps/s of a second epoch (2 x 20, batch 256), -t 1 "
          f"{steps_s['1']}, -t 0 (torch's {torch.get_num_threads()} "
          f"threads) {steps_s['0']}", flush=True)

    # Predict chrValid with the trained model: plain, traced, plain.
    valid_fa = os.path.join(tmp, "chrValid.fa")
    predict_trace = os.path.join(tmp, "predict_trace")
    runs = {}
    for label, flags in (("predict (first)", []),
                         ("predict --profile", ["--profile", predict_trace]),
                         ("predict", [])):
        reset_counts()
        start = time.perf_counter()
        runs[label] = predict_rows(["-b", "1024", *flags, "predict", model,
                                    valid_fa],
                                   os.path.join(tmp, "workflow.bed"))
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - start
        launches[label] = check_path("gru_avg")
    if len({tuple(rows) for rows in runs.values()}) != 1:
        raise AssertionError("the traced predict wrote other rows")
    trace_names(predict_trace, "predict", ("AvgKernel",))
    print(f"workflow predict: {len(runs['predict'])} BED rows; --profile "
          f"overhead {seconds['predict --profile'] - seconds['predict']:.4f}"
          " s", flush=True)

    # The reference API: create_model + engine.predict on chrValid.
    config, params = load_model(model)
    with np.load(fasta["chrValid"] + ".npz") as arrays:
        onehot = arrays["fwd"]
    reset_counts()
    got = engine.predict(create_model(options, "cuda"), params, onehot,
                         (onehot.shape[1], config.n_classes), 50,
                         batch_size=1024)
    launches["engine.predict"] = check_path("gru_avg")
    want = engine.PredictionEngine(
        DeepGRPModel.from_params(config, params, "cuda"), batch_size=1024,
        step_size=50).predict(codes_from_onehot_rows(onehot))
    print(f"engine.predict == PredictionEngine.predict bit for bit: "
          f"{np.array_equal(got, want)} ({got.shape})", flush=True)
    if not np.array_equal(got, want):
        raise AssertionError("engine.predict differs")

    # The card has no h5py: an .h5 model file fails before any training.
    try:
        import h5py  # noqa: F401
        print("h5py is installed on this machine: the .h5 refusal is not "
              "checked", flush=True)
    except ImportError:
        from deepgrp_tpu_torch import cli

        toml = os.path.join(tmp, "workflow.toml")
        reset_counts()
        start = time.perf_counter()
        try:
            cli.main(["-b", "256", "train", toml, *files, "--honor-toml",
                      "--logdir", os.path.join(tmp, "workflow_h5_log"),
                      "--modelfile", os.path.join(tmp, "workflow_h5.h5")])
        except ImportError as err:
            if "h5py" not in str(err):
                raise
            print(f"train --modelfile m.h5: ImportError after "
                  f"{time.perf_counter() - start:.3f} s: {err}", flush=True)
        else:
            raise AssertionError("train --modelfile m.h5 did not raise")
        from deepgrp_tpu_torch.models import cuda_rnn

        if cuda_rnn.LAUNCHES.snapshot() or os.path.exists(
                os.path.join(tmp, "workflow_h5_log")) or any(
                    f.startswith("workflow_h5.") for f in os.listdir(tmp)):
            raise AssertionError("the .h5 run trained or wrote files")
    print("workflow seconds: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in seconds.items()),
          flush=True)
    return launches


# Phase 16's depth, cut from the reference's 200 x 250 to phase 12's
# 2 x 100 (train_and_evaluate and each sweep trial): at 2 x 20 the tuned
# gru_att predicted no repeat on chrValid (MCC NaN).  The sweep's TPE seed
# makes its proposals repeatable.
EXAMPLE_EPOCHS, EXAMPLE_STEPS, EXAMPLE_SEED = 2, 100, 0


def run_module(module: str, *args: str) -> str:
    """``python -m deepgrp_tpu_torch.<module> ARGS`` from the checkout;
    raises unless it exits 0.  Returns its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    result = subprocess.run(
        [sys.executable, "-m", f"deepgrp_tpu_torch.{module}", *args],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    print(result.stdout + result.stderr[-2000:], flush=True)
    if result.returncode:
        raise AssertionError(f"{module} exited {result.returncode}")
    return result.stdout


def examples_phase(torch, np, tmp: str) -> dict:
    """Phase 16: the examples on the card, on phase 7's chromosomes;
    returns the launch counts on their paths."""
    import csv
    import pickle

    from deepgrp_tpu_torch.data.preprocess import load_chromosome
    from deepgrp_tpu_torch.examples import hpo_sweep, train_and_evaluate
    from deepgrp_tpu_torch.hpo.optimization import evaluate_trained
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import ModelConfig
    from deepgrp_tpu_torch.predict.engine import window_starts

    seconds, launches = {}, {}
    train_npz, val_npz, bed = write_training_files(np, tmp)
    files = [train_npz, val_npz, bed]

    # train_and_evaluate: the tuned flagship, depth cut to 2 x 20 steps.
    options = train_and_evaluate.tuned_options()
    options.n_epochs, options.n_batches = EXAMPLE_EPOCHS, EXAMPLE_STEPS
    options.batch_size = 256
    toml = os.path.join(tmp, "tuned.toml")
    with open(toml, "w") as fh:
        options.to_toml(fh)
    val_len = load_chromosome(val_npz, bed,
                              options.repeats_to_search).fwd.shape[1]
    chunks = -(-window_starts(val_len, options.vecsize, 50).size
               // options.batch_size)
    steps = EXAMPLE_EPOCHS * EXAMPLE_STEPS
    outdir = os.path.join(tmp, "runs")
    reset_counts()
    start = time.perf_counter()
    train_and_evaluate.main([*files, "--runs", "1", "--outdir", outdir,
                             "--config", toml])
    torch.cuda.synchronize()
    seconds["train_and_evaluate"] = time.perf_counter() - start
    launches["train_and_evaluate"] = check_counts({
        "gru_train_fwd": steps, "gru_train_bwd": steps,
        "gru_avg": EXAMPLE_EPOCHS + chunks})
    with open(os.path.join(outdir, "training_times.csv")) as fh:
        rows = list(csv.DictReader(fh))
    print(f"training_times.csv: {rows}", flush=True)
    if len(rows) != 1 or not math.isfinite(float(rows[0]["MCC"])):
        raise AssertionError(f"train_and_evaluate: {rows}")
    config, params = load_model(os.path.join(outdir, "model00.npz"))
    if config != ModelConfig.from_options(options):
        raise AssertionError(f"model00.npz holds {config}")
    # The CSV's MCC (the merged track, then the MSS of the probabilities)
    # against the scored route's on the same weights.
    mcc = evaluate_trained(options, 50, os.path.join(outdir, "run00"),
                           load_chromosome(val_npz, bed,
                                           options.repeats_to_search),
                           params)["MCC"]
    print(f"MCC {rows[0]['MCC']}, scored route {mcc}", flush=True)
    if abs(mcc - float(rows[0]["MCC"])) > 1e-6:
        raise AssertionError("the routes' MCCs differ")

    # hpo_sweep: serial TPE (quick space, the same TOML) with a save after
    # each trial, then a fleet round of 2 that resumes results.pkl.
    root = os.path.join(tmp, "sweep")
    sweep = [*files, "--space", "quick", "--config", toml, "--root", root,
             "--seed", str(EXAMPLE_SEED)]
    for label, extra in (("hpo_sweep", ["--trials", "2", "--save-step",
                                        "1"]),
                         ("hpo_sweep --parallel 2", ["--trials", "2",
                                                     "--parallel", "2"])):
        reset_counts()
        start = time.perf_counter()
        hpo_sweep.main([*sweep, *extra])
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - start
        launches[label] = check_counts({"gru_train_fwd": 2 * steps,
                                        "gru_train_bwd": 2 * steps})
        if launches[label].get("gru_avg", 0) <= 0:
            raise AssertionError(f"{label}: gru_avg was not launched")
        with open(os.path.join(root, "results.pkl"), "rb") as fh:
            trials = pickle.load(fh)
        check_trials(trials, label)
        if len(trials) != (2 if label == "hpo_sweep" else 4):
            raise AssertionError(f"{label}: {len(trials)} trials in "
                                 "results.pkl")

    # multihost_sim: two gloo ranks (1 + 2 shards) on cuda:0 against one
    # process.
    start = time.perf_counter()
    out = run_module("examples.multihost_sim", "--device", "cuda",
                     "--nproc", "2")
    seconds["multihost_sim"] = time.perf_counter() - start
    if "bit-identical" not in out:
        raise AssertionError("multihost_sim")

    # The native library's self-test, built on this host (-march=native).
    native_dir = os.path.join(HERE, "deepgrp_tpu_torch", "native")
    start = time.perf_counter()
    subprocess.run(["make", "-s", "-C", native_dir, "selftest"], check=True,
                   timeout=600)
    seconds["selftest build"] = time.perf_counter() - start
    start = time.perf_counter()
    result = subprocess.run(
        [os.path.join(HERE, "deepgrp_tpu_torch", "_build", "selftest")],
        capture_output=True, text=True, timeout=600)
    seconds["selftest run"] = time.perf_counter() - start
    print(result.stdout + result.stderr, flush=True)
    if result.returncode or "native selftest OK" not in result.stdout:
        raise AssertionError("the native self-test failed")
    print("examples seconds: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in seconds.items()),
          flush=True)
    return launches


#: Phase 17's depth: epochs of 20 steps, as phase 7's turns.
DP_GRAPH_STEPS = 20


def dp_graph_run(torch, config, params, options, sampler, group,
                 deltas: dict):
    """``make(capture)`` of :func:`compare_captured` for a rank's
    data-parallel epoch (``make_dp_train_epoch`` over ``group``); each
    epoch's launch counts go into ``deltas[capture]``."""
    from deepgrp_tpu_torch.models import cuda_rnn
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.parallel.train import make_dp_train_epoch
    from deepgrp_tpu_torch.train.optimizers import get_optimizer

    def make(capture: bool):
        model = DeepGRPModel.from_params(config, params)
        optimizer = get_optimizer(options, model.parameters())
        gen = torch.Generator(device=model.device).manual_seed(11)
        loop = make_dp_train_epoch(model, optimizer, options, sampler, gen,
                                   options.n_batches, group,
                                   capture=capture)

        def epoch():
            before = cuda_rnn.LAUNCHES.snapshot()
            loop.epoch().item()
            after = cuda_rnn.LAUNCHES.snapshot()
            deltas[capture].append({k: v - before.get(k, 0)
                                    for k, v in after.items()
                                    if v != before.get(k, 0)})
            return [loop.losses.clone()]

        return epoch, lambda: [*model.params().values(), gen.get_state()]

    return make


def dp_capture_phase(torch, np, tmp: str) -> dict:
    """Phase 17: the data-parallel epoch captured with its ``all_reduce``
    inside, against the eager one: at world size 1 over NCCL for
    ``gru_att`` and the LSTM of its width (turns, device time, the
    replayed graph's NCCL kernels), then ``Trainer.fit`` captured against
    eager under torch's fake process group at world size 2.  Returns the
    launch counts of the phase's runs."""
    import torch.distributed as dist

    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.models.model import ModelConfig, init_params
    from deepgrp_tpu_torch.parallel.mesh import (cuda_backend,
                                                 initialize_distributed)
    from deepgrp_tpu_torch.train.sampler import BatchSampler

    train_npz, val_npz, bed = write_training_files(np, tmp)
    launches = {}
    initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        print(f"world 1, backend {backend} (CUDA collectives over "
              f"{cuda_backend()})", flush=True)
        if cuda_backend() != "nccl":
            raise AssertionError(f"backend {backend}: not NCCL")
        for cell, widths in DP_CELLS.items():
            options = Options(batch_size=256, n_batches=DP_GRAPH_STEPS,
                              **widths)
            config = ModelConfig.from_options(options)
            params = init_params(config, torch.Generator().manual_seed(0))
            sampler = BatchSampler(options, load_training_data(
                np, train_npz, bed, options), "cuda")
            deltas = {False: [], True: []}
            reset_counts()
            result = compare_captured(
                torch, f"{cell} DP epoch (NCCL, world 1)",
                dp_graph_run(torch, config, params, options, sampler,
                             dist.group.WORLD, deltas), DP_GRAPH_STEPS,
                turns=4)
            want = {f"{cell}_train_fwd": DP_GRAPH_STEPS,
                    f"{cell}_train_bwd": DP_GRAPH_STEPS}
            n_epochs = len(deltas[True])
            total = check_counts({k: 2 * n_epochs * v
                                  for k, v in want.items()})
            if deltas[False] != deltas[True] or any(d != want for d in
                                                    deltas[True]):
                raise AssertionError(f"{cell}: launches an epoch eager "
                                     f"{deltas[False]}, captured "
                                     f"{deltas[True]}")
            replayed = result["device_ms"][True]
            nccl = {k: round(v, 4) for k, v in replayed.items()
                    if "nccl" in k.lower()}
            copies = {k: round(v, 4) for k, v in replayed.items()
                      if "memcpy" in k.lower() or "memset" in k.lower()}
            eager_nccl = sorted(k for k in result["device_ms"][False]
                                if "nccl" in k.lower())
            print(f"{cell}: launches an epoch {want} eager and captured "
                  f"({n_epochs} epochs each, counted at each replay); the "
                  f"replayed graph's NCCL kernels (ms in its profiled "
                  f"epoch): {nccl or 'none'}; its copies and sets: "
                  f"{copies or 'none'}; the eager epoch's NCCL kernels: "
                  f"{eager_nccl or 'none'}", flush=True)
            launches[f"{cell} world 1"] = total
    finally:
        dist.destroy_process_group()

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as err:
        raise AssertionError(f"torch {torch.__version__} has no fake "
                             f"process group backend: {err}") from err
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        options = Options(batch_size=256, n_epochs=2,
                          n_batches=DP_GRAPH_STEPS, **FLAGSHIP)
        train = load_training_data(np, train_npz, bed, options)
        val = load_training_data(np, val_npz, bed, options)
        fit = fit_pair(torch, options, train, val, tmp,
                       "gru_att fake world 2", group=dist.group.WORLD)
        steps = options.n_epochs * options.n_batches
        want = {"gru_train_fwd": steps, "gru_train_bwd": steps,
                "gru_avg": options.n_epochs}
        if fit != want:
            raise AssertionError(f"fake world 2 fit launches {fit}, "
                                 f"expected {want}")
        launches["gru_att fake world 2 fit"] = fit
    finally:
        dist.destroy_process_group()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import synth_mbp  # numpy only

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. environment")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    build_s = build_all()
    print("build seconds: " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in build_s.items()),
          flush=True)
    from deepgrp_tpu_torch import _build

    for name in _build.CUDA_SOURCES:
        print((_build.BUILD_DIR / f"{name}.log").read_text(), flush=True)

    phase("2. kernels vs plain versions")
    timings = kernel_phase(torch)

    phase("3. fixture BEDs")
    launches, fixture_runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("gru_att", "gru", "lstm"):
            reset_counts()
            with Recorder() as fixture_runs[name]:
                got = predict_rows(
                    REF_ARGS + ["predict", os.path.join(TORCH_FIXDIR,
                                                        f"{name}.npz"),
                                os.path.join(FIXDIR, f"{name}.fa")],
                    os.path.join(tmp, f"{name}.bed"))
            kernel = "lstm_avg" if name == "lstm" else "gru_avg"
            count = check_path(kernel)
            want = expected_rows(name)
            print(f"{name}: {len(got)} rows, expected {len(want)}, "
                  f"identical={got == want}", flush=True)
            if got != want:
                raise AssertionError(f"{name}: BED rows differ")
            if name == "lstm":
                launches["lstm_avg"] = count

        phase("4. real size: 4.9 Mbp chromosome, gru_att, batch 1024")
        with open(os.path.join(FIXDIR, "mbp_manifest.json")) as fh:
            man = json.load(fh)
        seq = synth_mbp.make_mbp_sequence(man["seed"], man["n_windows"])
        fasta = os.path.join(tmp, "mbp.fa")
        synth_mbp.write_fasta(fasta, man["header"], seq)
        mbp_args = ["-b", "1024", "-s", str(man["step_size"]),
                    "-x", str(man["xdrop_len"]), "-l",
                    str(man["min_mss_len"]), "predict",
                    os.path.join(TORCH_FIXDIR, "gru_att.npz"), fasta]
        reset_counts()
        start = time.perf_counter()
        with Recorder() as mbp_run:
            got = predict_rows(mbp_args, os.path.join(tmp, "mbp.bed"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches["gru_avg"] = check_path("gru_avg")
        want = expected_rows("mbp")
        print(f"mbp: {len(got)} rows, expected {len(want)} "
              f"(manifest {man['n_bed_rows']}), identical={got == want}",
              flush=True)
        if got != want:
            raise AssertionError("mbp: BED rows differ")
        kernel_s = launches["gru_avg"] * timings[("gru_avg", "flagship")]["ms"]
        kernel_s /= 1e3
        print(f"mbp end to end: {seconds:.3f} s for {man['n_windows']} "
              f"windows = {man['n_windows'] / seconds:.1f} windows/s; kernel "
              f"share (launches x kernel_ms at this shape) = {kernel_s:.3f} s "
              f"= {100 * kernel_s / seconds:.1f}%", flush=True)

        phase("5. where the time goes (4.9 Mbp, gru_att, batch 1024)")
        breakdown_phase(torch, fasta, man)

        phase("6. training kernels vs plain versions")
        timings.update(train_kernel_phase(torch))

        phase("7. training on the card: gru_att (3 x 20 steps), lstm "
              f"(2 x 5 at u=60 and u={LSTM_WIDE_UNITS}, then 1 x 20)")
        import numpy as np

        with tempfile.TemporaryDirectory() as train_tmp:
            gru_launches, lstm_launches = training_phase(torch, np,
                                                         train_tmp)
        launches.update({k: gru_launches[k] for k in ("gru_train_fwd",
                                                      "gru_train_bwd")})
        launches.update({k: lstm_launches[k] for k in ("lstm_train_fwd",
                                                       "lstm_train_bwd")})

        phase("8. one-hot kernels vs plain versions")
        timings.update(seq_kernel_phase(torch))
        timings.update(bf16_kernel_phase(torch))

        phase("9. the scan route and the bfloat16 fast mode")
        launches.update(scan_and_bf16_phase(torch, np, tmp, fixture_runs,
                                            mbp_run, man, mbp_args))

        phase("10. predict -m (no MSS): fixtures against the CPU, the "
              "merged track on 4.9 Mbp")
        no_mss_phase(torch, np, tmp, man, mbp_args, seq)

    with tempfile.TemporaryDirectory() as train_tmp:
        phase("11. the training scan route: one step against the fused "
              "kernels (gru_att, lstm u=60), then train --rnn-kernel scan")
        scan_training_phase(torch, np, train_tmp)

    with tempfile.TemporaryDirectory() as hpo_tmp:
        phase(f"12. HPO: TPE trials with resume, the bucketed sweep, the "
              f"fleet ({HPO_EPOCHS} x {HPO_STEPS} steps a trial)")
        hpo_phase(torch, np, hpo_tmp)

    phase("13. several shards and ranks on the one card: the sharded "
          "engine (4 and 3 shards), two gloo ranks (DP), the launch flags "
          "at world size 1")
    start = time.perf_counter()
    path_launches = {"sharded": sharded_phase(torch, np, man, seq,
                                              mbp_run)}
    with tempfile.TemporaryDirectory() as dp_tmp:
        path_launches["dp"] = dp_phase(torch, np, dp_tmp)
    with tempfile.TemporaryDirectory() as cli_tmp:
        nccl_cli_phase(torch, np, cli_tmp)
    print(f"launches on phase 13's paths: {path_launches}; phase 13 took "
          f"{time.perf_counter() - start:.2f} s", flush=True)

    phase("14. the MSS routes of predict: --device-mss auto (streaming, "
          "-t 1 and -t 0), on, off; 4 shards auto; bf16; dg_mss_stack; a "
          "noisy track's overflow")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as mss_tmp:
        mss_row = mss_routes_phase(torch, np, mss_tmp, man, seq)
    print(f"phase 14 took {time.perf_counter() - start:.2f} s", flush=True)

    phase("15. the port-only workflow on the card: gzip FASTA and "
          "RepeatMasker .out -> npz and BED -> train (traced, adamw) -> "
          "predict -> BED; create_model and engine.predict; no .h5 without "
          "h5py")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as workflow_tmp:
        path_launches = workflow_phase(torch, np, workflow_tmp)
    print(f"launches on phase 15's paths: {path_launches}; phase 15 took "
          f"{time.perf_counter() - start:.2f} s", flush=True)

    phase("16. the examples on the card: train_and_evaluate (gru_att, "
          f"{EXAMPLE_EPOCHS} x {EXAMPLE_STEPS} steps), hpo_sweep (serial with "
          "resume, a fleet of 2), multihost_sim (2 gloo ranks), the native "
          "self-test")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as examples_tmp:
        path_launches = examples_phase(torch, np, examples_tmp)
    print(f"launches on phase 16's paths: {path_launches}; phase 16 took "
          f"{time.perf_counter() - start:.2f} s", flush=True)

    phase(f"17. the data-parallel epoch captured with its all_reduce: "
          f"NCCL at world size 1 (gru_att, lstm; 5 x {DP_GRAPH_STEPS} "
          f"steps in turns), Trainer.fit under the fake backend at world "
          f"size 2")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as dp_graph_tmp:
        path_launches = dp_capture_phase(torch, np, dp_graph_tmp)
    print(f"launches on phase 17's paths: {path_launches}; phase 17 took "
          f"{time.perf_counter() - start:.2f} s", flush=True)

    kernels = []
    sources = {**{name: ("rnn_avg.cu", replaces)
                  for name, (_, replaces) in KERNELS.items()},
               **{name: ("rnn_train.cu", replaces)
                  for name, replaces in TRAIN_KERNELS.items()},
               "gru_seq": ("rnn_seq.cu", SEQ_REPLACES),
               **{f"{name}_bf16": ("rnn_avg.cu", replaces)
                  for name, (_, replaces) in KERNELS.items()}}
    for name, (source, replaces) in sources.items():
        row = timings[(name, "flagship")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepgrp_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    kernels.append({
        "name": "mss_stack", "route": "cuda",
        "source": "deepgrp_tpu_torch/csrc/mss_stack.cu",
        "replaces": MSS_STACK_REPLACES, **mss_row})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
