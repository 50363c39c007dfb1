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
   ragged one (B=1000, T=150, u=32), random weights and codes (with N and
   pad codes) from a seed; max abs difference <= 1e-5 on both outputs (the
   JAX package's kernel tolerance).  Times the kernel, the plain version
   and the cuDNN recurrence (``torch.nn.GRU``/``LSTM`` on the doubled
   one-hot batch, TF32 off) with CUDA events.
3. Fixture BEDs: ``python -m deepgrp_tpu_torch predict`` (through
   ``cli.main``) on ``tests/fixtures/reference/{gru_att,gru,lstm}.fa`` with
   the reference settings and the ``.npz`` weights in
   ``tests/fixtures/torch``; the rows must equal ``{name}.bed`` exactly.
4. Real size: the 4.9 Mbp chromosome of ``tests/synth_mbp.py`` (seed and
   size from ``mbp_manifest.json``) through ``gru_att`` at ``-b 1024``;
   all 1456 rows must equal ``mbp.bed``.  Prints windows/s end to end.
5. Where the time goes: the same chromosome stage by stage on the host
   clock, and the engine's device time by kernel name (``torch.profiler``).

Before each predict run every launch count is set to 0; after it, the
kernel of that model must have launched and the plain versions must not
have run.  The line before the last lists each kernel
(``{"kernels": [...]}``); the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
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
PEAK_BYTES = 3.35e12  # HBM3
TOL = 1e-5

KERNELS = {
    # name: (gates, TPU kernel it replaces)
    "gru_avg": (3, "deepgrp_tpu/models/pallas_rnn.py:178"),
    "lstm_avg": (4, "deepgrp_tpu/models/pallas_rnn.py:309"),
}
SHAPES = {"flagship": (1024, 342, 60), "ragged": (1000, 150, 32)}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def build_all():
    """Build the CUDA and the host library concurrently; seconds each."""
    from deepgrp_tpu_torch import _build, native

    seconds, errors = {}, []

    def run(name, fn):
        start = time.perf_counter()
        try:
            fn()
        except BaseException as err:  # re-raised below, in the main thread
            errors.append(err)
        seconds[name] = time.perf_counter() - start

    threads = [threading.Thread(target=run, args=(name, fn)) for name, fn in
               (("csrc", _build.load_kernels), ("native", native.load))]
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


def library_rnn(torch, gates: int, params, codes):
    """cuDNN recurrence computing the same function (timed only)."""
    from deepgrp_tpu_torch.models.rnn import _doubled_codes

    units = params["recurrent"].shape[0]
    both = _doubled_codes(codes)
    onehot = torch.eye(6, device=codes.device)[both][..., :5].contiguous()
    if gates == 3:
        cell = torch.nn.GRU(5, units, batch_first=True).cuda()

        def reorder(mat):  # Keras (z, r, h) -> torch (r, z, n)
            return torch.cat([mat[..., units:2 * units], mat[..., :units],
                              mat[..., 2 * units:]], dim=-1)

        w_ih, w_hh = reorder(params["kernel"]), reorder(params["recurrent"])
        b_ih, b_hh = reorder(params["bias"][0]), reorder(params["bias"][1])
    else:
        cell = torch.nn.LSTM(5, units, batch_first=True).cuda()
        w_ih, w_hh = params["kernel"], params["recurrent"]
        b_ih, b_hh = params["bias"], torch.zeros_like(params["bias"])
    with torch.no_grad():
        cell.weight_ih_l0.copy_(w_ih.T)
        cell.weight_hh_l0.copy_(w_hh.T)
        cell.bias_ih_l0.copy_(b_ih)
        cell.bias_hh_l0.copy_(b_hh)
    batch = codes.shape[0]

    @torch.no_grad()
    def run():
        seq, _ = cell(onehot)
        return (seq[:batch] + seq[batch:]) * 0.5

    return run


def kernel_phase(torch):
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    gen = torch.Generator().manual_seed(2024)
    results = {}
    for name, (gates, _) in KERNELS.items():
        kernel = getattr(cuda_rnn, name)
        plain = getattr(rnn, f"{name}_plain")
        for label, (batch, steps, units) in SHAPES.items():
            params, codes = random_rnn(torch, gen, gates, batch, steps,
                                       units)
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

    cuda_rnn.LAUNCHES.reset()
    rnn.PLAIN_CALLS.reset()


def breakdown_phase(torch, fasta: str, man: dict) -> None:
    """Where the time of the real-size run goes: host clock around each
    stage of the predict path (the engine's stage ends in its one copy to
    the host, so it includes the device), then one engine run under
    ``torch.profiler`` for the device time by kernel name."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deepgrp_tpu_torch.data.fasta import read_multi_fasta
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.ops import mss
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.ops.segments import yield_segments
    from deepgrp_tpu_torch.predict.engine import (PredictionEngine,
                                                  mss_score_transform)

    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    engine = PredictionEngine(DeepGRPModel.from_params(config, params),
                              batch_size=1024, step_size=man["step_size"])
    engine.predict_scored(np.random.default_rng(0).integers(  # warm-up
        0, 5, 4 * config.vecsize).astype(np.int8))
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
    classes, maxp = engine.predict_scored(codes)
    lap("engine (device scan + copy)")
    scores = mss_score_transform(classes, maxp).astype(np.float64)
    labels = mss.find_mss_classes(scores, classes.astype(np.int64),
                                  config.n_classes, man["min_mss_len"],
                                  man["xdrop_len"])
    lap("MSS (host)")
    rows = sum(1 for seg in yield_segments(labels, start) if seg[2] > 0)
    lap("segments")
    total = sum(stages.values())
    print(f"stages of the predict path ({rows} rows, {total:.4f} s): "
          + ", ".join(f"{k} {v:.4f} s ({100 * v / total:.1f}%)"
                      for k, v in stages.items()), flush=True)

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
    engine_ms = 1e3 * stages["engine (device scan + copy)"]
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
    print(f"build seconds: csrc {build_s['csrc']:.2f}, native "
          f"{build_s['native']:.2f}", flush=True)
    from deepgrp_tpu_torch import _build

    print((_build.BUILD_DIR / "rnn_avg.log").read_text(), flush=True)

    phase("2. kernels vs plain versions")
    timings = kernel_phase(torch)

    phase("3. fixture BEDs")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("gru_att", "gru", "lstm"):
            reset_counts()
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
        reset_counts()
        start = time.perf_counter()
        got = predict_rows(
            ["-b", "1024", "-s", str(man["step_size"]),
             "-x", str(man["xdrop_len"]), "-l", str(man["min_mss_len"]),
             "predict", os.path.join(TORCH_FIXDIR, "gru_att.npz"), fasta],
            os.path.join(tmp, "mbp.bed"))
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

    kernels = []
    for name, (_, replaces) in KERNELS.items():
        row = timings[(name, "flagship")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepgrp_tpu_torch/csrc/rnn_avg.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
