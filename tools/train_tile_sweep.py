#!/usr/bin/env python3
"""Times the training kernels (``deepgrp_tpu_torch/csrc/rnn_train.cu``) by
width on a CUDA card.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/train_tile_sweep.py
        [--units 128,129,160,192,224,256,300,512,1024]
        [--batch 256] [--steps 342] [--cells gru,lstm] [--out FILE.json]
    python3 tools/train_tile_sweep.py --clusters [--units 256,300,512,1024]
        [--batch 256] [--steps 342] [--cells gru,lstm] [--out FILE.json]
    python3 tools/train_tile_sweep.py --grid [--units 257,...,4096]
        [--cells gru,lstm] [--out FILE.jsonl]
    python3 tools/train_tile_sweep.py --routes [--units 129,...,1023]
        [--cells gru,lstm] [--out FILE.jsonl]
    python3 tools/train_tile_sweep.py --ablate [--out FILE.jsonl]

Prints the compiler's registers and spills of each kernel of the file
(``nvcc -Xptxas -v``), then for each cell and width: the tile
(``cuda_rnn.train_tile``), the forward and backward checked against their
plain versions with dropout masks (rate 0.0928) as ``chip_smoke.py``'s
phase 6 checks them, and the times of the forward, the backward, the
backward's recurrence and reduction kernels, the plain versions and cuDNN
(``torch.nn.GRU``/``LSTM`` forward, and forward + backward, TF32 off),
with the bound of each kernel, CUDA events over 20 launches after a
warm-up (3 for the plain versions).  Writes the rows and the card's name
and power limit to ``--out`` as JSON, if given.

``--clusters`` times the cluster tile's layouts instead
(``TrainFwdClusterKernel`` / ``BwdRecurrenceClusterKernel<kGates, kWin,
kCluster>``: 2, 4 or 8 windows a cluster on 4 CTAs, up to u=256, 8, up
to u=512, or 16):
the script builds a copy of the source with one more C entry point a
kernel that launches any of them, prints each one's registers and spills
and its clusters at once, and at each width checks the forward's outputs
(atol 1e-5) and the recurrence's gate cotangents (1e-4 of their largest
magnitude) against the plain versions and times both over 5 launches
after a warm-up, beside the library's own layout at that width (the row
``{cell}_library``: the layout the library picks).

``--grid`` times the grid tile (``csrc/rnn_grid.cu``) beside the routed
launch: ``cuda_rnn.train_fwd`` and ``train_bwd`` (the recurrence and the
reduction) with ``grid=True`` beside the same calls without it, at each
width of ``--units`` (``avg_tile_sweep.GRID_WIDTHS`` by default) and each
(batch, T) of ``avg_tile_sweep.GRID_BATCHES``, inputs made on the card
from a seed, masks at rate 0.0928: the forward's outputs (1e-5) and the
gradients (1e-4 of their largest magnitude) checked against the plain
versions first, then timed as ``avg_tile_sweep.adaptive_ms`` times.  One
JSON line a case, printed and appended to ``--out``.

``--routes`` times, in one process and in turns, every tile that could
serve a training width past u=128, at each width of ``--units``
(:data:`ROUTE_WIDTHS` by default) and each (batch, T) of
:data:`ROUTE_BATCHES`, both cells, inputs made on the card from a seed,
masks at rate 0.0928: the routed launch (the library's own layout), the
grid tile (``grid=True``) and every cluster layout of the ``--clusters``
copy (4, 8 and 16 CTAs, 2, 4 and 8 windows); each forward checked
against the plain version (1e-5), each backward's gradients (routed,
grid) or gate cotangents (the cluster layouts) within 1e-4 of their
largest magnitude.  Each time is CUDA events over 2-20 launches after a
timed first one (:func:`quick_ms`): the forward, the backward (routed,
grid: ``train_bwd``; a cluster layout: its recurrence plus the
reduction, timed once a case), cuDNN's forward and forward + backward
(TF32 off) and the bound as ``chip_smoke.py``'s phase 6 counts it.  One
JSON line a case; then, for each width, :func:`route_summary`: each
tile's forward + backward over the fastest at each batch, and the
cluster tile's best CTAs a cluster for the forward and the backward.

``--ablate`` times the grid tile's training backward at
:data:`ABLATION_CASES` in each case of :data:`ABLATIONS`: the step (B)
given each count of blocks of 32 units a CTA, and an edited copy of
``csrc/rnn_grid.cu`` (each edit must apply once) whose A operand is
gathered from the row-major cotangents in 4-byte copies as the first
design did; each case's gate cotangents checked against the plain
recurrence (1e-4 of their largest magnitude) and timed (the recurrence
with CUDA events, (A) and (B) apart with ``torch.profiler``), beside the
forward's time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "deepgrp_tpu_torch", "csrc")

# The cluster tile's layouts: (gates, windows a cluster, CTAs a cluster).
VARIANTS = [(gates, win, cluster) for gates in (3, 4)
            for cluster in (4, 8, 16) for win in (2, 4, 8)]
# --routes: the widths past u=128 and the batches (B, T) each is timed at.
ROUTE_WIDTHS = (129, 160, 192, 224, 256, 300, 384, 512, 768, 1023)
ROUTE_BATCHES = ((256, 342), (64, 342), (37, 150), (5, 23))
_ROW_A = "constexpr int kBwdRowA = kBlockRows;"
_ACC_B = ("  float acc[kThreadRows][kGroups][kThreadUnits] = {};\n"
          "  CotDot<kGroups>(")
_STAGE_B = ("      [&](float *s_a, int tile) { StageH(s_a, cot_cur, rows, "
            "r0, tile); },")
# The first design's A: step t+1's row-major cotangents, 4-byte copies.
_GATHER = [
    (_ROW_A, "constexpr int kBwdRowA = kGatherStride;"),
    (_ACC_B, """  const float *d_next = kGates == 3 ? a.d_rp : a.d_out;
  Gather gather(d_next);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + gather.Row(i);
    gather.src[i] = row < 2 * batch
                        ? d_next + (static_cast<size_t>(row) * steps + t +
                                    1) * cols
                        : nullptr;
  }
""" + _ACC_B),
    (_STAGE_B, """      [&](float *s_a, int tile) {
        const int gate = tile * kBlockK / a.width;
        const int i = tile * kBlockK - gate * a.width + gather.kk;
        gather.Stage(s_a, gate * static_cast<size_t>(units) + i,
                     i < units);
      },""")]
# --ablate: edited copies of rnn_grid.cu, name: [(text, its
# replacement), ...].
ABLATION_SOURCES = {"gather_a": _GATHER}
# --ablate: name: (the copy of ABLATION_SOURCES, None for the shipped
# source; (B)'s blocks of 32 units a CTA, None for grid_bwd_groups').
ABLATIONS = {
    "shipped": (None, None),
    **{f"groups_{n}": (None, n) for n in (1, 2, 3, 4)},
    "gather_a": ("gather_a", None),
    "gather_a_groups_1": ("gather_a", 1),
}
# (cell, batch, steps, units) of --ablate: PERF.md's B=64, u=4608, and
# the grid's route width and widest swept at B=256.
ABLATION_CASES = (("gru", 64, 342, 4608), ("lstm", 64, 342, 4608),
                  ("gru", 256, 342, 1024), ("lstm", 16, 342, 4096))
_FWD_HEAD = ("const void *codes, int batch, int steps, const void *masks, "
             "const void *kernel, const void *bias, const void *recurrent, "
             "int units, void *avg, void *hidden, void *hseq, void *cseq")
_BWD_HEAD = ("const void *codes, int batch, int steps, const void *masks, "
             "const void *kernel, const void *bias, const void *recurrent, "
             "int units, const void *hseq, const void *cseq, "
             "const void *d_avg, const void *d_hidden, void *d_out, "
             "void *d_xp")


def _args(head: str) -> str:
    return ", ".join(part.split()[-1].lstrip("*") for part in
                     head.split(","))


def sweep_source() -> str:
    """``rnn_train.cu`` with ``dg_sweep_fwd`` / ``dg_sweep_bwd(variant,
    <the launcher's arguments>, stream)``, which launch a layout of
    VARIANTS, and ``dg_sweep_slots(variant, backward, units)``, which
    counts its clusters at once, appended (the launchers are in the
    file's anonymous namespace, so the entry points go in the same
    translation unit)."""
    with open(os.path.join(CSRC, "rnn_train.cu")) as fh:
        text = fh.read()
    out = [text]
    for kind, head, launcher in (("fwd", _FWD_HEAD, "LaunchFwdCluster"),
                                 ("bwd", _BWD_HEAD, "LaunchBwdCluster")):
        cases = "".join(
            f"    case {n}: return {launcher}<{g}, {w}, {c}>("
            f"{_args(head)}, s);\n"
            for n, (g, w, c) in enumerate(VARIANTS))
        out.append(
            f'\nextern "C" int dg_sweep_{kind}(int variant, {head}, '
            "void *stream) {\n"
            "  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
            "  switch (variant) {\n" + cases + "  }\n"
            "  return static_cast<int>(cudaErrorInvalidValue);\n}\n")
    cases = "".join(
        f"    case {n}: return backward ? ClusterSlotsOf<{g}, {w}, {c}, "
        f"true>(units) : ClusterSlotsOf<{g}, {w}, {c}, false>(units);\n"
        for n, (g, w, c) in enumerate(VARIANTS))
    out.append(
        '\nextern "C" int dg_sweep_slots(int variant, int backward, '
        "int units) {\n"
        "  switch (variant) {\n" + cases + "  }\n  return -1;\n}\n")
    return "".join(out)


def build_sweep():
    """Builds the sweep copy (with ``csrc`` on the include path for the
    shared header); returns the library and its build log."""
    from deepgrp_tpu_torch import _build

    src_dir = _build.BUILD_DIR / "sweep"
    src_dir.mkdir(parents=True, exist_ok=True)
    src = src_dir / "train_sweep.cu"
    src.write_text(sweep_source())
    path = _build.build_shared_library(
        "train_sweep", [_build.nvcc()], [src],
        (*_build.NVCC_FLAGS, "-I", CSRC))
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [i, p, i, i, p, p, p, p, i]
    lib.dg_sweep_fwd.argtypes = head + [p] * 4 + [p]
    lib.dg_sweep_bwd.argtypes = head + [p] * 6 + [p]
    lib.dg_sweep_slots.argtypes = [i, i, i]
    lib.dg_sweep_fwd.restype = lib.dg_sweep_bwd.restype = i
    lib.dg_sweep_slots.restype = i
    lib.dg_error_string.argtypes = [i]
    lib.dg_error_string.restype = ctypes.c_char_p
    return lib, (_build.BUILD_DIR / "train_sweep.log").read_text()


def cluster_rows(torch, lib, log: str, args, card: str) -> list:
    """``--clusters``: each layout of VARIANTS at each width, checked
    against the plain versions and timed; one row each."""
    import chip_smoke
    from deepgrp_tpu_torch.models import cuda_rnn

    for template in ("TrainFwdClusterKernel", "BwdRecurrenceClusterKernel"):
        for variant, usage in sorted(chip_smoke.ptxas_usage(
                log, template).items()):
            print(f"{template}<{variant}>: {usage}", flush=True)
    gen = torch.Generator().manual_seed(2025)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows = []
    for cell in args.cells.split(","):
        gates = 4 if cell == "lstm" else 3
        for units in (int(u) for u in args.units.split(",")):
            batch, steps = args.batch, args.steps
            params, codes, masks, d_avg, d_hid = chip_smoke.train_case(
                torch, gen, gates, batch, steps, units)
            want = cuda_rnn._PLAIN[cell][0](params, codes, masks)
            seqs = tuple(want[2:])
            want_cot = plain_cotangents(cell, params, codes, masks, seqs,
                                        d_avg, d_hid)
            torch.cuda.synchronize()
            # The library's own layout at this width, timed beside the
            # variants.
            tile = cuda_rnn.train_tile(cell, batch, units, steps)
            row = {"kernel": f"{cell}_library", "units": units,
                   "batch": batch, "steps": steps, "tile": tile,
                   "fwd_ms": chip_smoke.cuda_ms(torch, lambda: cuda_rnn.
                                                train_fwd(cell, params, codes,
                                                          masks), 5),
                   "recurrence_ms": chip_smoke.cuda_ms(
                       torch, lambda: cuda_rnn._bwd_recurrence(
                           cell, params, codes, masks, seqs, d_avg, d_hid),
                       5)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            ptr = [codes.data_ptr(), batch, steps, masks.data_ptr(),
                   params["kernel"].data_ptr(), params["bias"].data_ptr(),
                   params["recurrent"].data_ptr(), units]
            for n, (g, win, cluster) in enumerate(VARIANTS):
                if g != gates or -(-units // cluster) > 64:
                    continue
                outs = [torch.empty_like(w) for w in want]
                cot = [torch.empty_like(c) for c in want_cot]
                fwd_args = ptr + [o.data_ptr() for o in outs] + (
                    [None] if cell == "gru" else [])
                bwd_args = (ptr + [q.data_ptr() for q in seqs]
                            + ([None] if cell == "gru" else [])
                            + [d_avg.data_ptr(), d_hid.data_ptr()]
                            + [c.data_ptr() for c in cot]
                            + ([None] if cell == "lstm" else []))
                slots = {kind: lib.dg_sweep_slots(n, backward, units)
                         for kind, backward in (("fwd", 0), ("bwd", 1))}
                row = {"kernel": f"{cell}_cluster", "units": units,
                       "batch": batch, "steps": steps, "windows": win,
                       "cluster": cluster,
                       "clusters": -(-batch // win),
                       "fwd_clusters_at_once": slots["fwd"],
                       "bwd_clusters_at_once": slots["bwd"]}

                def launch(fn, fn_args):
                    err = fn(n, *fn_args, stream)
                    if err:
                        raise RuntimeError(
                            f"{cell} {row}: CUDA error {err} "
                            f"({lib.dg_error_string(err).decode()})")

                try:
                    launch(lib.dg_sweep_fwd, fwd_args)
                    launch(lib.dg_sweep_bwd, bwd_args)
                except RuntimeError as err:
                    row["refused"] = str(err)
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    continue
                torch.cuda.synchronize()
                fwd_err = max((o - w).abs().max().item()
                              for o, w in zip(outs, want))
                cot_rel = rel_err(cot, want_cot)
                if not (fwd_err <= chip_smoke.TOL
                        and cot_rel <= chip_smoke.GRAD_RTOL):
                    raise AssertionError(f"{cell} {row}: forward error "
                                         f"{fwd_err}, cotangents {cot_rel}")
                row.update(
                    fwd_max_abs_err=fwd_err, cot_max_rel_err=cot_rel,
                    fwd_ms=chip_smoke.cuda_ms(
                        torch, lambda: launch(lib.dg_sweep_fwd, fwd_args),
                        5),
                    recurrence_ms=chip_smoke.cuda_ms(
                        torch, lambda: launch(lib.dg_sweep_bwd, bwd_args),
                        5))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def quick_ms(torch, launch) -> float:
    """CUDA-event ms of ``launch`` (warm): one launch timed, then the mean
    over 2 to 20 more (about 0.2 s)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    reps = max(2, min(20, int(200.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_case(torch, cell: str, batch: int, steps: int, units: int):
    """Weights, codes, masks at rate 0.0928 and output cotangents, made on
    the card from a seed of the shape."""
    import chip_smoke

    gates = 4 if cell == "lstm" else 3
    params, codes = chip_smoke.random_rnn_on_card(
        torch, units + batch + steps + gates, gates, batch, steps, units)
    gen = torch.Generator(device="cuda").manual_seed(units)
    keep = 1.0 - chip_smoke.FLAGSHIP["dropout"]
    masks = (torch.rand(gates, 2 * batch, 5, generator=gen, device="cuda")
             < keep).float() / keep
    d_avg = torch.randn(batch, steps, units, generator=gen, device="cuda")
    d_hid = torch.randn(batch, units, generator=gen, device="cuda")
    return params, codes, masks, d_avg, d_hid


def plain_cotangents(cell: str, params, codes, masks, seqs, d_avg, d_hid):
    """The plain recurrence's gate cotangents ((da,) or (d_rp, d_xp))."""
    from deepgrp_tpu_torch.models import rnn

    if cell == "lstm":
        return (rnn.lstm_bwd_recurrence_plain(params, codes, masks, *seqs,
                                              d_avg, d_hid),)
    return rnn.gru_bwd_recurrence_plain(params, codes, masks, seqs[0], d_avg,
                                        d_hid)


def rel_err(got, want) -> float:
    return max((g - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want))


def train_bound(gates: int, batch: int, steps: int, units: int) -> dict:
    """The bound of the forward and the backward as ``chip_smoke.py``'s
    phase 6 counts it: the recurrent products' FLOP (the backward 3x) at
    67 TFLOP/s against each input read and each output written once."""
    import chip_smoke

    fwd_flops = 2.0 * (2 * batch) * steps * units * gates * units
    params = 4 * (5 * gates * units + gates * units * units
                  + (2 if gates == 3 else 1) * gates * units)
    ins = batch * steps + 4 * gates * 2 * batch * 5 + params
    seqs = 4 * (gates - 2) * 2 * batch * steps * units
    outs = 4 * (batch * steps * units + batch * units)
    out = {}
    for kind, flops, n_bytes in (("fwd", fwd_flops, ins + seqs + outs),
                                 ("bwd", 3 * fwd_flops,
                                  ins + seqs + outs + params)):
        t_ops = flops / chip_smoke.PEAK_F32_FLOPS
        t_bytes = n_bytes / chip_smoke.PEAK_BYTES
        out[f"{kind}_bound_ms"] = 1e3 * max(t_ops, t_bytes)
    return out


def route_rows(torch, lib, args, card: str) -> list:
    """``--routes``: every tile at each width, cell and batch (see the
    module's note); one row a case, then :func:`route_summary`."""
    rows = []
    for units in (int(u) for u in args.units.split(",")):
        for cell in args.cells.split(","):
            for batch, steps in ROUTE_BATCHES:
                row = {"cell": cell, "batch": batch, "steps": steps,
                       "units": units}
                route_case(torch, lib, row)
                row["card"] = card
                rows.append(row)
                print(json.dumps(row), flush=True)
                if args.out:
                    with open(args.out, "a") as fh:
                        fh.write(json.dumps(row) + "\n")
                torch.cuda.empty_cache()
    route_summary(rows)
    return rows


def route_case(torch, lib, row: dict) -> None:
    """One case of :func:`route_rows`, its results written into ``row``;
    raises if a launch differs from its plain version."""
    import chip_smoke
    from deepgrp_tpu_torch.models import cuda_rnn

    cell, batch, steps, units = (row[k] for k in ("cell", "batch", "steps",
                                                  "units"))
    gates = 4 if cell == "lstm" else 3
    params, codes, masks, d_avg, d_hid = card_case(torch, cell, batch, steps,
                                                   units)
    plain_fwd, plain_bwd = cuda_rnn._PLAIN[cell]
    want = plain_fwd(params, codes, masks)
    seqs = tuple(want[2:])
    want_g = plain_bwd(params, codes, masks, *seqs, d_avg, d_hid)
    want_cot = plain_cotangents(cell, params, codes, masks, seqs, d_avg,
                                d_hid)
    torch.cuda.synchronize()
    row.update(train_bound(gates, batch, steps, units))
    row["routed_layout"] = cuda_rnn.train_layout(units)
    bad = []
    for key, grid in (("routed", False), ("grid", True)):
        got = cuda_rnn.train_fwd(cell, params, codes, masks, grid)
        grads = cuda_rnn.train_bwd(cell, params, codes, masks, seqs, d_avg,
                                   d_hid, grid)
        torch.cuda.synchronize()
        row[f"{key}_fwd_err"] = max((g - w).abs().max().item()
                                    for g, w in zip(got, want))
        row[f"{key}_grad_rel_err"] = rel_err(grads, want_g)
        if not (row[f"{key}_fwd_err"] <= chip_smoke.TOL
                and row[f"{key}_grad_rel_err"] <= chip_smoke.GRAD_RTOL):
            bad.append(key)
        del got, grads
        row[f"{key}_fwd_ms"] = quick_ms(torch, lambda: cuda_rnn.train_fwd(
            cell, params, codes, masks, grid))
        row[f"{key}_bwd_ms"] = quick_ms(torch, lambda: cuda_rnn.train_bwd(
            cell, params, codes, masks, seqs, d_avg, d_hid, grid))
    cot = cuda_rnn._bwd_recurrence(cell, params, codes, masks, seqs, d_avg,
                                   d_hid)
    grads = [torch.empty_like(params[k])
             for k in ("kernel", "recurrent", "bias")]
    row["reduce_ms"] = quick_ms(torch, lambda: cuda_rnn._train_reduce(
        seqs[0], codes, masks, gates, grads, *cot))
    del cot, grads
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = [codes.data_ptr(), batch, steps, masks.data_ptr(),
           params["kernel"].data_ptr(), params["bias"].data_ptr(),
           params["recurrent"].data_ptr(), units]
    row["clusters"] = {}
    for n, (g, win, cluster) in enumerate(VARIANTS):
        if g != gates or -(-units // cluster) > 64:
            continue
        outs = [torch.empty_like(w) for w in want]
        cots = [torch.empty_like(c) for c in want_cot]
        fwd_args = ptr + [o.data_ptr() for o in outs] + (
            [None] if cell == "gru" else [])
        bwd_args = (ptr + [q.data_ptr() for q in seqs]
                    + ([None] if cell == "gru" else [])
                    + [d_avg.data_ptr(), d_hid.data_ptr()]
                    + [c.data_ptr() for c in cots]
                    + ([None] if cell == "lstm" else []))
        entry = {}

        def launch(fn, fn_args):
            err = fn(n, *fn_args, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} "
                                   f"({lib.dg_error_string(err).decode()})")

        try:
            launch(lib.dg_sweep_fwd, fwd_args)
            launch(lib.dg_sweep_bwd, bwd_args)
        except RuntimeError as err:
            row["clusters"][f"c{cluster}w{win}"] = {"refused": str(err)}
            continue
        torch.cuda.synchronize()
        entry["fwd_err"] = max((o - w).abs().max().item()
                               for o, w in zip(outs, want))
        entry["cot_rel_err"] = rel_err(cots, want_cot)
        if not (entry["fwd_err"] <= chip_smoke.TOL
                and entry["cot_rel_err"] <= chip_smoke.GRAD_RTOL):
            bad.append(f"c{cluster}w{win}")
        entry["fwd_ms"] = quick_ms(
            torch, lambda: launch(lib.dg_sweep_fwd, fwd_args))
        entry["rec_ms"] = quick_ms(
            torch, lambda: launch(lib.dg_sweep_bwd, bwd_args))
        entry["bwd_ms"] = entry["rec_ms"] + row["reduce_ms"]
        row["clusters"][f"c{cluster}w{win}"] = entry
        del outs, cots
    lib_fwd, lib_fwd_bwd = chip_smoke.library_rnn_train(torch, gates, params,
                                                        codes)
    row["cudnn_fwd_ms"] = quick_ms(torch, lib_fwd)
    row["cudnn_fwd_bwd_ms"] = quick_ms(torch, lib_fwd_bwd)
    if bad:
        raise AssertionError(f"{row}: {bad} differ from the plain versions")


def route_summary(rows) -> dict:
    """For each width: each tile's forward + backward over the fastest
    tile's at each batch and cell, the largest of those ratios, and the
    cluster tile's CTAs a cluster (forward, backward) that make its
    largest ratio least, the windows a cluster free by batch; returns
    them by width."""
    by_width = defaultdict(list)
    for row in rows:
        by_width[row["units"]].append(row)
    out = {}
    for units, cases in sorted(by_width.items()):
        def cluster_ms(row, c_fwd, c_bwd):
            fwd = [v["fwd_ms"] for k, v in row["clusters"].items()
                   if k.startswith(f"c{c_fwd}w") and "fwd_ms" in v]
            bwd = [v["bwd_ms"] for k, v in row["clusters"].items()
                   if k.startswith(f"c{c_bwd}w") and "bwd_ms" in v]
            return min(fwd) + min(bwd) if fwd and bwd else float("inf")

        sizes = (4, 8, 16)
        pairs = [(f, b) for f in sizes for b in sizes
                 if all(cluster_ms(r, f, b) < float("inf") for r in cases)]
        tiles = {}
        for row in cases:
            times = {"routed": row["routed_fwd_ms"] + row["routed_bwd_ms"],
                     "grid": row["grid_fwd_ms"] + row["grid_bwd_ms"],
                     **{f"cluster_{f}_{b}": cluster_ms(row, f, b)
                        for f, b in pairs}}
            best = min(times.values())
            for name, ms in times.items():
                tiles.setdefault(name, []).append(ms / best)
        worst = {name: max(ratios) for name, ratios in tiles.items()}
        clusters = [n for n in worst if n.startswith("cluster_")]
        best_cluster = min(clusters, key=worst.get) if clusters else None
        out[units] = {"worst": worst, "best_cluster": best_cluster}
        print(f"u={units} (routed {cases[0]['routed_layout']}): largest "
              f"ratio to the fastest over cells and batches: routed "
              f"{worst['routed']:.3f}, grid {worst['grid']:.3f}"
              + (f", {best_cluster} {worst[best_cluster]:.3f}"
                 if best_cluster else ""), flush=True)
        for row in cases:
            best = ""
            if best_cluster:
                sizes = map(int, best_cluster.split("_")[1:])
                best = f"{best_cluster} {cluster_ms(row, *sizes):.3f}, "
            print(f"  {row['cell']} B={row['batch']} T={row['steps']}: ms "
                  f"fwd + bwd routed {row['routed_fwd_ms']:.3f} + "
                  f"{row['routed_bwd_ms']:.3f}, grid {row['grid_fwd_ms']:.3f}"
                  f" + {row['grid_bwd_ms']:.3f}, " + best
                  + f"cuDNN {row['cudnn_fwd_ms']:.3f} / "
                  f"{row['cudnn_fwd_bwd_ms']:.3f}, bound "
                  f"{row['fwd_bound_ms']:.3f} / {row['bwd_bound_ms']:.3f}",
                  flush=True)
    return out


def build_ablations():
    """Builds every copy of :data:`ABLATION_SOURCES` in parallel (one nvcc
    each, in a directory of its own); returns the libraries by name."""
    from deepgrp_tpu_torch import _build

    with open(os.path.join(CSRC, "rnn_grid.cu")) as fh:
        source = fh.read()
    libs, errors = {}, []

    def build(name):
        try:
            text = source
            for old, new in ABLATION_SOURCES[name]:
                if text.count(old) != 1:
                    raise RuntimeError(f"ablation {name}: the edit does not "
                                       f"apply once to rnn_grid.cu:\n{old}")
                text = text.replace(old, new)
            src_dir = _build.BUILD_DIR / "ablation" / f"train_grid_{name}"
            src_dir.mkdir(parents=True, exist_ok=True)
            (src_dir / "rnn_grid.cu").write_text(text)
            path = _build.build_shared_library(
                f"train_grid_{name}", [_build.nvcc()],
                [src_dir / "rnn_grid.cu"], (*_build.NVCC_FLAGS, "-I", CSRC))
            lib = ctypes.CDLL(str(path))
            _build._declare_rnn_grid(lib)
            libs[name] = lib
        except BaseException as err:  # re-raised below, in the main thread
            errors.append(err)

    threads = [threading.Thread(target=build, args=(name,))
               for name in ABLATION_SOURCES]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    return {name: libs[name] for name in ABLATION_SOURCES}


def ablation_rows(torch, args, card: str) -> list:
    """``--ablate``: each copy of :data:`ABLATIONS` at each of
    :data:`ABLATION_CASES`: its gate cotangents against the plain
    recurrence, the recurrence's time and its (A) and (B) apart, beside
    the forward's time; one row each."""
    from unittest import mock

    import chip_smoke
    from train_turns import kernel_ms

    from deepgrp_tpu_torch import _build
    from deepgrp_tpu_torch.models import cuda_rnn

    libs = build_ablations()
    load = _build.load_kernels
    rows = []
    for cell, batch, steps, units in ABLATION_CASES:
        params, codes, masks, d_avg, d_hid = card_case(torch, cell, batch,
                                                       steps, units)
        out = cuda_rnn.train_fwd(cell, params, codes, masks, True)
        seqs = tuple(out[2:])
        want = plain_cotangents(cell, params, codes, masks, seqs, d_avg,
                                d_hid)
        fwd_ms = quick_ms(torch, lambda: cuda_rnn.train_fwd(
            cell, params, codes, masks, True))
        for name, (copy, groups) in ABLATIONS.items():
            lib = libs[copy] if copy else load("rnn_grid")

            def recurrence(groups=groups):
                return cuda_rnn._bwd_recurrence(cell, params, codes, masks,
                                                seqs, d_avg, d_hid, True,
                                                groups)

            with mock.patch.object(
                    _build, "load_kernels",
                    lambda which: lib if which == "rnn_grid" else load(which)):
                got = recurrence()
                torch.cuda.synchronize()
                row = {"ablation": name, "cell": cell, "batch": batch,
                       "steps": steps, "units": units,
                       "cot_rel_err": rel_err(got, want),
                       "bits_as_shipped": None, "fwd_ms": fwd_ms,
                       "recurrence_ms": quick_ms(torch, recurrence),
                       "kernel_ms": kernel_ms(torch, recurrence),
                       "card": card}
                if name == "shipped":
                    shipped = got
                row["bits_as_shipped"] = all(
                    torch.equal(g, s) for g, s in zip(got, shipped))
                del got
            step = row["kernel_ms"].get("GridBwdStepKernel", 0.0)
            row["b_over_fwd"] = step / fwd_ms
            if not row["cot_rel_err"] <= chip_smoke.GRAD_RTOL:
                raise AssertionError(f"{row}: cotangents differ from the "
                                     "plain recurrence")
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
        del params, codes, masks, d_avg, d_hid, out, seqs, want, shipped
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--units")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=342)
    parser.add_argument("--cells", default="gru,lstm")
    parser.add_argument("--clusters", action="store_true",
                        help="time the cluster tile's layouts")
    parser.add_argument("--grid", action="store_true",
                        help="time the grid tile beside the routed launch")
    parser.add_argument("--routes", action="store_true",
                        help="time every tile past u=128 in turns")
    parser.add_argument("--ablate", action="store_true",
                        help="time edited copies of the grid's backward")
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
    if args.units is None and args.grid:
        args.units = ",".join(map(str, avg_tile_sweep().GRID_WIDTHS))
    if args.units is None and args.routes:
        args.units = ",".join(map(str, ROUTE_WIDTHS))
    if args.units is None:
        args.units = ("256,300,512,1024" if args.clusters
                      else "128,129,160,192,224,256,300,512,1024")
    if not torch.cuda.is_available():
        print("train_tile_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from deepgrp_tpu_torch import _build
    from deepgrp_tpu_torch.models import cuda_rnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    if args.grid:
        grid_rows(torch, args, card)
        return 0
    if args.ablate:
        sys.path.insert(0, os.path.join(HERE, "tools"))
        ablation_rows(torch, args, card)
        return 0
    if args.routes:
        lib, _ = build_sweep()
        route_rows(torch, lib, args, card)
        return 0
    if args.clusters:
        lib, log = build_sweep()
        rows = cluster_rows(torch, lib, log, args, card)
    else:
        rows = width_rows(torch, chip_smoke, _build, cuda_rnn, args)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


def avg_tile_sweep():
    """The inference sweep's module (its widths, batches and timer)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import avg_tile_sweep as module

    return module


def grid_rows(torch, args, card: str) -> list:
    """``--grid``: the routed training kernels and the grid tile's, checked
    against the plain versions and timed, at each cell, width and
    (batch, T); one row each."""
    import chip_smoke

    sweep = avg_tile_sweep()
    rows, failed = [], []
    for units in (int(u) for u in args.units.split(",")):
        for cell in args.cells.split(","):
            for batch, steps in sweep.GRID_BATCHES:
                row = {"cell": cell, "batch": batch, "steps": steps,
                       "units": units}
                try:
                    grid_case(torch, sweep, row)
                except RuntimeError as err:  # a launch refused, or memory
                    row["error"] = str(err)
                if "error" in row or not all(
                        row[f"{key}_fwd_err"] <= chip_smoke.TOL
                        and row[f"{key}_grad_rel_err"] <= chip_smoke.GRAD_RTOL
                        for key in ("routed", "grid")):
                    failed.append(row)
                row["card"] = card
                rows.append(row)
                print(json.dumps(row), flush=True)
                if args.out:
                    with open(args.out, "a") as fh:
                        fh.write(json.dumps(row) + "\n")
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{len(failed)} cases differ from the plain "
                             f"versions: {failed}")
    return rows


def grid_case(torch, sweep, row: dict) -> None:
    """One case of :func:`grid_rows`, its results written into ``row``."""
    from deepgrp_tpu_torch.models import cuda_rnn

    cell, batch, steps, units = (row[k] for k in ("cell", "batch", "steps",
                                                  "units"))
    params, codes, masks, d_avg, d_hid = card_case(torch, cell, batch, steps,
                                                   units)
    plain_fwd, plain_bwd = cuda_rnn._PLAIN[cell]
    want = plain_fwd(params, codes, masks)
    seqs = tuple(want[2:])
    want_g = plain_bwd(params, codes, masks, *seqs, d_avg, d_hid)
    torch.cuda.synchronize()
    row["routed_layout"] = cuda_rnn.train_layout(units)
    for key, grid in (("routed", False), ("grid", True)):
        def fwd(grid=grid):
            return cuda_rnn.train_fwd(cell, params, codes, masks, grid)

        def bwd(grid=grid):
            return cuda_rnn.train_bwd(cell, params, codes, masks, seqs,
                                      d_avg, d_hid, grid)

        got = fwd()
        torch.cuda.synchronize()
        row[f"{key}_fwd_err"] = sweep.max_err(got, want)
        del got
        row[f"{key}_fwd_ms"] = sweep.adaptive_ms(torch, fwd)
        grads = bwd()
        torch.cuda.synchronize()
        row[f"{key}_grad_rel_err"] = rel_err(grads, want_g)
        del grads
        row[f"{key}_bwd_ms"] = sweep.adaptive_ms(torch, bwd)
    for kind in ("fwd", "bwd"):
        row[f"grid_over_routed_{kind}"] = (row[f"grid_{kind}_ms"]
                                           / row[f"routed_{kind}_ms"])
    row["grid_over_routed"] = ((row["grid_fwd_ms"] + row["grid_bwd_ms"])
                               / (row["routed_fwd_ms"]
                                  + row["routed_bwd_ms"]))


def width_rows(torch, chip_smoke, _build, cuda_rnn, args) -> list:
    """The library's own layout at each width, checked and timed as
    ``chip_smoke.py``'s phase 6 does; one row a kernel and width."""
    _build.load_kernels("rnn_train")
    log = (_build.BUILD_DIR / "rnn_train.log").read_text()
    for template in ("LstmTrainFwdKernel", "GruTrainFwdKernel",
                     "LstmBwdRecurrenceKernel", "GruBwdRecurrenceKernel",
                     "TrainFwdClusterKernel", "BwdRecurrenceClusterKernel"):
        for variant, usage in sorted(chip_smoke.ptxas_usage(
                log, template).items()):
            print(f"{template}<{variant}>: {usage}", flush=True)

    gen = torch.Generator().manual_seed(2025)
    rows = []
    for cell in args.cells.split(","):
        gates = 4 if cell == "lstm" else 3
        for units in (int(u) for u in args.units.split(",")):
            tile = cuda_rnn.train_tile(cell, args.batch, units, args.steps)
            print(f"{cell} B={args.batch} T={args.steps} u={units}: {tile}",
                  flush=True)
            case = chip_smoke.train_case(torch, gen, gates, args.batch,
                                         args.steps, units)
            errors = chip_smoke.check_train_kernels(torch, cell, case,
                                                    case[2])
            for name, row in chip_smoke.time_train_kernels(
                    torch, cell, case, errors).items():
                rows.append({"kernel": name, "units": units,
                             "batch": args.batch, "steps": args.steps,
                             "tile": tile, **row})
                print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
