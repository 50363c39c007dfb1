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
kCluster>``: 2, 4 or 8 windows a cluster on 8 CTAs, up to u=512, or 16):
the script builds a copy of the source with one more C entry point a
kernel that launches any of them, prints each one's registers and spills
and its clusters at once, and at each width checks the forward's outputs
(atol 1e-5) and the recurrence's gate cotangents (1e-4 of their largest
magnitude) against the plain versions and times both over 5 launches
after a warm-up, beside the library's own layout at that width (the row
``{cell}_library``: at u <= 256 the wide layout, past it the cluster
layout the library picks).

``--grid`` times the grid tile (``csrc/rnn_grid.cu``) beside the routed
launch: ``cuda_rnn.train_fwd`` and ``train_bwd`` (the recurrence and the
reduction) with ``grid=True`` beside the same calls without it, at each
width of ``--units`` (``avg_tile_sweep.GRID_WIDTHS`` by default) and each
(batch, T) of ``avg_tile_sweep.GRID_BATCHES``, inputs made on the card
from a seed, masks at rate 0.0928: the forward's outputs (1e-5) and the
gradients (1e-4 of their largest magnitude) checked against the plain
versions first, then timed as ``avg_tile_sweep.adaptive_ms`` times.  One
JSON line a case, printed and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "deepgrp_tpu_torch", "csrc")

# The cluster tile's layouts: (gates, windows a cluster, CTAs a cluster).
VARIANTS = [(gates, win, cluster) for gates in (3, 4) for cluster in (8, 16)
            for win in (2, 4, 8)]
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
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

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
            if cell == "lstm":
                want_cot = (rnn.lstm_bwd_recurrence_plain(
                    params, codes, masks, *seqs, d_avg, d_hid),)
            else:
                want_cot = rnn.gru_bwd_recurrence_plain(
                    params, codes, masks, seqs[0], d_avg, d_hid)
            torch.cuda.synchronize()
            # The library's own layout at this width (at u <= 256 the
            # wide layout), timed beside the variants.
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
                cot_rel = max((c - w).abs().max().item()
                              / w.abs().max().item()
                              for c, w in zip(cot, want_cot))
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
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
    if args.units is None and args.grid:
        args.units = ",".join(map(str, avg_tile_sweep().GRID_WIDTHS))
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
                    grid_case(torch, chip_smoke, sweep, row)
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


def grid_case(torch, chip_smoke, sweep, row: dict) -> None:
    """One case of :func:`grid_rows`, its results written into ``row``."""
    from deepgrp_tpu_torch.models import cuda_rnn

    cell, batch, steps, units = (row[k] for k in ("cell", "batch", "steps",
                                                  "units"))
    gates = 4 if cell == "lstm" else 3
    params, codes = chip_smoke.random_rnn_on_card(
        torch, units + batch + steps + gates, gates, batch, steps, units)
    gen = torch.Generator(device="cuda").manual_seed(units)
    keep = 1.0 - chip_smoke.FLAGSHIP["dropout"]
    masks = (torch.rand(gates, 2 * batch, 5, generator=gen, device="cuda")
             < keep).float() / keep
    d_avg = torch.randn(batch, steps, units, generator=gen, device="cuda")
    d_hid = torch.randn(batch, units, generator=gen, device="cuda")
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
        row[f"{key}_grad_rel_err"] = max(
            (g - w).abs().max().item() / w.abs().max().item()
            for g, w in zip(grads, want_g))
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
    for line in log.splitlines():  # the wide backwards are not templates
        if "WideKernel" in line or "Used" in line or "spill" in line:
            print(line.strip(), flush=True)

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
