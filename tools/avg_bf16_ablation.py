#!/usr/bin/env python3
"""Times ablations of the bf16 tensor-core tile on a CUDA card: what its
step's time is made of.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/avg_bf16_ablation.py [--units U] [--out FILE.json]
    python3 tools/avg_bf16_ablation.py --grid [--out FILE.json]

Each ablation is a copy of ``deepgrp_tpu_torch/csrc/rnn_avg.cu`` and of
the header it includes, ``rnn_mma.cuh``, with one edit to
``MmaAvgKernel``, its gate functions or the ``mma`` (each edit must apply
once to one of the two, or the script fails), built beside the package's
build:

* ``shipped``: the source as it is;
* ``libm_gates``: the gates through ``expf``, the IEEE quotient and
  ``tanhf`` (the float32 tile's ``Sigmoid`` and ``tanhf``);
* ``approx_tanh``: sigmoid and tanh through ``tanh.approx.f32`` (relative
  error up to 2^-11);
* ``two_chains``: the products of odd and even k-tiles in two
  accumulators, added at the end;
* ``no_gates``: a trivial cell in place of the gate math (timing only:
  its output is wrong);
* ``no_mma``: a cheap dependence in place of each ``mma`` (timing only);
* ``cta_barrier``: on the cluster tile (u > 128), the CTA's barrier in
  place of the cluster's at the end of each step, one cluster barrier
  after the last (timing only: a CTA may read its peers' h before they
  wrote it);
* ``local_h``: on the cluster tile, each CTA writes its new h into its
  own buffer only, no DSMEM hand-off (timing only).

For each, at the flagship width (u=60, T=342; ``--units`` another) and
the engine's batch (1024 windows) and the CLI's default (256), with the
windows a CTA the entry points choose (``cuda_rnn.avg_tile``: 8 and 2 a
CTA at u=60), both cells through their ``_bf16`` entry points: the
CUDA-event time over 20 launches after a warm-up and the largest
difference to the plain version, with the card's name and power limit.

``--grid``: the same for the grid tile's bf16 step (``GridMmaKernel`` of
``csrc/rnn_grid.cu``) through ``dg_avg_grid`` at the shapes of
:data:`GRID_CASES`, each time over up to 20 launches:

* ``shipped``;
* ``no_copies``: no cp.async copies past the ring's first stages
  (timing only);
* ``no_mma``: a cheap dependence in place of each ``mma`` (timing only);
* ``u_from_l2``: every k-tile's U read from U's first 256 rows, which
  stay in L2 (timing only);
* ``stages_5``: a ring of 5 stages.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "deepgrp_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "rnn_avg.cu")
HEADER = "rnn_mma.cuh"
GRID_SOURCE = os.path.join(CSRC, "rnn_grid.cu")

_MMA = '''  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
_SIGMOID = "  return __fdividef(1.0f, 1.0f + __expf(-x));"
_TANH = "  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));"
_GRU_GATES = '''    const float z = FastSigmoid(x[0] + (d[0] + b_rec[0]));
    const float r = FastSigmoid(x[1] + (d[1] + b_rec[1]));
    const float hh = FastTanh(x[2] + r * (d[2] + b_rec[2]));
    h = z * h + (1.0f - z) * hh;'''
_LSTM_GATES = '''    const float ig = FastSigmoid(x[0] + d[0]);
    const float fg = FastSigmoid(x[1] + d[1]);
    const float gg = FastTanh(x[2] + d[2]);
    const float og = FastSigmoid(x[3] + d[3]);
    c = fg * c + ig * gg;
    h = og * FastTanh(c);'''
_ACC = "    float acc[kGates][4] = {};\n"
_MMA_CALL = "            MmaBf16(acc[q], a, b.x, b.y);"
_GATE_MATH = "    if (w < bb && mine[0]) {\n"
_TANH_APPROX = ('  float y;\n  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : '
                '"f"({}));\n')
_STEP_BARRIER = ("    if constexpr (kCluster > 1) {\n      ClusterBarrier();\n"
                 "    } else {\n      __syncthreads();\n    }\n  }\n}\n\n"
                 "template <int kGates, int kKT, bool kUSmem, int kCluster = 1>"
                 "\nint LaunchMma(")
_HAND_OFF = ("            StoreCluster(h_peer[p] + sizeof(__nv_bfloat16) * "
             "at, pair);")

# name: [(text in the source, its replacement), ...]
ABLATIONS = {
    "shipped": [],
    "libm_gates": [(_SIGMOID, "  return Sigmoid(x);"),
                   (_TANH, "  return tanhf(x);")],
    "approx_tanh": [(_SIGMOID, _TANH_APPROX.format("0.5f * x")
                     + "  return fmaf(0.5f, y, 0.5f);"),
                    (_TANH, _TANH_APPROX.format("x") + "  return y;")],
    "two_chains": [
        (_ACC, "    float acc[kGates][4] = {}, acc2[kGates][4] = {};\n"),
        (_MMA_CALL, "            MmaBf16((kt & 1) ? acc2[q] : acc[q], a, "
                    "b.x, b.y);"),
        (_GATE_MATH, "    for (int q = 0; q < kGates; ++q)\n"
                     "      for (int e = 0; e < 4; ++e) acc[q][e] += "
                     "acc2[q][e];\n" + _GATE_MATH)],
    "no_gates": [(_GRU_GATES, "    h = 0.5f * h + 0.01f * (x[0] + d[0] + "
                              "x[1] * d[1] + x[2] * d[2] + b_rec[0]);"),
                 (_LSTM_GATES, "    c = 0.5f * c + 0.01f * (x[0] + d[0] + "
                               "x[1] * d[1] + x[2] * d[2] + x[3] * d[3]);"
                               "\n    h = c;")],
    "no_mma": [(_MMA, "  d[0] += __uint_as_float(a[0] & 3u);\n"
                      "  d[1] += __uint_as_float(a[1] & 3u);\n"
                      "  d[2] += __uint_as_float((a[2] ^ b0) & 3u);\n"
                      "  d[3] += __uint_as_float((a[3] ^ b1) & 3u);")],
    # One cluster barrier stays after the last step: a CTA must not exit
    # while its peers still write into its shared memory.
    "cta_barrier": [(_STEP_BARRIER, _STEP_BARRIER.replace(
        "      ClusterBarrier();\n", "      __syncthreads();\n").replace(
        "  }\n}\n\n", "  }\n  if constexpr (kCluster > 1) ClusterBarrier();"
        "\n}\n\n", 1))],
    "local_h": [(_HAND_OFF, "            if (p == 0) *reinterpret_cast<"
                            "uint32_t *>(s_h + at) = pair;")],
}
_GRID_COPY = "    if (next < n_tiles) load_tile(next % kMmaStages, next);\n"
_GRID_MMA = "            MmaBf16(acc[m][q][j], af[m], bf[2 * j], bf[2 * j + 1]);"
_GRID_U = "u_mat + ((k0 + kk) * kGates + g) * width + n0 + piece * 8);"
GRID_ABLATIONS = {
    "shipped": [],
    "no_copies": [(_GRID_COPY, "")],
    "no_mma": [(_GRID_MMA, "            acc[m][q][j][0] += __uint_as_float("
                           "(af[m][0] ^ bf[2 * j]) & 3u);")],
    "u_from_l2": [(_GRID_U, "u_mat + (((k0 + kk) % 256) * kGates + g) * "
                            "width + n0 + piece * 8);")],
    "stages_5": [("constexpr int kMmaStages = 4;",
                  "constexpr int kMmaStages = 5;")],
}
# (cell, batch, steps, units) of --grid: PERF.md's B=64, u=4608 and B=16
# at u=4608 (U from HBM), B=64 at u=2049 (U in L2, 16 units a CTA).
GRID_CASES = (("gru", 64, 342, 4608), ("lstm", 64, 342, 4608),
              ("gru", 16, 342, 4608), ("gru", 64, 342, 2049))
GRID_VALID = ("shipped", "stages_5")
# The engine's batch and the CLI's default.
BATCHES = (1024, 256)
STEPS = 342
# The ablations whose output is still the bf16 function.
VALID = ("shipped", "libm_gates", "approx_tanh", "two_chains")


def ablated_sources(name: str, source: str, edits) -> dict:
    """The source and ``rnn_mma.cuh``, by file name, with ``edits`` each
    applied where its text stands once."""
    texts = {}
    for path in (source, os.path.join(CSRC, HEADER)):
        with open(path) as fh:
            texts[os.path.basename(path)] = fh.read()
    for old, new in edits:
        where = [f for f, text in texts.items() if text.count(old) == 1]
        if len(where) != 1 or sum(t.count(old) for t in texts.values()) != 1:
            raise RuntimeError(f"ablation {name}: the edit does not apply "
                               f"once to {source} or {HEADER}:\n{old}")
        texts[where[0]] = texts[where[0]].replace(old, new)
    return texts


def build_all(grid: bool = False):
    """Builds every ablation (of the grid tile's bf16 step with ``grid``)
    in parallel (one nvcc each, in a directory of its own, where the
    edited header is found first); returns the libraries by name."""
    from deepgrp_tpu_torch import _build

    table = GRID_ABLATIONS if grid else ABLATIONS
    source = GRID_SOURCE if grid else SOURCE
    prefix = "grid_bf16" if grid else "avg_bf16"
    libs, errors = {}, []

    def build(name):
        try:
            src_dir = _build.BUILD_DIR / "ablation" / f"{prefix}_{name}"
            src_dir.mkdir(parents=True, exist_ok=True)
            for file, text in ablated_sources(name, source,
                                              table[name]).items():
                (src_dir / file).write_text(text)
            path = _build.build_shared_library(
                f"{prefix}_{name}", [_build.nvcc()],
                [src_dir / os.path.basename(source)],
                (*_build.NVCC_FLAGS, "-I", CSRC))
            lib = ctypes.CDLL(str(path))
            (_build._declare_rnn_grid if grid else _build._declare_rnn_avg)(
                lib)
            libs[name] = lib
        except BaseException as err:  # re-raised below, in the main thread
            errors.append(err)

    threads = [threading.Thread(target=build, args=(name,))
               for name in table]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    return libs


def grid_rows(torch, libs) -> list:
    """``--grid``: each ablation of the bf16 grid step at each of
    :data:`GRID_CASES`, checked against the plain version and timed."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from avg_tile_sweep import adaptive_ms, max_err

    import chip_smoke
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    rows = []
    for cell, batch, steps, units in GRID_CASES:
        gates = 4 if cell == "lstm" else 3
        params, codes = chip_smoke.random_rnn_on_card(
            torch, units + batch, gates, batch, steps, units)
        want = getattr(rnn, f"{cell}_avg_plain")(params, codes,
                                                 torch.bfloat16)
        for name, lib in libs.items():
            def launch():
                avg = torch.empty(batch, steps, units, device="cuda",
                                  dtype=torch.bfloat16)
                hidden = torch.empty(batch, units, device="cuda",
                                     dtype=torch.bfloat16)
                recurrent, h, carry = cuda_rnn._grid_buffers(
                    lib, 2 * batch, units, gates, params["recurrent"],
                    torch.bfloat16)
                err = lib.dg_avg_grid(
                    gates, 1, codes.data_ptr(), batch, steps,
                    params["kernel"].data_ptr(), params["bias"].data_ptr(),
                    recurrent.data_ptr(), units, h[0].data_ptr(),
                    h[1].data_ptr(), carry.data_ptr(), avg.data_ptr(),
                    hidden.data_ptr(),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"{name}: {lib.dg_error_string(err)}")
                return avg, hidden

            got = launch()
            torch.cuda.synchronize()
            row = {"ablation": name, "cell": cell, "batch": batch,
                   "steps": steps, "units": units,
                   "max_abs_err": max_err(got, want),
                   "ms": adaptive_ms(torch, launch),
                   "output": "bf16 function" if name in GRID_VALID
                             else "timing only"}
            del got
            rows.append(row)
            print(json.dumps(row), flush=True)
        del want, params, codes
    return rows


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--units", type=int, default=60,
                        help="the layer's width (default: the flagship's)")
    parser.add_argument("--grid", action="store_true",
                        help="ablate the grid tile's bf16 step instead")
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
    units = args.units
    if not torch.cuda.is_available():
        print("avg_bf16_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from avg_tile_sweep import gru_weights, time_ms

    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    if args.grid:
        rows = grid_rows(torch, build_all(grid=True))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump({"card": card, "rows": rows}, fh, indent=1)
        return 0
    libs = build_all()
    rows = []
    for gates, cell in ((3, "gru"), (4, "lstm")):
        plain = rnn.lstm_avg_plain if gates == 4 else rnn.gru_avg_plain
        for batch in BATCHES:
            bb = cuda_rnn.avg_tile(cell, batch, units, None,
                                   torch.bfloat16)[0]
            gen = torch.Generator().manual_seed(batch + gates)
            params = gru_weights(torch, gen, gates, 5, units)
            codes = torch.randint(0, 6, (batch, STEPS), generator=gen,
                                  dtype=torch.int8).cuda()
            want = plain(params, codes, torch.bfloat16)
            for name, lib in libs.items():
                avg = torch.empty(batch, STEPS, units, device="cuda",
                                  dtype=torch.bfloat16)
                hidden = torch.empty(batch, units, device="cuda",
                                     dtype=torch.bfloat16)
                entry = getattr(lib, f"dg_{cell}_avg_bf16")

                def launch():
                    err = entry(
                        codes.data_ptr(), batch, STEPS,
                        params["kernel"].data_ptr(),
                        params["bias"].data_ptr(),
                        params["recurrent"].data_ptr(), units, bb,
                        avg.data_ptr(), hidden.data_ptr(),
                        ctypes.c_void_p(
                            torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"{name}: "
                                           f"{lib.dg_error_string(err)}")

                row = {"ablation": name, "cell": cell, "batch": batch,
                       "windows_a_cta": bb, "units": units,
                       "cluster": cuda_rnn.avg_bf16_cluster(cell, units),
                       "ms": time_ms(torch, launch),
                       "max_abs_err": max(
                           (o.float() - w.float()).abs().max().item()
                           for o, w in zip((avg, hidden), want)),
                       "output": "bf16 function" if name in VALID
                                 else "timing only"}
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
