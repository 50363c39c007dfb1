#!/usr/bin/env python3
"""Times ablations of the bf16 tensor-core tile on a CUDA card: what its
step's time is made of.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/avg_bf16_ablation.py [--units U] [--out FILE.json]

Each ablation is a copy of ``deepgrp_tpu_torch/csrc/rnn_avg.cu`` with one
edit to ``MmaAvgKernel`` or its gate functions (each edit must apply, or
the script fails), built beside the package's build:

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
SOURCE = os.path.join(HERE, "deepgrp_tpu_torch", "csrc", "rnn_avg.cu")

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
# The engine's batch and the CLI's default.
BATCHES = (1024, 256)
STEPS = 342
# The ablations whose output is still the bf16 function.
VALID = ("shipped", "libm_gates", "approx_tanh", "two_chains")


def ablated_source(name: str) -> str:
    with open(SOURCE) as fh:
        text = fh.read()
    for old, new in ABLATIONS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation {name}: the edit does not apply "
                               f"once to {SOURCE}:\n{old}")
        text = text.replace(old, new)
    return text


def build_all():
    """Builds every ablation in parallel (one nvcc each); returns the
    libraries by name."""
    from deepgrp_tpu_torch import _build

    src_dir = _build.BUILD_DIR / "ablation"
    src_dir.mkdir(parents=True, exist_ok=True)
    libs, errors = {}, []

    def build(name):
        try:
            src = src_dir / f"avg_bf16_{name}.cu"
            src.write_text(ablated_source(name))
            path = _build.build_shared_library(
                f"avg_bf16_{name}", [_build.nvcc()], [src],
                (*_build.NVCC_FLAGS, "-I", str(_build.PKG_DIR / "csrc")))
            lib = ctypes.CDLL(str(path))
            _build._declare_rnn_avg(lib)
            libs[name] = lib
        except BaseException as err:  # re-raised below, in the main thread
            errors.append(err)

    threads = [threading.Thread(target=build, args=(name,))
               for name in ABLATIONS]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    return libs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--units", type=int, default=60,
                        help="the layer's width (default: the flagship's)")
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
