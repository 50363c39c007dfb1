#!/usr/bin/env python3
"""Times ablations of the float32 stationary tile on a CUDA card: what its
step's time is made of.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/avg_stationary_ablation.py [--cases gru:64x342x1024,...]
        [--ablations shipped,no_copies,...] [--out FILE.json]

Each ablation is a copy of ``deepgrp_tpu_torch/csrc/rnn_avg.cu`` (and of
``rnn_mma.cuh``, which it includes) with edits to ``AvgStationaryKernel``
or its layout (each edit must apply once, or the script fails), built
beside the package's build:

* ``shipped``: the source as it is;
* ``no_copies``: no copies of h into the ring past its first stages
  (timing only: later stages hold stale rows);
* ``no_barrier``: the CTA's barrier in place of the grid's between steps
  (timing only: a CTA may read h before its owner wrote it);
* ``no_fma``: one add a lane in place of a quad's products (timing only);
* ``stages_2``: a ring of 2 stages (up to 4 shipped);
* ``k_32``: stages of 32 k in place of 64.

For each, at :data:`CASES` (cell, batch, T, u; ``--cases`` others, each
with a variant after a second colon, else the one the library picks;
``--ablations`` a subset), launched through ``dg_avg_stationary``
with a zeroed scratch of its layout: the CUDA-event time (over up to 20
launches, about a second's worth, after one) and the largest difference
to the plain version, with the card's name and power limit.
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

_COPY = "      issue(c + stages - 1);\n"
_BARRIER = ("    if (t + 1 < steps) GridBarrier(a.count, (t + 1) * "
            "gridDim.x);\n")
_FMA = "                acc[w][b][o] = fmaf(hv[cq], u_q[cq][o], acc[w][b][o]);"
_STAGES = "std::min<size_t>(kStatStages,"
_K = "constexpr int kStatK = 64;"

# name: [(text in the source, its replacement), ...]
ABLATIONS = {
    "shipped": [],
    "no_copies": [(_COPY, "      if (c + stages - 1 < stages) "
                          "issue(c + stages - 1); else StatCommit();\n")],
    "no_barrier": [(_BARRIER, "    __syncthreads();\n")],
    "no_fma": [(_FMA, "                if (cq == 0 && o == 0) "
                      "acc[w][b][0] += hv[0] + u_q[0][0];")],
    "stages_2": [(_STAGES, "std::min<size_t>(2,")],
    "k_32": [(_K, "constexpr int kStatK = 32;")],
}
# The ablations whose output is still the function.
VALID = ("shipped", "stages_2", "k_32")
# PERF.md's two claimed shapes, a small batch at the ceiling and the
# ragged one of the card tests.
CASES = ("gru:64x342x1024", "gru:256x342x512", "gru:16x342x1024",
         "gru:5x23x1024", "lstm:64x342x1024")


def build_all(names=tuple(ABLATIONS)):
    """Builds the ablations ``names`` in parallel (one nvcc each, in a directory of
    its own, where the edited header is found first); returns the
    libraries by name."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from avg_bf16_ablation import ablated_sources

    from deepgrp_tpu_torch import _build

    libs, errors = {}, []

    def build(name):
        try:
            src_dir = _build.BUILD_DIR / "ablation" / f"stationary_{name}"
            src_dir.mkdir(parents=True, exist_ok=True)
            for file, text in ablated_sources(name, SOURCE,
                                              ABLATIONS[name]).items():
                (src_dir / file).write_text(text)
            path = _build.build_shared_library(
                f"stationary_{name}", [_build.nvcc()],
                [src_dir / "rnn_avg.cu"], (*_build.NVCC_FLAGS, "-I", CSRC))
            lib = ctypes.CDLL(str(path))
            _build._declare_rnn_avg(lib)
            libs[name] = lib
        except BaseException as err:  # re-raised below, in the main thread
            errors.append(err)

    threads = [threading.Thread(target=build, args=(name,))
               for name in names]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    return {name: libs[name] for name in names}


def launcher(torch, lib, name: str, cell: str, params, codes,
             variant: int = -1):
    """A launch of ``lib``'s stationary tile on these inputs (its own
    layout, in ``variant``, -1 the library's) returning ``(avg,
    hidden)``."""
    from deepgrp_tpu_torch.models.cuda_rnn import STATIONARY_FIELDS

    gates = 4 if cell == "lstm" else 3
    batch, steps = codes.shape
    units = params["recurrent"].shape[0]
    out = (ctypes.c_int * len(STATIONARY_FIELDS))()
    size = lib.dg_avg_stationary_layout(gates, units, batch, variant, out)
    if size == 0:
        raise RuntimeError(f"{name}: the layout refuses {cell} B={batch} "
                           f"u={units}")

    def launch():
        scratch = torch.zeros(size, dtype=torch.uint8, device="cuda")
        avg = torch.empty(batch, steps, units, device="cuda")
        hidden = torch.empty(batch, units, device="cuda")
        err = lib.dg_avg_stationary(
            gates, variant, codes.data_ptr(), batch, steps,
            params["kernel"].data_ptr(), params["bias"].data_ptr(),
            params["recurrent"].data_ptr(), units, scratch.data_ptr(),
            avg.data_ptr(), hidden.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"{name}: {lib.dg_error_string(err)}")
        return avg, hidden

    return launch, dict(zip(STATIONARY_FIELDS, out))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", help="cell:BxTxU[:variant], "
                        "comma-separated")
    parser.add_argument("--ablations", help="names, comma-separated (by "
                        "default all)")
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("avg_stationary_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from avg_tile_sweep import adaptive_ms, max_err

    import chip_smoke
    from deepgrp_tpu_torch.models import rnn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    libs = build_all(tuple(args.ablations.split(","))
                     if args.ablations else tuple(ABLATIONS))
    rows = []
    for case in (args.cases.split(",") if args.cases else CASES):
        cell, shape, *variant = case.split(":")
        variant = int(variant[0]) if variant else -1
        batch, steps, units = (int(v) for v in shape.split("x"))
        gates = 4 if cell == "lstm" else 3
        params, codes = chip_smoke.random_rnn_on_card(
            torch, units + batch, gates, batch, steps, units)
        want = getattr(rnn, f"{cell}_avg_plain")(params, codes)
        for name, lib in libs.items():
            launch, layout = launcher(torch, lib, name, cell, params, codes,
                                      variant)
            got = launch()
            torch.cuda.synchronize()
            row = {"ablation": name, "cell": cell, "batch": batch,
                   "steps": steps, "units": units, "layout": layout,
                   "max_abs_err": max_err(got, want),
                   "ms": adaptive_ms(torch, launch),
                   "output": "the function" if name in VALID
                             else "timing only"}
            del got
            rows.append(row)
            print(json.dumps(row), flush=True)
        del want, params, codes
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
