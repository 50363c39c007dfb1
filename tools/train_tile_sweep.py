#!/usr/bin/env python3
"""Times the training kernels (``deepgrp_tpu_torch/csrc/rnn_train.cu``) by
width on a CUDA card.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/train_tile_sweep.py [--units 128,129,160,192,224,256]
        [--batch 256] [--steps 342] [--cells gru,lstm] [--out FILE.json]

Prints the compiler's registers and spills of each kernel of the file
(``nvcc -Xptxas -v``), then for each cell and width: the window tile
(``cuda_rnn.train_tile``), the forward and backward checked against their
plain versions with dropout masks (rate 0.0928) as ``chip_smoke.py``'s
phase 6 checks them, and the times of the forward, the backward, the
backward's recurrence and reduction kernels, the plain versions and cuDNN
(``torch.nn.GRU``/``LSTM`` forward, and forward + backward, TF32 off),
with the bound of each kernel, CUDA events over 20 launches after a
warm-up (3 for the plain versions).  Writes the rows and the card's name
and power limit to ``--out`` as JSON, if given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--units", default="128,129,160,192,224,256")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=342)
    parser.add_argument("--cells", default="gru,lstm")
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
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
    _build.load_kernels("rnn_train")
    log = (_build.BUILD_DIR / "rnn_train.log").read_text()
    for template in ("LstmTrainFwdKernel", "GruTrainFwdKernel",
                     "LstmBwdRecurrenceKernel", "GruBwdRecurrenceKernel"):
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
            label = f"u{units}"
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
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
