#!/usr/bin/env python3
"""Times the tile variants of the fused inference kernel on a CUDA card.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/avg_tile_sweep.py [--out FILE.json]

``AvgKernel<kGates, kWin, kURegs, kBf16>`` (``deepgrp_tpu_torch/csrc/
rnn_avg.cu``) takes its lane group's window count and the place of its
``U`` slice (registers, or L1/L2) as template parameters, and the windows
a CTA owns at run time.  The script builds a copy of the source with one
more C entry point that launches any variant listed in ``VARIANTS``
(float32 out), prints the compiler's registers and spills of each, and for
each case of ``CASES`` checks the variant against the plain version
(``rnn.gru_avg_plain`` / ``lstm_avg_plain``, atol 1e-5) and prints its
CUDA-event time over 20 launches after a warm-up, with the card's name and
power limit (and writes them to ``--out`` as JSON, if given).  Every case of
a shape runs on the same weights and codes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (gates, windows a lane group, U in registers)
VARIANTS = [(4, 4, True), (4, 2, True), (4, 4, False), (4, 8, False),
            (4, 2, False), (3, 4, True), (3, 2, True), (3, 8, False)]
# (gates, batch, steps, units, windows a CTA, variant)
CASES = [
    (4, 1024, 342, 60, 8, (4, 4, True)),
    (4, 1024, 342, 60, 4, (4, 2, True)),
    (4, 1024, 342, 60, 2, (4, 2, True)),
    (4, 1024, 342, 60, 8, (4, 4, False)),
    (4, 1024, 342, 60, 8, (4, 8, False)),
    (4, 256, 342, 60, 2, (4, 2, True)),
    (4, 256, 342, 60, 2, (4, 2, False)),
    (4, 256, 342, 60, 4, (4, 4, True)),
    (4, 1024, 342, 96, 8, (4, 8, False)),
    (4, 1024, 342, 96, 4, (4, 4, False)),
    (4, 1024, 342, 128, 8, (4, 8, False)),
    (4, 1024, 342, 128, 4, (4, 4, False)),
    (4, 1024, 342, 128, 2, (4, 2, False)),
    (3, 1024, 342, 60, 8, (3, 4, True)),
    (3, 256, 342, 60, 2, (3, 2, True)),
    (3, 1024, 342, 128, 8, (3, 8, False)),
]
TOL = 1e-5


def sweep_source() -> str:
    """``rnn_avg.cu`` with ``dg_sweep_avg(variant, <dg_gru_avg's
    arguments>)`` appended (the templates are in the file's anonymous
    namespace, so the entry point goes in the same translation unit)."""
    with open(os.path.join(HERE, "deepgrp_tpu_torch", "csrc",
                           "rnn_avg.cu")) as fh:
        text = fh.read()
    cases = "".join(
        f"    case {n}: return LaunchTile<{g}, {w}, {str(r).lower()}, "
        "false>(codes, batch, steps, kernel, bias, recurrent, units, bb, "
        "avg, hidden, s);\n" for n, (g, w, r) in enumerate(VARIANTS))
    return text + (
        '\nextern "C" int dg_sweep_avg(int variant, const void *codes, '
        "int batch, int steps, const void *kernel, const void *bias, "
        "const void *recurrent, int units, int bb, void *avg, "
        "void *hidden, void *stream) {\n"
        "  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
        "  switch (variant) {\n" + cases + "  }\n"
        "  return static_cast<int>(cudaErrorInvalidValue);\n}\n")


def build():
    from deepgrp_tpu_torch import _build

    src_dir = _build.BUILD_DIR / "sweep"
    src_dir.mkdir(parents=True, exist_ok=True)
    src = src_dir / "rnn_avg_sweep.cu"
    src.write_text(sweep_source())
    path = _build.build_shared_library("rnn_avg_sweep", [_build.nvcc()],
                                       [src], _build.NVCC_FLAGS)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_sweep_avg.argtypes = [i, p, i, i, p, p, p, i, i, p, p, p]
    lib.dg_sweep_avg.restype = i
    lib.dg_error_string.argtypes = [i]
    lib.dg_error_string.restype = ctypes.c_char_p
    log = (_build.BUILD_DIR / "rnn_avg_sweep.log").read_text()
    return lib, registers(log)


def registers(log: str) -> dict:
    """Registers and spill bytes of each AvgKernel variant (float32 out)
    from ``ptxas -v``."""
    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"AvgKernelILi(\d)ELi(\d)ELb(\d)ELb0E", m.group(1))
            entry = (int(t.group(1)), int(t.group(2)),
                     t.group(3) == "1") if t else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found.setdefault(entry, {})["spill_bytes"] = (int(m.group(1)),
                                                          int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(entry, {})["registers"] = int(m.group(1))
    return found


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("avg_tile_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from deepgrp_tpu_torch.models import rnn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib, regs = build()
    for (g, w, r), info in sorted(regs.items()):
        print(f"AvgKernel<{g}, {w}, {r}> f32: {info}", flush=True)

    rows, inputs = [], {}
    for gates, batch, steps, units, bb, variant in CASES:
        shape = (gates, batch, steps, units)
        if shape not in inputs:
            gen = torch.Generator().manual_seed(sum(shape))
            width = gates * units
            params = {
                "kernel": torch.randn(5, width, generator=gen) * 0.5,
                "recurrent": torch.randn(units, width, generator=gen)
                / units ** 0.5,
                "bias": torch.randn(*((2, width) if gates == 3
                                      else (width,)), generator=gen) * 0.3}
            params = {k: v.cuda() for k, v in params.items()}
            codes = torch.randint(0, 6, (batch, steps), generator=gen,
                                  dtype=torch.int8).cuda()
            plain = rnn.lstm_avg_plain if gates == 4 else rnn.gru_avg_plain
            inputs[shape] = (params, codes, plain(params, codes))
        params, codes, (want_avg, want_hidden) = inputs[shape]
        avg = torch.empty(batch, steps, units, device="cuda")
        hidden = torch.empty(batch, units, device="cuda")
        index = VARIANTS.index(variant)

        def launch():
            err = lib.dg_sweep_avg(
                index, codes.data_ptr(), batch, steps,
                params["kernel"].data_ptr(), params["bias"].data_ptr(),
                params["recurrent"].data_ptr(), units, bb, avg.data_ptr(),
                hidden.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"variant {variant} bb={bb}: "
                                   f"{lib.dg_error_string(err).decode()}")

        launch()
        torch.cuda.synchronize()
        err = max((avg - want_avg).abs().max().item(),
                  (hidden - want_hidden).abs().max().item())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        row = {"gates": gates, "batch": batch, "steps": steps,
               "units": units, "windows_a_cta": bb, "windows_a_group":
               variant[1], "u_in_registers": variant[2],
               "ctas": -(-batch // bb), "max_abs_err": err, "ms": ms,
               **regs.get(variant, {})}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not err <= TOL:
            raise AssertionError(f"{row}: differs from the plain version")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
