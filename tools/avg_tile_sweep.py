#!/usr/bin/env python3
"""Times the tile variants of the register-tile inference kernels on a CUDA
card.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/avg_tile_sweep.py [--kernel avg|seq] [--out FILE.json]

``--kernel avg`` (the default): ``AvgKernel<kGates, kWin, kURegs, kBf16>``
(``deepgrp_tpu_torch/csrc/rnn_avg.cu``) takes its lane group's window count
and the place of its ``U`` slice (registers, or L1/L2) as template
parameters, and the windows a CTA owns at run time.  ``--kernel seq``:
``SeqKernel<kSl, kRows, kURegs, kBf16>`` (``csrc/rnn_seq.cu``, the GRU over
a float input) takes the k-slices a unit, the rows a lane group and the
place of ``U``, and the rows a CTA at run time.

The script builds a copy of the source with one more C entry point that
launches any variant listed for the kernel (float32), prints the
compiler's registers and spills of each, and for each case checks the
variant against the plain version (``rnn.gru_avg_plain`` /
``lstm_avg_plain`` / ``gru_apply``, atol 1e-5) and prints its CUDA-event
time over 20 launches after a warm-up, with the card's name and power
limit (and writes them to ``--out`` as JSON, if given).  Every case of a
shape runs on the same inputs.
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

# AvgKernel: (gates, windows a lane group, U in registers)
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
# SeqKernel: (slices a unit, rows a lane group, U in registers)
SEQ_VARIANTS = [(4, 8, True), (4, 16, True), (4, 4, True), (4, 8, False),
                (4, 16, False), (4, 4, False), (2, 16, False), (2, 8, False),
                (2, 4, False), (1, 4, False)]
# (rows, steps, units, rows a CTA, variant); 2048 rows is the scan route's
# doubled batch at -b 1024, 512 at the CLI's default -b 256.
SEQ_CASES = [
    (2048, 342, 60, 16, (4, 8, True)),
    (2048, 342, 60, 16, (4, 16, True)),
    (2048, 342, 60, 8, (4, 4, True)),
    (2048, 342, 60, 16, (4, 8, False)),
    (2048, 342, 60, 16, (4, 16, False)),
    (512, 342, 60, 4, (4, 4, True)),
    (512, 342, 60, 4, (4, 8, True)),
    (2048, 342, 128, 16, (4, 16, False)),
    (2048, 342, 128, 8, (4, 8, False)),
    (2048, 342, 128, 4, (4, 4, False)),
    (2048, 342, 128, 16, (2, 16, False)),
    (2048, 342, 128, 16, (2, 8, False)),
    (2048, 342, 96, 16, (4, 16, False)),
    (2048, 342, 96, 16, (2, 16, False)),
    (512, 342, 128, 4, (4, 4, False)),
    (512, 342, 128, 4, (2, 4, False)),
    (512, 342, 256, 4, (4, 4, False)),
    (512, 342, 256, 4, (2, 4, False)),
    (512, 342, 256, 4, (1, 4, False)),
    (16, 342, 512, 1, (2, 4, False)),
    (16, 342, 512, 1, (1, 4, False)),
]
TOL = 1e-5
# What each kernel's entry point passes through to LaunchTile.
_SPECS = {
    "avg": {"source": "rnn_avg.cu", "template": "AvgKernel",
            "head": "const void *codes, int batch, int steps, "
                    "const void *kernel, const void *bias, "
                    "const void *recurrent, int units, int bb, void *avg, "
                    "void *hidden",
            "args": "codes, batch, steps, kernel, bias, recurrent, units, "
                    "bb, avg, hidden",
            "launch": "LaunchTile<{0}, {1}, {2}, false>"},
    "seq": {"source": "rnn_seq.cu", "template": "SeqKernel",
            "head": "const void *x, int batch, int steps, int channels, "
                    "const void *kernel, const void *bias, "
                    "const void *recurrent, int units, int bb, void *seq, "
                    "void *last",
            "args": "x, batch, steps, channels, kernel, bias, recurrent, "
                    "units, bb, seq, last",
            "launch": "LaunchTile<{0}, {1}, {2}, false>"},
}


def sweep_source(kind: str, variants) -> str:
    """The kernel's source with ``dg_sweep(variant, <its LaunchTile's
    arguments but the stream>, stream)`` appended (the templates are in the
    file's anonymous namespace, so the entry point goes in the same
    translation unit)."""
    spec = _SPECS[kind]
    with open(os.path.join(CSRC, spec["source"])) as fh:
        text = fh.read()
    cases = "".join(
        f"    case {n}: return "
        + spec["launch"].format(*(str(v).lower() for v in variant))
        + f"({spec['args']}, s);\n" for n, variant in enumerate(variants))
    return text + (
        f'\nextern "C" int dg_sweep(int variant, {spec["head"]}, '
        "void *stream) {\n"
        "  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
        "  switch (variant) {\n" + cases + "  }\n"
        "  return static_cast<int>(cudaErrorInvalidValue);\n}\n")


def build(kind: str, variants):
    """Builds the sweep copy (beside the package's build, with ``csrc`` on
    the include path for the shared header); returns the library and the
    registers of each variant."""
    from deepgrp_tpu_torch import _build

    src_dir = _build.BUILD_DIR / "sweep"
    src_dir.mkdir(parents=True, exist_ok=True)
    name = f"{kind}_sweep"
    src = src_dir / f"{name}.cu"
    src.write_text(sweep_source(kind, variants))
    path = _build.build_shared_library(
        name, [_build.nvcc()], [src], (*_build.NVCC_FLAGS, "-I", CSRC))
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_sweep.argtypes = ([i, p, i, i, p, p, p, i, i, p, p, p]
                             if kind == "avg" else
                             [i, p, i, i, i, p, p, p, i, i, p, p, p])
    lib.dg_sweep.restype = i
    lib.dg_error_string.argtypes = [i]
    lib.dg_error_string.restype = ctypes.c_char_p
    log = (_build.BUILD_DIR / f"{name}.log").read_text()
    return lib, registers(log, _SPECS[kind]["template"])


def registers(log: str, template: str) -> dict:
    """Registers and spill bytes of each float32 variant of ``template``
    (keyed by its first three template arguments), from ``ptxas -v``."""
    from chip_smoke import ptxas_usage

    found = {}
    for args, usage in ptxas_usage(log, template).items():
        first, second, regs, bf16 = args.split(", ")
        if bf16 == "0":
            found[(int(first), int(second), regs == "1")] = usage
    return found


def time_ms(torch, launch) -> float:
    """Mean CUDA-event time of ``launch`` over 20 calls after one."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 20


def gru_weights(torch, gen, gates: int, in_dim: int, units: int) -> dict:
    width = gates * units
    params = {
        "kernel": torch.randn(in_dim, width, generator=gen) * 0.5,
        "recurrent": torch.randn(units, width, generator=gen) / units ** 0.5,
        "bias": torch.randn(*((2, width) if gates == 3 else (width,)),
                            generator=gen) * 0.3}
    return {k: v.cuda() for k, v in params.items()}


def avg_rows(torch, lib, regs):
    from deepgrp_tpu_torch.models import rnn

    rows, inputs = [], {}
    for gates, batch, steps, units, bb, variant in CASES:
        shape = (gates, batch, steps, units)
        if shape not in inputs:
            gen = torch.Generator().manual_seed(sum(shape))
            params = gru_weights(torch, gen, gates, 5, units)
            codes = torch.randint(0, 6, (batch, steps), generator=gen,
                                  dtype=torch.int8).cuda()
            plain = rnn.lstm_avg_plain if gates == 4 else rnn.gru_avg_plain
            inputs[shape] = (params, codes, plain(params, codes))
        params, codes, want = inputs[shape]
        avg = torch.empty(batch, steps, units, device="cuda")
        hidden = torch.empty(batch, units, device="cuda")
        index = VARIANTS.index(variant)

        def launch():
            return lib.dg_sweep(
                index, codes.data_ptr(), batch, steps,
                params["kernel"].data_ptr(), params["bias"].data_ptr(),
                params["recurrent"].data_ptr(), units, bb, avg.data_ptr(),
                hidden.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

        yield ({"gates": gates, "batch": batch, "steps": steps,
                "units": units, "windows_a_cta": bb,
                "windows_a_group": variant[1],
                "u_in_registers": variant[2], "ctas": -(-batch // bb),
                **regs.get(variant, {})},
               launch, (avg, hidden), want)


def seq_rows(torch, lib, regs):
    from deepgrp_tpu_torch.models import rnn

    inputs = {}
    for batch, steps, units, bb, variant in SEQ_CASES:
        shape = (batch, steps, units)
        if shape not in inputs:
            gen = torch.Generator().manual_seed(sum(shape))
            params = gru_weights(torch, gen, 3, 5, units)
            x = torch.rand(batch, steps, 5, generator=gen).cuda()
            inputs[shape] = (params, x, rnn.gru_apply(params, x))
        params, x, want = inputs[shape]
        seq = torch.empty(batch, steps, units, device="cuda")
        last = torch.empty(batch, units, device="cuda")
        index = SEQ_VARIANTS.index(variant)

        def launch():
            return lib.dg_sweep(
                index, x.data_ptr(), batch, steps, 5,
                params["kernel"].data_ptr(), params["bias"].data_ptr(),
                params["recurrent"].data_ptr(), units, bb, seq.data_ptr(),
                last.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

        yield ({"rows": batch, "steps": steps, "units": units,
                "rows_a_cta": bb, "slices": variant[0],
                "rows_a_group": variant[1], "u_in_registers": variant[2],
                "ctas": -(-batch // bb), **regs.get(variant, {})},
               launch, (seq, last), want)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(_SPECS), default="avg")
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("avg_tile_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    variants = VARIANTS if args.kernel == "avg" else SEQ_VARIANTS
    lib, regs = build(args.kernel, variants)
    template = _SPECS[args.kernel]["template"]
    for variant, info in sorted(regs.items()):
        print(f"{template}<{', '.join(map(str, variant))}> f32: {info}",
              flush=True)

    rows = []
    cases = avg_rows if args.kernel == "avg" else seq_rows
    for row, launch, outs, want in cases(torch, lib, regs):
        err = launch()
        if err:
            raise RuntimeError(f"{row}: {lib.dg_error_string(err).decode()}")
        torch.cuda.synchronize()
        row["max_abs_err"] = max((o - w).abs().max().item()
                                 for o, w in zip(outs, want))
        row["ms"] = time_ms(torch, launch)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not row["max_abs_err"] <= TOL:
            raise AssertionError(f"{row}: differs from the plain version")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernel": args.kernel, "rows": rows},
                      fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
