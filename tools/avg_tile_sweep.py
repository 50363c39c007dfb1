#!/usr/bin/env python3
"""Times the tile variants of the register-tile inference kernels on a CUDA
card.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/avg_tile_sweep.py [--kernel avg|avg_bf16|seq]
        [--min-units N] [--out FILE.json]
    python3 tools/avg_tile_sweep.py --grid [--units 257,...,4096]
        [--rows 1,1b,2,2b,7,7b] [--mma-units 16,32] [--out FILE.jsonl]
    python3 tools/avg_tile_sweep.py --stationary --parent DIR
        [--units 129,...,1280] [--rows 1,2] [--variants] [--out FILE.jsonl]
    python3 tools/avg_tile_sweep.py --summary FILE.jsonl

``--kernel avg`` (the default): ``AvgKernel<kGates, kWin, kURegs>``
(``deepgrp_tpu_torch/csrc/rnn_avg.cu``, the float32 register tile) takes
its lane group's window count and the place of its ``U`` slice
(registers, or L1/L2) as template parameters, and the windows a CTA owns
at run time; past u=128 ``AvgClusterKernel<kGates, kWin, kCluster,
kUSmem>``, the float32 cluster tile (a window's units over ``kCluster``
CTAs, each CTA's slice of ``U`` in shared memory or read through L1/L2),
up to u=1024.  ``--kernel
avg_bf16``: the bf16 tensor-core tile of the same file,
``MmaAvgKernel<kGates, kKT, kUSmem, kCluster>``, takes the most k-tiles
(u <= 16 kKT), the place of ``U``'s fragments (registers, or shared
memory) and the CTAs a cluster that split the unit groups (1: none), and
the windows a CTA at run time (a warp a unit group and m-tile of 8
windows: at 16 windows two warps a unit group).  ``--kernel seq``:
``SeqKernel<kRows, kURegs, kBf16, kCluster, kUSmem>`` (``csrc/rnn_seq.cu``,
the GRU over a float input) takes the rows a lane group, the place of
``U`` (registers, L1/L2, or the CTA's slice in shared memory), the IO
type and the CTAs a cluster, and the rows a CTA (a cluster) at run time.
``--min-units N`` runs only the cases of at least N units.

``--grid`` times the grid tile (``csrc/rnn_grid.cu``) beside the routed
launch instead, through the wrappers of ``models/cuda_rnn.py``
(``_launch`` / ``_launch_seq`` with ``grid=True`` beside the same call
without it; once where the route is the grid tile), for the fused rows
of both cells in float32 and bf16 out (rows 1, 2, 1b, 2b) at the batches
of :data:`GRID_BATCHES`, and row 7 (the GRU sequence kernel) in float32
and bf16 IO (rows 7, 7b) at :data:`GRID_SEQ_ROWS` rows, at each width of
``--units`` (:data:`GRID_WIDTHS` by default; ``--rows`` keeps only the
rows it names): each output checked against its plain version first
(1e-5; 2e-2 in bf16), then timed with CUDA events after that launch
(over up to 20 launches, one launch where one takes more than a
second).  Beside them cuDNN's time for the same work in the row's dtype
(``torch.nn.GRU`` / ``LSTM``, TF32 off; ``library_ms``) and the bound as
``chip_smoke.py`` counts it (``bound_ms``, ``bound_by``: the FLOP at the
dot type's peak, or ``U`` once, then each step the part of it past the
card's L2 and shared memory, and the IO once, over 3.35 TB/s).  One JSON
line a case: the routed tile's name and ms, the grid's ms and their
ratio, cuDNN's ms and the bound, printed and appended to ``--out``.
``--mma-units`` also times the bf16 rows' grid step (``GridMmaKernel``)
at each unit block it lists (``mma_<n>_ms``, checked as the others),
from a copy of ``csrc/rnn_grid.cu`` built with an entry point that takes
the unit block from the caller (the library picks one by the grid's
CTAs and the card's SMs).

``--stationary`` times the float32 stationary tile (rows 1 and 2,
``AvgStationaryKernel`` of ``csrc/rnn_avg.cu``, forced at every width
through ``cuda_rnn._launch(..., stationary=True)``, the library's variant
and clusters) in turns with the parent's route, built from the parent
checkout at ``--parent DIR`` (its ``csrc/rnn_avg.cu`` as a library of its
own, launched with the windows a CTA its ``cuda_rnn.avg_tile`` gave: the
register tile, the cluster tiles; past its ceiling its route was the
grid tile, which this checkout keeps), in the order parent, stationary,
stationary, parent (each ms the mean of its two turns), then the grid
tile, at :data:`STATIONARY_WIDTHS` (``--units``) and
:data:`GRID_BATCHES`: each launch first checked against the plain
version (1e-5), and the stationary tile's outputs against the parent's
bit for bit (``bits_parent``; required where the parent's route is its
cluster tile, which sums in the same order).  Beside them cuDNN's time and the bound
as ``--grid``.  One JSON line a case, with the stationary layout; this
checkout's route (``routed_tile``) and ``routed_over_parent``; with
``--variants`` also each variant of the stationary tile forced
(``variant_<n>_ms``, checked against the library's choice bit for bit).
``--summary FILE`` prints, for each width of such lines, each tile's
largest ratio over the cells and batches to the fastest of the parent's
route, the stationary tile and the grid tile, and the routed tile's
largest ratio to the parent's route.

The script builds a copy of the source with one more C entry point that
launches any variant listed for the kernel (float32 out, bfloat16 for
``avg_bf16``; either for ``seq``), prints the compiler's registers and
spills of each, and for
each case checks the variant against the plain version
(``rnn.gru_avg_plain`` / ``lstm_avg_plain`` / ``gru_apply``, atol 1e-5;
2e-2 in bfloat16) and prints its CUDA-event time over 20 launches after a
warm-up, with the card's name and power limit (and writes them to
``--out`` as JSON, if given).  Every case of a shape runs on the same
inputs.
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

# AvgKernel: (gates, windows a lane group, U in registers); past u=128
# AvgClusterKernel: (gates, windows a lane group, CTAs a cluster, U in
# shared memory).
VARIANTS = [(4, 4, True), (4, 2, True), (4, 4, False), (4, 8, False),
            (3, 4, True), (3, 2, True), (3, 8, False)] + [
    (gates, win, cluster, u_smem) for gates in (3, 4)
    for win, cluster, u_smem in ((2, 8, True), (4, 8, True), (2, 16, True),
                                 (2, 16, False), (8, 16, False))]
# (gates, batch, steps, units, windows a CTA, variant)
CASES = [
    (4, 1024, 342, 60, 8, (4, 4, True)),
    (4, 1024, 342, 60, 4, (4, 2, True)),
    (4, 1024, 342, 60, 2, (4, 2, True)),
    (4, 1024, 342, 60, 8, (4, 4, False)),
    (4, 1024, 342, 60, 8, (4, 8, False)),
    (4, 256, 342, 60, 2, (4, 2, True)),
    (4, 256, 342, 60, 4, (4, 4, True)),
    (4, 1024, 342, 96, 8, (4, 8, False)),
    (4, 1024, 342, 96, 4, (4, 4, False)),
    (4, 1024, 342, 128, 8, (4, 8, False)),
    (4, 1024, 342, 128, 4, (4, 4, False)),
    (3, 1024, 342, 60, 8, (3, 4, True)),
    (3, 256, 342, 60, 2, (3, 2, True)),
    (3, 1024, 342, 128, 8, (3, 8, False)),
] + [
    # Past u=128 the cluster tile: 8 CTAs (2, 4 or 8 windows a cluster)
    # up to u=256 at the CLI's default batch and the engine's; past u=256
    # 16 CTAs, U in shared memory (2 windows) or through L1/L2 (2, 4, 8).
    (gates, batch, 342, units, bb, variant)
    for gates in (3, 4) for units in (160, 200, 256)
    for batch in (256, 1024)
    for bb, variant in ((2, (gates, 2, 8, True)), (4, (gates, 4, 8, True)),
                        (8, (gates, 4, 8, True)))
] + [
    (gates, batch, 342, units, bb, variant)
    for gates in (3, 4)
    for batch, units in ((256, 300), (256, 512), (64, 1024))
    for bb, variant in ((2, (gates, 2, 16, True)), (2, (gates, 2, 16, False)),
                        (4, (gates, 8, 16, False)),
                        (8, (gates, 8, 16, False)))]
# MmaAvgKernel: (gates, most k-tiles, U in shared memory, CTAs a
# cluster); a warp a unit group and m-tile of 8 windows, so 16 windows a
# CTA take two warps a unit group.  (gates, 0, False, 1): the FMA tile.
BF16_VARIANTS = ([(gates, k_tiles, u_smem, 1) for gates in (3, 4)
                  for k_tiles in (4, 8) for u_smem in (False, True)]
                 + [(gates, 16, True, cluster) for gates in (3, 4)
                    for cluster in (2, 4)]
                 + [(gates, 32, True, cluster) for gates in (3, 4)
                    for cluster in (4, 8, 16)]
                 + [(gates, 64, u_smem, 16) for gates in (3, 4)
                    for u_smem in (True, False)])
# (gates, batch, steps, units, windows a CTA, variant): the engine's batch
# (8 windows a CTA fill 128 SMs; 16 fill 64), the CLI's default -b 256 (2
# a CTA fill 128 SMs) and twice the engine's (16 a CTA fill 128 SMs; 8
# take 256 CTAs); past u=128 the cluster tile at 2 and 4 CTAs a cluster,
# 4, 8 and 16 windows a cluster.
BF16_CASES = [
    (gates, batch, 342, units, bb, variant)
    for gates in (3, 4) for units in (60, 96, 128)
    for batch, bbs in ((1024, (8, 16)), (256, (2,)), (2048, (16, 8)))
    for bb in bbs for variant in BF16_VARIANTS
    if variant[0] == gates and variant[3] == 1
    and variant[1] == (4 if units <= 64 else 8)] + [
    (gates, batch, 342, units, bb, (gates, 16, True, cluster))
    for gates in (3, 4) for units in (160, 192, 256)
    for batch in (256, 1024) for cluster in (2, 4) for bb in (4, 8, 16)] + [
    # Past u=256: clusters of 4, 8 and 16 CTAs with U's fragments in
    # shared memory (k-tiles up to 32), of 16 at u=640 in shared memory
    # and through L1/L2, and through L1/L2 at u=1024.
    (gates, batch, 342, units, bb, variant)
    for gates in (3, 4)
    for batch, units, variants in (
        (256, 300, [(gates, 32, True, c) for c in (4, 8, 16)]),
        (256, 512, [(gates, 32, True, 16)]),
        (256, 640, [(gates, 64, True, 16), (gates, 64, False, 16)]),
        (64, 1024, [(gates, 64, False, 16)]))
    for variant in variants for bb in (4, 8, 16)]
# SeqKernel: (rows a lane group, U in registers, bf16, CTAs a cluster, U
# in shared memory)
# (rows, steps, units, rows a CTA, variant); 2048 rows is the scan route's
# doubled batch at -b 1024, 512 at the CLI's default -b 256.
SEQ_CASES = [
    (rows, steps, units, bb, (*layout, False, 1, False))
    for rows, steps, units, bb, layout in (
        (2048, 342, 60, 16, (8, True)),
        (2048, 342, 60, 16, (16, True)),
        (2048, 342, 60, 8, (4, True)),
        (2048, 342, 60, 16, (8, False)),
        (2048, 342, 60, 16, (16, False)),
        (512, 342, 60, 4, (4, True)),
        (512, 342, 60, 4, (8, True)),
        (2048, 342, 128, 16, (16, False)),
        (2048, 342, 128, 8, (8, False)),
        (2048, 342, 128, 4, (4, False)),
        (2048, 342, 96, 16, (16, False)),
        (512, 342, 128, 4, (4, False)))] + [
    # Past u=128: clusters of 8 and 16 CTAs, U in shared memory or through
    # L1/L2, at a few rows a cluster; f32 and bf16.
    (rows, 342, units, bb, (group, False, bf16, cluster, u_smem))
    for bf16 in (False, True)
    for rows, units, bb, (group, cluster, u_smem) in (
        (512, 256, 16, (8, 8, True)),
        (512, 256, 16, (16, 8, True)),
        (512, 256, 4, (4, 8, True)),
        (512, 256, 16, (16, 16, True)),
        (512, 256, 16, (4, 16, True)),
        (512, 256, 16, (16, 8, False)),
        (16, 512, 4, (4, 16, True)),
        (16, 512, 2, (4, 16, True)),
        (16, 512, 2, (4, 16, False)),
        (16, 512, 2, (4, 8, False)),
        (16, 512, 1, (4, 8, False)),
        (64, 1024, 16, (16, 16, False)),
        (64, 1024, 8, (16, 16, False)),
        (64, 1024, 4, (4, 16, False)))]
SEQ_VARIANTS = sorted({case[-1] for case in SEQ_CASES})
# --grid: the widths (from the 16-CTA cluster tiles' first, u=257, to
# u=4096, either side of u=1024), the (batch, T) of the fused rows (B=16,
# 64 and 256 at T=342 and the two ragged shapes of the card tests) and the
# rows of row 7 at T=342.
GRID_WIDTHS = (257, 384, 512, 768, 1024, 1025, 1280, 1536, 2048, 3000, 4096)
GRID_BATCHES = ((16, 342), (64, 342), (256, 342), (37, 150), (5, 23))
GRID_SEQ_ROWS = (16, 64, 2048)
# --stationary: the 8-CTA layout's widths (up to u=256), the 16-CTA
# layout's (up to the ceiling, u=1024) and two past it.
STATIONARY_WIDTHS = (129, 192, 256, 257, 300, 384, 512, 768, 1023, 1024,
                     1025, 1280)
TOL = {"avg": 1e-5, "avg_bf16": 2e-2, "seq": 1e-5}
BF16_TOL = 2e-2
_AVG_HEAD = ("const void *codes, int batch, int steps, const void *kernel, "
             "const void *bias, const void *recurrent, int units, int bb, "
             "void *avg, void *hidden")
_AVG_ARGS = ("codes, batch, steps, kernel, bias, recurrent, units, bb, avg, "
             "hidden")
# What each kernel's entry point passes through to its launcher.
_SPECS = {
    "avg": {"source": "rnn_avg.cu",
            "template": ("AvgKernel", "AvgClusterKernel"),
            "head": _AVG_HEAD, "args": _AVG_ARGS,
            "launch": ("LaunchTile<{0}, {1}, {2}>",
                       "LaunchClusterTile<{0}, {1}, {2}, {3}>")},
    "avg_bf16": {"source": "rnn_avg.cu", "template": "MmaAvgKernel",
                 "head": _AVG_HEAD, "args": _AVG_ARGS,
                 "launch": "LaunchMma<{0}, {1}, {2}, {3}>"},
    "seq": {"source": "rnn_seq.cu", "template": "SeqKernel",
            "head": "const void *x, int batch, int steps, int channels, "
                    "const void *kernel, const void *bias, "
                    "const void *recurrent, int units, int bb, void *seq, "
                    "void *last",
            "args": "x, batch, steps, channels, kernel, bias, recurrent, "
                    "units, bb, seq, last",
            "launch": "LaunchTile<{0}, {1}, {2}, {3}, {4}>"},
}


def templates(kind: str) -> tuple:
    """The kernel templates of ``kind``: the register tile's, then (for
    ``avg``) the cluster tile's, whose variants have one more field."""
    names = _SPECS[kind]["template"]
    return names if isinstance(names, tuple) else (names,)


def launch_of(kind: str, variant) -> str:
    """The launcher of ``variant`` (a format string of its fields)."""
    launch = _SPECS[kind]["launch"]
    if isinstance(launch, str):
        return launch
    return launch[len(variant) - len(VARIANTS[0])]


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
        + launch_of(kind, variant).format(*(str(v).lower() for v in variant))
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
    lib.dg_sweep.argtypes = ([i, p, i, i, i, p, p, p, i, i, p, p, p]
                             if kind == "seq" else
                             [i, p, i, i, p, p, p, i, i, p, p, p])
    lib.dg_sweep.restype = i
    lib.dg_error_string.argtypes = [i]
    lib.dg_error_string.restype = ctypes.c_char_p
    log = (_build.BUILD_DIR / f"{name}.log").read_text()
    return lib, registers(log, kind)


def registers(log: str, kind: str) -> dict:
    """Registers and spill bytes of each variant of the kernel of ``kind``,
    from ``ptxas -v``: keyed by the variant's tuple of ints."""
    from chip_smoke import ptxas_usage

    return {tuple(int(v) for v in args.split(", ")): usage
            for template in templates(kind)
            for args, usage in ptxas_usage(log, template).items()}


def usage_of(regs: dict, variant) -> dict:
    return regs.get(tuple(int(v) for v in variant), {})


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


def avg_rows(torch, lib, regs, min_units: int, bf16: bool = False):
    from deepgrp_tpu_torch.models import rnn

    inputs = {}
    dtype = torch.bfloat16 if bf16 else torch.float32
    variants = BF16_VARIANTS if bf16 else VARIANTS
    for gates, batch, steps, units, bb, variant in (BF16_CASES if bf16
                                                    else CASES):
        if units < min_units:
            continue
        shape = (gates, batch, steps, units)
        if shape not in inputs:
            gen = torch.Generator().manual_seed(sum(shape))
            params = gru_weights(torch, gen, gates, 5, units)
            codes = torch.randint(0, 6, (batch, steps), generator=gen,
                                  dtype=torch.int8).cuda()
            plain = rnn.lstm_avg_plain if gates == 4 else rnn.gru_avg_plain
            inputs[shape] = (params, codes, plain(params, codes, dtype))
        params, codes, want = inputs[shape]
        avg = torch.empty(batch, steps, units, device="cuda", dtype=dtype)
        hidden = torch.empty(batch, units, device="cuda", dtype=dtype)
        index = variants.index(variant)

        def launch():
            return lib.dg_sweep(
                index, codes.data_ptr(), batch, steps,
                params["kernel"].data_ptr(), params["bias"].data_ptr(),
                params["recurrent"].data_ptr(), units, bb, avg.data_ptr(),
                hidden.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

        if bf16:
            cluster = variant[3]
            layout = {"tile": "cluster" if cluster > 1 else "mma",
                      "k_tiles": variant[1], "cluster": cluster,
                      "u_in": ("shared" if variant[2] else "registers"
                               if cluster == 1 else "L1/L2")}
        elif len(variant) == 4:  # the float32 cluster tile
            cluster = variant[2]
            layout = {"tile": "cluster", "windows_a_group": variant[1],
                      "cluster": cluster,
                      "u_in": "shared" if variant[3] else "L1/L2"}
        else:
            cluster = 1
            layout = {"tile": "registers" if variant[2] else "l2",
                      "windows_a_group": variant[1],
                      "u_in": "registers" if variant[2] else "L1/L2"}
        yield ({"gates": gates, "batch": batch, "steps": steps,
                "units": units, "windows_a_cta": bb, **layout,
                "ctas": -(-batch // bb) * cluster,
                **usage_of(regs, variant)},
               launch, (avg, hidden), want)


def seq_rows(torch, lib, regs, min_units: int):
    from deepgrp_tpu_torch.models import rnn

    inputs = {}
    for batch, steps, units, bb, variant in SEQ_CASES:
        if units < min_units:
            continue
        dtype = torch.bfloat16 if variant[2] else torch.float32
        shape = (batch, steps, units, dtype)
        if shape not in inputs:
            gen = torch.Generator().manual_seed(batch + steps + units)
            params = {k: v.to(dtype) if k != "bias" else v
                      for k, v in gru_weights(torch, gen, 3, 5,
                                              units).items()}
            x = torch.rand(batch, steps, 5, generator=gen).cuda().to(dtype)
            inputs[shape] = (params, x, rnn.gru_apply(params, x))
        params, x, want = inputs[shape]
        seq = torch.empty(batch, steps, units, device="cuda", dtype=dtype)
        last = torch.empty(batch, units, device="cuda", dtype=dtype)
        index = SEQ_VARIANTS.index(variant)

        def launch():
            return lib.dg_sweep(
                index, x.data_ptr(), batch, steps, 5,
                params["kernel"].data_ptr(), params["bias"].data_ptr(),
                params["recurrent"].data_ptr(), units, bb, seq.data_ptr(),
                last.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

        u_in = ("registers" if variant[1] else "shared" if variant[4]
                else "L1/L2")
        yield ({"rows": batch, "steps": steps, "units": units,
                "dtype": str(dtype).split(".")[-1], "rows_a_cta": bb,
                "rows_a_group": variant[0], "u_in": u_in,
                "cluster": variant[3], "ctas": -(-batch // bb) * variant[3],
                **usage_of(regs, variant)},
               launch, (seq, last), want)


def max_err(got, want, chunk: int = 256) -> float:
    """Largest absolute difference of two output tuples, a few rows at a
    time (the widest cases hold tens of GB)."""
    return max((g[i:i + chunk].float() - w[i:i + chunk].float())
               .abs_().max().item()
               for g, w in zip(got, want) for i in range(0, g.shape[0],
                                                         chunk))


def adaptive_ms(torch, launch) -> float:
    """CUDA-event ms of ``launch`` (warm): one launch, then, where it took
    under a second, the mean over up to 20 more (about a second's
    worth)."""
    import chip_smoke

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    if first >= 1000.0:
        return first
    return chip_smoke.cuda_ms(torch, launch,
                              max(1, min(20, int(1000.0 / max(first, 1e-3)))))


# dg_sweep_mma: the bf16 grid step (RunMma) at the caller's unit block,
# appended to a copy of csrc/rnn_grid.cu (its templates are in the file's
# anonymous namespace); dg_avg_grid's and dg_seq_grid's arguments.
_MMA_ENTRY = """
extern "C" int dg_sweep_mma(int units_a_cta, int gates, int seq,
                            const void *in, int batch, int steps,
                            int channels, const void *kernel,
                            const void *bias, const void *recurrent,
                            int units, void *h0, void *h1, void *carry,
                            void *out, void *last, void *stream) {
  GridArgs a{};
  if (seq) {
    a.x = in;
  } else {
    a.codes = static_cast<const int8_t *>(in);
  }
  a.kernel = kernel;
  a.bias = static_cast<const float *>(bias);
  a.recurrent = recurrent;
  a.carry = static_cast<float *>(carry);
  a.out = out;
  a.last = last;
  a.batch = batch;
  a.steps = steps;
  a.channels = channels;
  a.units = units;
  const long long rows = seq ? batch : 2LL * batch;
  switch (units_a_cta * 100 + gates * 10 + seq) {
    case 1630: return RunMma<3, false, 16>(a, rows, h0, h1, stream);
    case 1640: return RunMma<4, false, 16>(a, rows, h0, h1, stream);
    case 1631: return RunMma<3, true, 16>(a, rows, h0, h1, stream);
    case 3230: return RunMma<3, false, 32>(a, rows, h0, h1, stream);
    case 3240: return RunMma<4, false, 32>(a, rows, h0, h1, stream);
    case 3231: return RunMma<3, true, 32>(a, rows, h0, h1, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def mma_library():
    """Builds the copy of ``csrc/rnn_grid.cu`` with ``dg_sweep_mma``."""
    from deepgrp_tpu_torch import _build

    src_dir = _build.BUILD_DIR / "sweep"
    src_dir.mkdir(parents=True, exist_ok=True)
    src = src_dir / "grid_mma_sweep.cu"
    with open(os.path.join(CSRC, "rnn_grid.cu")) as fh:
        src.write_text(fh.read() + _MMA_ENTRY)
    path = _build.build_shared_library(
        "grid_mma_sweep", [_build.nvcc()], [src],
        (*_build.NVCC_FLAGS, "-I", CSRC))
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_sweep_mma.argtypes = [i, i, i, p, i, i, i, p, p, p, i] + [p] * 6
    lib.dg_sweep_mma.restype = i
    lib.dg_grid_shape.argtypes = [i, i, p]
    lib.dg_grid_shape.restype = i
    lib.dg_error_string.argtypes = [i]
    lib.dg_error_string.restype = ctypes.c_char_p
    return lib


def mma_run(torch, lib, units_a_cta: int, kind: str, params, inputs):
    """The bf16 grid step of row ``kind`` at ``units_a_cta`` units a CTA,
    with the wrapper's buffers made as ``cuda_rnn`` makes them; returns
    the outputs."""
    from deepgrp_tpu_torch.models import cuda_rnn

    batch, steps = inputs.shape[:2]
    units = params["recurrent"].shape[0]
    seq = kind == "seq"
    gates = 4 if kind == "lstm" else 3
    dtype = torch.bfloat16
    kernel = params["kernel"].to(dtype) if seq else params["kernel"]
    recurrent, h, carry = cuda_rnn._grid_buffers(
        lib, batch if seq else 2 * batch, units, gates, params["recurrent"],
        dtype)
    out = torch.empty(batch, steps, units, device="cuda", dtype=dtype)
    last = torch.empty(batch, units, device="cuda", dtype=dtype)
    err = lib.dg_sweep_mma(
        units_a_cta, gates, int(seq), inputs.data_ptr(), batch, steps,
        inputs.shape[2] if seq else 0, kernel.data_ptr(),
        params["bias"].data_ptr(), recurrent.data_ptr(), units,
        h[0].data_ptr(), h[1].data_ptr(), carry.data_ptr(), out.data_ptr(),
        last.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"dg_sweep_mma: {lib.dg_error_string(err)}")
    return out, last


def grid_sweep(torch, widths, card: str, out_path, only=None,
               mma_units=()) -> list:
    """``--grid``: the routed launch and the grid tile's, checked and
    timed, at each width, row, dtype and batch (``only``: of the rows
    named there; ``mma_units``: the bf16 step at those unit blocks too);
    one row each."""
    mma_lib = mma_library() if mma_units else None
    cases = [(kind, dtype) for kind in ("gru", "lstm", "seq")
             for dtype in (torch.float32, torch.bfloat16)]
    rows, failed = [], []
    for units in widths:
        for kind, dtype in cases:
            shapes = ([(rows_, 342) for rows_ in GRID_SEQ_ROWS]
                      if kind == "seq" else GRID_BATCHES)
            for batch, steps in shapes:
                bf16 = dtype == torch.bfloat16
                row = {"row": {"seq": "7", "lstm": "2"}.get(kind, "1")
                       + ("b" if bf16 else ""),
                       "kind": kind, "dtype": str(dtype).split(".")[-1],
                       "batch": batch, "steps": steps, "units": units}
                if only and row["row"] not in only:
                    continue
                try:
                    grid_case(torch, kind, dtype, row,
                              (mma_lib, mma_units) if bf16 else None)
                except RuntimeError as err:  # a launch refused, or memory
                    row["error"] = str(err)
                tol = BF16_TOL if bf16 else TOL["avg"]
                errs = [v for k, v in row.items() if k.endswith("_err")]
                if "error" in row or not all(e <= tol for e in errs):
                    failed.append(row)
                row["card"] = card
                rows.append(row)
                print(json.dumps(row), flush=True)
                if out_path:
                    with open(out_path, "a") as fh:
                        fh.write(json.dumps(row) + "\n")
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{len(failed)} cases differ from the plain "
                             f"version: {failed}")
    return rows


def grid_case(torch, kind: str, dtype, row: dict, mma=None) -> None:
    """One case of :func:`grid_sweep`, its results written into ``row``:
    weights and inputs made on the card from a seed, the plain version's
    outputs, then the routed launch and the grid tile's (and with ``mma``,
    ``(library, unit blocks)``, the bf16 step at each), each checked and
    timed, then cuDNN and the bound."""
    import chip_smoke
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    batch, steps, units = row["batch"], row["steps"], row["units"]
    gates = 4 if kind == "lstm" else 3
    gen = torch.Generator(device="cuda").manual_seed(units + batch + steps
                                                     + gates)
    width = gates * units
    params = {
        "kernel": torch.randn(5, width, generator=gen, device="cuda") * 0.5,
        "recurrent": torch.randn(units, width, generator=gen,
                                 device="cuda") / units ** 0.5,
        "bias": torch.randn(*((2, width) if gates == 3 else (width,)),
                            generator=gen, device="cuda") * 0.3}
    if kind == "seq":
        inputs = torch.rand(batch, steps, 5, generator=gen,
                            device="cuda").to(dtype)
        want = rnn.gru_apply(params, inputs)
        row["routed_tile"] = ("grid" if cuda_rnn._grid_route(units, "seq",
                                                             dtype)
                              else "cluster")

        def run(grid):
            return cuda_rnn._launch_seq(params, inputs, grid)
    else:
        inputs = torch.randint(0, 6, (batch, steps), generator=gen,
                               device="cuda", dtype=torch.int8)
        want = getattr(rnn, f"{kind}_avg_plain")(params, inputs, dtype)
        row["routed_tile"] = cuda_rnn.avg_tile_name(kind, units, dtype)

        def run(grid):
            return cuda_rnn._launch(f"{kind}_avg", gates, params, inputs,
                                    dtype, grid)
    torch.cuda.synchronize()
    routes = (("routed", False),) + ((("grid", True),)
                                     if row["routed_tile"] != "grid" else ())
    for key, grid in routes:
        got = run(grid)
        torch.cuda.synchronize()
        row[f"{key}_err"] = max_err(got, want)
        del got
        row[f"{key}_ms"] = adaptive_ms(torch, lambda: run(grid))
    if row["routed_tile"] == "grid":
        row["grid_err"], row["grid_ms"] = row["routed_err"], row["routed_ms"]
    row["grid_over_routed"] = row["grid_ms"] / row["routed_ms"]
    for units_a_cta in (mma[1] if mma else ()):
        def forced():
            return mma_run(torch, mma[0], units_a_cta, kind, params, inputs)

        got = forced()
        torch.cuda.synchronize()
        row[f"mma_{units_a_cta}_err"] = max_err(got, want)
        del got
        row[f"mma_{units_a_cta}_ms"] = adaptive_ms(torch, forced)
    del want
    row["library_ms"] = adaptive_ms(torch, chip_smoke.grid_library(
        torch, kind, gates, dtype, params, inputs))
    row.update(chip_smoke.grid_bound(torch, kind, gates, dtype, params,
                                     inputs))


def parent_library(root: str):
    """The parent checkout's ``csrc/rnn_avg.cu`` at ``root``, built as a
    library of its own (its entry points as this checkout's, the
    stationary ones aside)."""
    from deepgrp_tpu_torch import _build

    src = os.path.join(root, "deepgrp_tpu_torch", "csrc", "rnn_avg.cu")
    path = _build.build_shared_library("rnn_avg_parent", [_build.nvcc()],
                                       [src], _build.NVCC_FLAGS)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("dg_gru_avg", "dg_lstm_avg"):
        fn = getattr(lib, name)
        fn.argtypes = [p, i, i, p, p, p, i, i, p, p, p]
        fn.restype = i
    lib.dg_avg_layout.argtypes = [i, i, i, p]
    lib.dg_avg_layout.restype = i
    lib.dg_avg_clusters.argtypes = [i] * 4
    lib.dg_avg_clusters.restype = i
    lib.dg_error_string.argtypes = [i]
    lib.dg_error_string.restype = ctypes.c_char_p
    return lib


def parent_launch(torch, lib, kind: str, params, codes):
    """The parent's routed float32 launch of row ``kind`` (its register or
    cluster tile at the windows a CTA its ``avg_tile`` chose), or None past
    its cluster tile's ceiling (where its route was the grid tile)."""
    from deepgrp_tpu_torch.models import cuda_rnn

    gates = 4 if kind == "lstm" else 3
    batch, steps = codes.shape
    units = params["recurrent"].shape[0]
    out = (ctypes.c_int * 2)()
    cap = lib.dg_avg_layout(gates, units, 0, out)
    if cap == 0:
        return None
    slots = torch.cuda.get_device_properties(0).multi_processor_count
    if out[0] > 1:
        slots = lib.dg_avg_clusters(gates, units, cap, 0) or slots // out[0]
    windows = cuda_rnn.block_windows(batch, slots, cap)

    def launch():
        avg = torch.empty(batch, steps, units, device="cuda")
        hidden = torch.empty(batch, units, device="cuda")
        err = getattr(lib, f"dg_{kind}_avg")(
            codes.data_ptr(), batch, steps, params["kernel"].data_ptr(),
            params["bias"].data_ptr(), params["recurrent"].data_ptr(), units,
            windows, avg.data_ptr(), hidden.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"parent {kind}_avg: "
                               f"{lib.dg_error_string(err).decode()}")
        return avg, hidden

    return launch


def stationary_sweep(torch, widths, card: str, out_path, parent_root: str,
                     only=None, variants: bool = False) -> list:
    """``--stationary``: at each width, row and batch, the stationary
    tile, the parent's route and the grid tile checked and timed (see the
    module's note); one row each."""
    import chip_smoke
    from deepgrp_tpu_torch.models import cuda_rnn, rnn

    plib = parent_library(parent_root)
    rows, failed = [], []
    for units in widths:
        for kind in ("gru", "lstm"):
            row_name = "2" if kind == "lstm" else "1"
            if only and row_name not in only:
                continue
            gates = 4 if kind == "lstm" else 3
            for batch, steps in GRID_BATCHES:
                row = {"row": row_name, "kind": kind, "batch": batch,
                       "steps": steps, "units": units,
                       "routed_tile": cuda_rnn.avg_tile_name(kind, units)}
                try:
                    params, codes = chip_smoke.random_rnn_on_card(
                        torch, units + batch + steps + gates, gates, batch,
                        steps, units)
                    want = getattr(rnn, f"{kind}_avg_plain")(params, codes)
                    row["stationary"] = cuda_rnn.stationary_layout(
                        kind, batch, units)

                    def stationary():
                        return cuda_rnn._launch(f"{kind}_avg", gates, params,
                                                codes, stationary=True)

                    def grid():
                        return cuda_rnn._launch(f"{kind}_avg", gates, params,
                                                codes, grid=True)

                    parent = parent_launch(torch, plib, kind, params, codes)
                    if parent is None:
                        parent = grid
                        row["parent_tile"] = "grid"
                    else:
                        row["parent_tile"] = "parent"
                    got = stationary()
                    torch.cuda.synchronize()
                    row["stationary_err"] = max_err(got, want)
                    base = parent()
                    torch.cuda.synchronize()
                    row["parent_err"] = max_err(base, want)
                    row["bits_parent"] = all(torch.equal(a, b)
                                             for a, b in zip(got, base))
                    del got, base
                    turns = [adaptive_ms(torch, fn) for fn in
                             (parent, stationary, stationary, parent)]
                    row["parent_ms"] = (turns[0] + turns[3]) / 2
                    row["stationary_ms"] = (turns[1] + turns[2]) / 2
                    if variants:
                        stationary_variants(torch, row, stationary, kind,
                                            gates, params, codes)
                    got = grid()
                    torch.cuda.synchronize()
                    row["grid_err"] = max_err(got, want)
                    del got, want
                    row["grid_ms"] = adaptive_ms(torch, grid)
                    routed = {"stationary": "stationary_ms",
                              "grid": "grid_ms"}.get(row["routed_tile"],
                                                     "parent_ms")
                    row["routed_over_parent"] = (row[routed]
                                                 / row["parent_ms"])
                    row["library_ms"] = adaptive_ms(
                        torch, chip_smoke.grid_library(
                            torch, kind, gates, torch.float32, params,
                            codes))
                    row.update(chip_smoke.grid_bound(
                        torch, kind, gates, torch.float32, params, codes))
                    del params, codes
                except (RuntimeError, ValueError) as err:
                    row["error"] = str(err)
                errs = [v for k, v in row.items() if k.endswith("_err")]
                if ("error" in row or not all(e <= TOL["avg"] for e in errs)
                        or (row.get("parent_tile") == "parent"
                            and not row["bits_parent"])
                        or not row.get("variants_same_bits", True)):
                    failed.append(row)
                row["card"] = card
                rows.append(row)
                print(json.dumps(row), flush=True)
                if out_path:
                    with open(out_path, "a") as fh:
                        fh.write(json.dumps(row) + "\n")
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{len(failed)} cases failed: {failed}")
    return rows


def stationary_variants(torch, row: dict, stationary, kind: str,
                        gates: int, params, codes) -> None:
    """``--variants``: each variant of the stationary tile forced, timed
    and held against the library's choice bit for bit, into ``row``."""
    from deepgrp_tpu_torch.models import cuda_rnn

    want = stationary()
    same = True
    for variant in range(3):
        def forced(variant=variant):
            return cuda_rnn._launch(f"{kind}_avg", gates, params, codes,
                                    stationary=True, variant=variant)

        try:
            got = forced()
        except ValueError:  # the variant does not fit the shared memory
            row[f"variant_{variant}_ms"] = None
            continue
        torch.cuda.synchronize()
        same = same and all(torch.equal(g, w) for g, w in zip(got, want))
        del got
        row[f"variant_{variant}_ms"] = adaptive_ms(torch, forced)
    row["variants_same_bits"] = same


def summary(path: str) -> None:
    """``--summary``: each width's largest ratio of each tile to the
    fastest over its lines' cells and batches, and the routed tile's to
    the parent's route."""
    by_width = {}
    with open(path) as fh:
        for line in fh:
            row = json.loads(line)
            if "stationary_ms" in row:
                by_width.setdefault(row["units"], []).append(row)
    for units, rows in sorted(by_width.items()):
        worst = {}
        for row in rows:
            best = min(row["parent_ms"], row["stationary_ms"],
                       row["grid_ms"])
            for tile in ("parent", "stationary", "grid"):
                worst[tile] = max(worst.get(tile, 0.0),
                                  row[f"{tile}_ms"] / best)
            worst["routed/parent"] = max(worst.get("routed/parent", 0.0),
                                         row["routed_over_parent"])
        print(json.dumps({"units": units, "routed": rows[0]["routed_tile"],
                          **{k: round(v, 3) for k, v in worst.items()}}))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(_SPECS), default="avg")
    parser.add_argument("--min-units", type=int, default=0,
                        help="run only the cases of at least this width")
    parser.add_argument("--grid", action="store_true",
                        help="time the grid tile beside the routed launch")
    parser.add_argument("--units", help="--grid: widths, comma-separated")
    parser.add_argument("--rows", help="--grid: rows, comma-separated")
    parser.add_argument("--mma-units",
                        help="--grid: the bf16 step's unit blocks to time "
                             "(16, 32), comma-separated")
    parser.add_argument("--stationary", action="store_true",
                        help="time the float32 stationary tile beside the "
                             "parent's route (--parent) and the grid tile")
    parser.add_argument("--parent", help="--stationary: the parent "
                        "checkout's root")
    parser.add_argument("--summary", help="print the routes' ratios of a "
                        "--stationary JSON-lines file")
    parser.add_argument("--variants", action="store_true",
                        help="--stationary: time each variant too")
    parser.add_argument("--out", help="JSON file for the rows")
    args = parser.parse_args()
    if args.summary:
        summary(args.summary)
        return 0
    if not torch.cuda.is_available():
        print("avg_tile_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.stationary:
        if not args.parent:
            parser.error("--stationary needs --parent DIR")
        widths = (tuple(int(u) for u in args.units.split(","))
                  if args.units else STATIONARY_WIDTHS)
        stationary_sweep(torch, widths, card, args.out, args.parent,
                         args.rows.split(",") if args.rows else None,
                         args.variants)
        return 0
    if args.grid:
        widths = (tuple(int(u) for u in args.units.split(","))
                  if args.units else GRID_WIDTHS)
        grid_sweep(torch, widths, card, args.out,
                   args.rows.split(",") if args.rows else None,
                   tuple(int(n) for n in args.mma_units.split(","))
                   if args.mma_units else ())
        return 0
    variants = {"avg": VARIANTS, "avg_bf16": BF16_VARIANTS,
                "seq": SEQ_VARIANTS}[args.kernel]
    lib, regs = build(args.kernel, variants)
    for variant, info in sorted(regs.items(), key=lambda kv: (len(kv[0]),
                                                             kv[0])):
        template = templates(args.kernel)[len(variant) - len(variants[0])]
        print(f"{template}<{', '.join(map(str, variant))}>: {info}",
              flush=True)

    rows = []
    cases = {"avg": avg_rows,
             "avg_bf16": lambda *a: avg_rows(*a, bf16=True),
             "seq": seq_rows}[args.kernel]
    failed = []
    for row, launch, outs, want in cases(torch, lib, regs, args.min_units):
        err = launch()
        if err:
            # A variant the card refuses at this shape (too much shared
            # memory, a cluster it cannot place) is a row, not the end.
            row["refused"] = lib.dg_error_string(err).decode()
            rows.append(row)
            print(json.dumps(row), flush=True)
            continue
        torch.cuda.synchronize()
        row["max_abs_err"] = max((o.float() - w.float()).abs().max().item()
                                 for o, w in zip(outs, want))
        row["ms"] = time_ms(torch, launch)
        rows.append(row)
        print(json.dumps(row), flush=True)
        tol = BF16_TOL if row.get("dtype") == "bfloat16" else TOL[args.kernel]
        if not row["max_abs_err"] <= tol:
            failed.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernel": args.kernel, "rows": rows},
                      fh, indent=1)
    if failed:
        raise AssertionError(f"{len(failed)} variants differ from the plain "
                             f"version: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
