#!/usr/bin/env python3
"""Times the training kernels (rows 3-6: ``train_fwd`` and ``train_bwd`` of
``deepgrp_tpu_torch/models/cuda_rnn.py``) of one checkout at a list of
shapes, as one JSON line; run it on two checkouts in turns (parent,
change, change, parent) to compare them on one card.

Usage, on a machine with one CUDA card::

    python3 tools/train_turns.py [--root DIR] [--label NAME]
        [--shapes 256x342x60,256x342x512,64x342x1024] [--reps 20]
        [--sass [--sass-dir DIR] [--libs rnn_train,rnn_avg,rnn_seq]]
        [--split] [--out FILE.jsonl]
    python3 tools/train_turns.py --summary FILE.jsonl [--sass-dir DIR]

``--root`` is the checkout whose package is imported and built (by
default the one this script is in).  Each case: random weights and codes
from a seed, dropout masks at rate 0.0928, output cotangents; each time
is CUDA events over ``--reps`` launches after a warm-up.  The line holds
the label, the card's name and power limit and the ms of each
``{cell} {fwd|bwd} BxTxU``.  ``--split`` adds, for each, the device ms
of one backward recurrence (``cuda_rnn._bwd_recurrence``) by kernel
(``torch.profiler``; the name up to its template arguments), so the grid
tile's recompute (A) and step (B) stand apart.  ``--sass`` adds a hash of the SASS of each
kernel of the built libraries (``--libs``, by default ``rnn_train``;
``cuobjdump -sass``), by its mangled name
with the anonymous namespace's tag (a hash of the source file) dropped
and with the listing's spacing collapsed, so the same machine code of two
checkouts has the same hash; with ``--sass-dir DIR`` each kernel's SASS
is also written to ``DIR/<label>/<name>.sass``.  ``--summary`` prints,
for each label after the first in the file, every time's ratio to the
first label's (means over each label's lines), which of the kernels
both built have the same SASS (from the written files when ``--sass-dir``
is given), and for each kernel built only by the later label the first
label's kernels, built only there, whose SASS it has (a renamed kernel).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SHAPES = "256x342x60,256x342x128,256x342x256,256x342x512,64x342x1024"


def cuda_ms(torch, fn, reps: int) -> float:
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


def case(torch, gen, gates: int, batch: int, steps: int, units: int):
    width = gates * units
    params = {"kernel": torch.randn(5, width, generator=gen) * 0.5,
              "recurrent": torch.randn(units, width, generator=gen)
              / units ** 0.5,
              "bias": torch.randn(*((2, width) if gates == 3 else (width,)),
                                  generator=gen) * 0.3}
    codes = torch.randint(0, 6, (batch, steps), generator=gen,
                          dtype=torch.int8)
    keep = 1.0 - 0.0928
    masks = torch.bernoulli(torch.full((gates, 2 * batch, 5), keep),
                            generator=gen) / keep
    d_avg = torch.randn(batch, steps, units, generator=gen)
    d_hid = torch.randn(batch, units, generator=gen)
    return ({k: v.cuda() for k, v in params.items()}, codes.cuda(),
            masks.cuda(), d_avg.cuda(), d_hid.cuda())


# The anonymous namespace's tag in a mangled name: it hashes the source
# file, so it differs between two checkouts of the same code.
_NAMESPACE = re.compile(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def _normal(line: str) -> str:
    return " ".join(_NAMESPACE.sub("", line).split())


def _digest(lines) -> str:
    return hashlib.md5("\n".join(_normal(l) for l in lines).encode()
                       ).hexdigest()


def sass_hashes(lib_path: str, dump: str = None) -> dict:
    """The md5 of each kernel's SASS, by its mangled name (both without
    the namespace tag and the listing's spacing); with ``dump``, each
    kernel's SASS is written to ``dump/<name>.sass``."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    bodies, name = {}, None
    for line in text.splitlines():
        match = re.search(r"Function : (\S+)", line)
        if match:
            name = match.group(1)
            bodies[name] = []
        elif name is not None:
            bodies[name].append(line.strip())
    if dump:
        os.makedirs(dump, exist_ok=True)
        for name, body in bodies.items():
            with open(os.path.join(dump, f"{name[:200]}.sass"), "w") as fh:
                fh.write("\n".join(body) + "\n")
    return {_NAMESPACE.sub("", name): _digest(body)
            for name, body in bodies.items()}


def dumped_hashes(directory: str) -> dict:
    """sass_hashes of the files written to ``directory``."""
    out = {}
    for entry in sorted(os.listdir(directory)):
        with open(os.path.join(directory, entry)) as fh:
            out[_NAMESPACE.sub("", entry[:-len(".sass")])] = _digest(
                fh.read().splitlines())
    return out


def run(args) -> dict:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from deepgrp_tpu_torch import _build
    from deepgrp_tpu_torch.models import cuda_rnn

    if not os.path.abspath(cuda_rnn.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {cuda_rnn.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    row = {"label": args.label, "root": root, "card": card, "ms": {}}
    gen = torch.Generator().manual_seed(2025)
    for cell, gates in (("gru", 3), ("lstm", 4)):
        for shape in args.shapes.split(","):
            batch, steps, units = (int(v) for v in shape.split("x"))
            params, codes, masks, d_avg, d_hid = case(torch, gen, gates,
                                                      batch, steps, units)
            out = cuda_rnn.train_fwd(cell, params, codes, masks)
            seqs = tuple(out[2:])
            row["ms"][f"{cell} fwd {shape}"] = cuda_ms(
                torch, lambda: cuda_rnn.train_fwd(cell, params, codes,
                                                  masks), args.reps)
            row["ms"][f"{cell} bwd {shape}"] = cuda_ms(
                torch, lambda: cuda_rnn.train_bwd(cell, params, codes, masks,
                                                  seqs, d_avg, d_hid),
                args.reps)
            if args.split:
                row.setdefault("split", {})[f"{cell} {shape}"] = (
                    kernel_ms(torch, lambda: cuda_rnn._bwd_recurrence(
                        cell, params, codes, masks, seqs, d_avg, d_hid)))
            del params, codes, masks, d_avg, d_hid, out, seqs
            torch.cuda.empty_cache()
    if args.sass:
        row["sass"] = {}
        for name in args.libs.split(","):
            row["sass"].update(sass_hashes(
                _build.load_kernels(name)._name,
                args.sass_dir and os.path.join(args.sass_dir, args.label)))
    return row


def kernel_ms(torch, fn) -> dict:
    """Device ms of one call of ``fn`` (warm) by kernel, the name up to its
    template arguments (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None)
        if total is None:
            total = event.cuda_time_total
        name = re.sub(r"^void\s+", "", event.key).replace(
            "(anonymous namespace)::", "")
        name = re.split(r"[<(]", name)[0].split("::")[-1]
        if total > 0:
            out[name] += total / 1e3
    return dict(out)


def summary(path: str, sass_dir: str = None) -> None:
    with open(path) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    by_label = defaultdict(list)
    for row in rows:
        by_label[row["label"]].append(row)
    labels = list(by_label)
    base = labels[0]

    def mean(label, key):
        values = [r["ms"][key] for r in by_label[label] if key in r["ms"]]
        return sum(values) / len(values)

    print(f"card: {rows[0]['card']}; {len(rows)} runs: "
          f"{[r['label'] for r in rows]}")
    for label in labels[1:]:
        worst = 0.0
        for key in by_label[base][0]["ms"]:
            ratio = mean(label, key) / mean(base, key)
            worst = max(worst, ratio)
            runs = [round(r["ms"][key], 4) for r in rows]
            print(f"{key}: {label} / {base} = {ratio:.4f} (runs in order "
                  f"{runs})")
        print(f"largest ratio {label} / {base}: {worst:.4f}")
        for key in by_label[base][0].get("split", {}):
            for name in by_label[base][0]["split"][key]:
                values = [[r["split"][key].get(name, 0.0)
                           for r in by_label[lab]] for lab in (base, label)]
                if all(values[0]) and all(values[1]):
                    ratio = ((sum(values[1]) / len(values[1]))
                             / (sum(values[0]) / len(values[0])))
                    print(f"{key} {name}: {label} / {base} = {ratio:.4f} "
                          f"(ms {[round(v, 4) for v in values[0]]} -> "
                          f"{[round(v, 4) for v in values[1]]})")
        if sass_dir:
            sass = [dumped_hashes(os.path.join(sass_dir, name))
                    for name in (base, label)]
        else:
            sass = [r.get("sass") for r in (by_label[base][0],
                                            by_label[label][0])]
        if all(sass):
            common = sorted(set(sass[0]) & set(sass[1]))
            same = [k for k in common if sass[0][k] == sass[1][k]]
            print(f"SASS of the {len(common)} kernels both built: "
                  f"{len(same)} identical; differ: "
                  f"{sorted(set(common) - set(same))}; only in {label}: "
                  f"{sorted(set(sass[1]) - set(sass[0]))}")
            # A kernel renamed (a template parameter dropped) keeps its
            # machine code if its SASS is that of a kernel only in the base.
            by_hash = defaultdict(list)
            for name in set(sass[0]) - set(sass[1]):
                by_hash[sass[0][name]].append(name)
            for name in sorted(set(sass[1]) - set(sass[0])):
                print(f"  {name}: same SASS as {base}'s "
                      f"{by_hash.get(sass[1][name], 'none')}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--label", default="change")
    parser.add_argument("--shapes", default=DEFAULT_SHAPES)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--split", action="store_true")
    parser.add_argument("--sass-dir")
    parser.add_argument("--libs", default="rnn_train")
    parser.add_argument("--out")
    parser.add_argument("--summary")
    args = parser.parse_args()
    if args.summary:
        summary(args.summary, args.sass_dir)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("train_turns: no CUDA card", file=sys.stderr)
        return 1
    row = run(args)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
