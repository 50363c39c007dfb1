#!/usr/bin/env python3
"""N-process simulation of a multi-host run (the counterpart of
``examples/multihost_sim.py`` of the JAX package).

Proves the multi-process prediction path end to end on one machine: N
worker processes join one gloo process group through
``initialize_distributed`` on a local rendezvous (a file in a temporary
directory; a failure to join raises, nothing degrades to one process).
Rank ``r`` holds ``r + 1`` shards, so the local shard counts are uneven,
and every rank runs ``ShardedPredictionEngine.predict_scored`` on the same
sequence: each shard runs its range of window chunks, the shard
boundaries' spills are handed across processes, and every rank receives
the whole track through one gather over gloo (``parallel/predict.py``).

The launcher (no ``--worker`` flag) spawns the workers, runs the
single-process ``PredictionEngine`` itself, and exits non-zero unless every
worker's ``classes`` and ``maxp`` are bit-identical to its own.

The model is the JAX example's: ``VECSIZE`` 150, 16 units, GRU with
attention, batch 64, step 50, on a 20,000-code sequence from a numpy seed.
Its weights are drawn with numpy from a seed in the JAX package's
parameter layout and carried across with ``models/convert.py``'s
``params_from_jax``.

``--device cuda`` (the default) puts every rank's shards on ``cuda:0`` (a
machine with one card; NCCL refuses two ranks on one device, so the group
is gloo); ``--device cpu`` uses CPU shards.

Usage:
    python -m deepgrp_tpu_torch.examples.multihost_sim [--nproc 2] \\
        [--seq-len 20000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

VECSIZE = 150
UNITS = 16
STEP = 50
BATCH = 64
SEQ_LEN = 20000
#: The package's parent directory: the workers import the package from it.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if not __package__:
    # Run as a script path: import the package from this checkout.
    sys.path.insert(0, ROOT)


def build_inputs(seq_len: int = SEQ_LEN) -> np.ndarray:
    """The sequence's int8 codes (A=0..T=3, N=4) from a numpy seed."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 5, size=SEQ_LEN).astype(np.int8)[:seq_len]


def model_config():
    from deepgrp_tpu_torch.models.model import ModelConfig

    return ModelConfig(vecsize=VECSIZE, units=UNITS, rnn="GRU",
                       attention=True)


def jax_layout_params(seed: int = 3) -> Dict[str, Dict[str, np.ndarray]]:
    """Random float32 weights in the JAX package's nested layout
    (``params["rnn"]["kernel"]``, ...), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for flat, shape in model_config().param_shapes().items():
        group, name = flat.split(".")
        scale = UNITS ** -0.5 if name == "recurrent" else 0.5
        params.setdefault(group, {})[name] = rng.normal(
            0.0, scale, shape).astype(np.float32)
    return params


def build_model(device: str):
    from deepgrp_tpu_torch.models.convert import params_from_jax
    from deepgrp_tpu_torch.models.model import DeepGRPModel

    return DeepGRPModel.from_params(
        model_config(), params_from_jax(jax_layout_params()), device)


def single_process(device: str, seq_len: int = SEQ_LEN
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The single-process engine's ``(classes, maxp)``: the reference every
    rank must equal."""
    from deepgrp_tpu_torch.predict.engine import PredictionEngine

    engine = PredictionEngine(build_model(device), batch_size=BATCH,
                              step_size=STEP)
    return engine.predict_scored(build_inputs(seq_len))


def worker(rank: int, nproc: int, device: str, seq_len: int,
           outdir: str) -> None:
    import torch.distributed as dist

    from deepgrp_tpu_torch.parallel.mesh import initialize_distributed
    from deepgrp_tpu_torch.parallel.predict import ShardedPredictionEngine

    initialize_distributed(f"file://{outdir}/rendezvous", nproc, rank,
                           backend="gloo")
    try:
        engine = ShardedPredictionEngine(build_model(device),
                                         [device] * (rank + 1),
                                         batch_size=BATCH, step_size=STEP)
        expected = nproc * (nproc + 1) // 2
        if engine.n_shards != expected:
            raise RuntimeError(f"{engine.n_shards} global shards, expected "
                               f"{expected}")
        classes, maxp = engine.predict_scored(build_inputs(seq_len))
        np.savez(os.path.join(outdir, f"proc{rank}.npz"), classes=classes,
                 maxp=maxp)
    finally:
        dist.destroy_process_group()


def launcher(nproc: int, seq_len: int, device: str) -> int:
    from deepgrp_tpu_torch.models.model import resolve_device

    resolve_device(device)  # raises for cuda without a GPU
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=ROOT if not path
               else ROOT + os.pathsep + path)
    with tempfile.TemporaryDirectory() as outdir:
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "deepgrp_tpu_torch.examples."
                 "multihost_sim", "--worker", str(rank), "--nproc",
                 str(nproc), "--seq-len", str(seq_len), "--device", device,
                 "--outdir", outdir], env=env)
            for rank in range(nproc)
        ]
        try:
            want_classes, want_maxp = single_process(device, seq_len)
            rcs = [proc.wait(timeout=600) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if any(rcs):
            print(f"FAIL: worker exit codes {rcs}", flush=True)
            return 1
        for rank in range(nproc):
            with np.load(os.path.join(outdir, f"proc{rank}.npz")) as got:
                if not (np.array_equal(got["classes"], want_classes)
                        and np.array_equal(got["maxp"], want_maxp)):
                    print(f"FAIL: rank {rank}'s output differs from the "
                          "single process's", flush=True)
                    return 1
    shards = " + ".join(str(rank + 1) for rank in range(nproc))
    print(f"OK: {nproc} processes ({shards} shards on {device}), "
          "bit-identical to single-process", flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=SEQ_LEN)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--worker", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--outdir", type=str, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.nproc, args.device, args.seq_len,
               args.outdir)
        return 0
    return launcher(args.nproc, args.seq_len, args.device)


if __name__ == "__main__":
    sys.exit(main())
