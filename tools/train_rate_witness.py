#!/usr/bin/env python3
"""Trains both cells at one width through the training kernels and
through their plain versions, at several RMSprop learning rates, on a CUDA
card: whether an epoch loss that rises at a rate rises with the plain
versions too (a fault of the kernels would show as the two routes
parting).

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 tools/train_rate_witness.py [--units 1024] [--batch 256]
        [--rates 1e-3,1e-4,1e-5] [--epochs 2] [--steps 5] [--out FILE.json]

Data: ``chip_smoke.py``'s synthetic chromosomes (phase 7's seed); the
options: ``gru_att`` (vecsize 342, attention, dropout 0.0928) and the
LSTM of the flagship, at ``--units`` and ``--batch``.  Each run is an eager
``Trainer.fit`` from seed 0, as ``chip_smoke.py`` phase 19's
``fit_pair`` runs it: once through the kernels (``train_fwd`` /
``train_bwd`` launched every step) and once with the training recurrence
swapped for its plain versions (none launched).  Before the runs, one
step of each cell at each rate from the fit's initial parameters prints
RMSprop's first move of ``U``: the median of |dU| / rate (about
1 / sqrt(1 - rho) = 3.16 for an entry whose squared gradient is well
above epsilon) and the largest row sum of |dU|, the most a unit's
recurrent preactivation can move for |h| <= 1.  Prints each
run's epoch losses and seconds, and the card's name and power limit;
writes the rows to ``--out`` as JSON, if given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_move(torch, options, train_data, cell: str,
               device: str = "cuda") -> dict:
    """RMSprop's first step of ``U`` from the fit's initial parameters
    (seed 0), on a batch and masks drawn as the fit's first step draws
    them."""
    from deepgrp_tpu_torch.models import rnn
    from deepgrp_tpu_torch.models.model import (DeepGRPModel, ModelConfig,
                                                init_params)
    from deepgrp_tpu_torch.train.optimizers import get_optimizer
    from deepgrp_tpu_torch.train.sampler import BatchSampler
    from deepgrp_tpu_torch.train.training import train_step

    config = ModelConfig.from_options(options)
    model = DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(0)),
        device)
    sampler = BatchSampler(options, train_data, model.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    codes, labels = sampler.batch(gen)
    masks = rnn.input_dropout_masks(gen, 2 * sampler.batch_size,
                                    config.dropout, config.gates)
    before = model.params()["rnn.recurrent"].detach().clone()
    train_step(model, get_optimizer(options, model.parameters()), codes,
               labels, masks)
    step = (model.params()["rnn.recurrent"].detach() - before).abs()
    rate = options.learning_rate
    return {"cell": cell, "rate": rate,
            "median_move_over_rate": (step.median() / rate).item(),
            "largest_row_sum": step.sum(dim=1).max().item()}


def fit(torch, chip_smoke, options, train_data, val_data, tmp: str,
        label: str, plain: bool) -> dict:
    """An eager ``Trainer.fit`` from seed 0: epoch losses, seconds and the
    training kernels' launches."""
    from deepgrp_tpu_torch.models import cuda_rnn
    from deepgrp_tpu_torch.models.model import DeepGRPModel, ModelConfig
    from deepgrp_tpu_torch.train.training import Trainer

    model = DeepGRPModel(ModelConfig.from_options(options))
    trainer = Trainer(model, options, os.path.join(tmp, label),
                      tensorboard=False, rnn_kernel="fused", capture=False)
    chip_smoke.reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    try:
        if plain:
            with chip_smoke.plain_training(torch):
                _, history = trainer.fit(train_data, val_data, seed=0)
        else:
            _, history = trainer.fit(train_data, val_data, seed=0)
    finally:
        trainer.writer.close()
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_rnn.LAUNCHES.snapshot().items()
                if "train" in k and v}
    return {"loss": history["loss"], "val_loss": history["val_loss"],
            "seconds": time.perf_counter() - start, "launches": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--units", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--rates", default="1e-3,1e-4,1e-5")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_rate_witness: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from deepgrp_tpu_torch.config import Options

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"card: {card}", flush=True)
    cells = (("gru_att", chip_smoke.FLAGSHIP, "gru"),
             ("lstm", {**chip_smoke.FLAGSHIP, "attention": False,
                       "rnn": "LSTM"}, "lstm"))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        train_npz, val_npz, bed = chip_smoke.write_training_files(np, tmp)
        for rate in (float(r) for r in args.rates.split(",")):
            for label, opts, cell in cells:
                options = Options(**{**opts, "units": args.units},
                                  learning_rate=rate,
                                  n_epochs=args.epochs,
                                  n_batches=args.steps,
                                  batch_size=args.batch)
                train_data = chip_smoke.load_training_data(
                    np, train_npz, bed, options)
                val_data = chip_smoke.load_training_data(
                    np, val_npz, bed, options)
                row = {"label": label, "units": args.units,
                       "batch": args.batch,
                       **first_move(torch, options, train_data, cell)}
                for route in ("kernels", "plain"):
                    row[route] = fit(torch, chip_smoke, options, train_data,
                                     val_data, tmp,
                                     f"{label}_{rate:g}_{route}",
                                     route == "plain")
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
