#!/usr/bin/env python3
"""Repeated timed training runs + evaluation (Training.ipynb equivalent).

Trains the tuned configuration (reference defaults.toml) N times, timing
each run, exports the best model of each run, evaluates MCC on the
validation chromosome, and writes ``training_times.csv`` (the counterpart
of ``examples/train_and_evaluate.py`` of the JAX package, with the same
arguments and outputs).

Each run trains on ``--device`` (default ``cuda``: the training kernels,
the step replayed as a captured CUDA graph; with no GPU the script raises;
``--device cpu`` runs the kernels' plain versions) and evaluates the best
weights with ``predict_complete(..., use_mss=True)`` (the inference
kernel), ``filter_segments`` and ``calculate_metrics``.

Usage:
    python -m deepgrp_tpu_torch.examples.train_and_evaluate \\
        chr11.fa.gz.npz chr20.fa.gz.npz annotations.bed --runs 6 \\
        --outdir runs/
"""

import argparse
import csv
import os
import sys
import time
from typing import List, Optional

if not __package__:
    # Run as a script path: import the package from this checkout.
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.data.preprocess import load_chromosome
from deepgrp_tpu_torch.models.keras_io import save_model_npz
from deepgrp_tpu_torch.models.model import create_model, resolve_device
from deepgrp_tpu_torch.ops.segments import filter_segments
from deepgrp_tpu_torch.predict.metrics import calculate_metrics
from deepgrp_tpu_torch.predict.postprocess import predict_complete
from deepgrp_tpu_torch.train.training import training


def tuned_options() -> Options:
    """The tuned production configuration (reference defaults.toml)."""
    return Options(vecsize=342, units=60, attention=True, dropout=0.0928,
                   learning_rate=3.787e-3, momentum=0.4324, rho=0.8874,
                   repeat_probability=0.3913)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("trainfile")
    parser.add_argument("validfile")
    parser.add_argument("bedfile")
    parser.add_argument("--runs", type=int, default=6)
    parser.add_argument("--outdir", default="runs")
    parser.add_argument("--config", default=None,
                        help="TOML config (default: tuned flagship)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device to train and evaluate on")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.config:
        with open(args.config) as f:
            options = Options.from_toml(f)
    else:
        options = tuned_options()

    train_data = load_chromosome(args.trainfile, args.bedfile,
                                 options.repeats_to_search)
    val_data = load_chromosome(args.validfile, args.bedfile,
                               options.repeats_to_search)

    os.makedirs(args.outdir, exist_ok=True)
    rows = []
    for run in range(args.runs):
        logdir = os.path.join(args.outdir, f"run{run:02d}")
        model = create_model(options, device)
        t0 = time.perf_counter()
        best_params, history = training((train_data, val_data), options,
                                        model, logdir, seed=run)
        elapsed = time.perf_counter() - t0

        save_model_npz(os.path.join(args.outdir, f"model{run:02d}.npz"),
                       model.config, best_params)
        predictions = predict_complete(50, options, logdir, val_data,
                                       use_mss=True, params=best_params,
                                       device=device)
        classes = predictions.argmax(axis=1)
        filter_segments(classes, options.min_mss_len)
        _, metrics = calculate_metrics(classes,
                                       val_data.truelbl.argmax(axis=0))
        rows.append({"run": run, "seconds": elapsed,
                     "epochs": len(history["loss"]),
                     "val_loss": min(history["val_loss"]),
                     "MCC": metrics["MCC"]})
        print(rows[-1], flush=True)

    with open(os.path.join(args.outdir, "training_times.csv"), "w",
              newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


if __name__ == "__main__":
    main()
