#!/usr/bin/env python3
"""Hyperparameter sweep (DeepGRP.ipynb equivalent).

Runs the published DeepGRP TPE search space with ``results.pkl``
save/resume every ``--save-step`` trials, exactly like the reference
notebook workflow (the counterpart of ``examples/hpo_sweep.py`` of the JAX
package).  With ``--parallel N`` the same space (the qnormal
vecsize/units dimensions included) is swept N proposals a round, grouped
by shape bucket, each bucket trained as one fleet whose step runs as one
captured CUDA graph on the card (``hpo/bucketed.py``).  ``--compare``
also times an equal serial sweep and prints the ratio.  ``--space quick``
varies only learning_rate and dropout (the base architecture stays; fast
smoke sweeps), in the serial and the parallel sweep alike.  ``--seed``
makes the proposals repeatable (the serial sweep's save step ``k`` draws
from ``seed + k``; default: fresh entropy, as the JAX example, and 0 for
the parallel sweep).

Trials train and evaluate on ``--device`` (default ``cuda``: the kernels;
with no GPU the script raises; ``--device cpu`` runs their plain
versions).

Usage:
    python -m deepgrp_tpu_torch.examples.hpo_sweep \\
        chr11.fa.gz.npz chr20.fa.gz.npz annotations.bed --trials 100 \\
        --save-step 3 --root sweep/
"""

import argparse
import functools
import os
import sys
import time
from typing import Dict, List, Optional

if not __package__:
    # Run as a script path: import the package from this checkout.
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.data.preprocess import load_chromosome
from deepgrp_tpu_torch.hpo import build_and_optimize, run_a_trial
from deepgrp_tpu_torch.hpo.bucketed import run_bucketed_sweep
from deepgrp_tpu_torch.hpo.space import (Dimension, lognormal,
                                         reference_search_space, uniform)
from deepgrp_tpu_torch.models.model import resolve_device


def search_space(name: str) -> Dict[str, Dimension]:
    """``reference``: the published space; ``quick``: learning rate and
    dropout only."""
    if name == "quick":
        return {"learning_rate": lognormal("learning_rate", -5, 1.0),
                "dropout": uniform("dropout", 0, 0.3)}
    return reference_search_space()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("trainfile")
    parser.add_argument("validfile")
    parser.add_argument("bedfile")
    parser.add_argument("--trials", type=int, default=100)
    parser.add_argument("--save-step", type=int, default=3)
    parser.add_argument("--root", default="sweep")
    parser.add_argument("--step-size", type=int, default=50)
    parser.add_argument("--parallel", type=int, default=0,
                        help="TPE proposals per round, trained as one "
                        "fleet a shape bucket (0 = serial TPE)")
    parser.add_argument("--compare", action="store_true",
                        help="with --parallel: also time an equal serial "
                        "sweep and print the speedup")
    parser.add_argument("--config", default=None,
                        help="TOML base config (default: reference defaults)")
    parser.add_argument("--space", choices=["reference", "quick"],
                        default="reference",
                        help="'quick' varies only learning_rate/dropout "
                        "(keeps the base architecture; fast smoke sweeps)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device to train and evaluate on")
    parser.add_argument("--seed", type=int, default=None,
                        help="TPE seed (default: fresh entropy; the "
                        "parallel sweep's 0)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.config:
        with open(args.config) as f:
            options = Options.from_toml(f)
        options.project_root_dir = args.root
    else:
        options = Options(project_root_dir=args.root)
    train_data = load_chromosome(args.trainfile, args.bedfile,
                                 options.repeats_to_search)
    val_data = load_chromosome(args.validfile, args.bedfile,
                               options.repeats_to_search)
    os.makedirs(args.root, exist_ok=True)
    objective = functools.partial(build_and_optimize, train_data, val_data,
                                  args.step_size, options, device=device)

    if args.parallel:
        start = time.perf_counter()
        trials = run_bucketed_sweep(search_space(args.space), options,
                                    train_data, val_data, args.step_size,
                                    args.root, max_evals=args.trials,
                                    batch_evals=args.parallel,
                                    seed=args.seed or 0, device=device)
        parallel_s = time.perf_counter() - start
        best = trials.best_trial()
        print(f"bucketed sweep: {len(trials)} trials in {parallel_s:.1f}s; "
              f"best loss {best['result']['loss'] if best else 'n/a'}",
              flush=True)
        if args.compare:
            serial_root = os.path.join(args.root, "serial_baseline")
            os.makedirs(serial_root, exist_ok=True)
            start = time.perf_counter()
            run_a_trial(search_space(args.space), objective, serial_root,
                        args.trials, seed=args.seed or 0)
            serial_s = time.perf_counter() - start
            print(f"serial sweep: {args.trials} trials in {serial_s:.1f}s "
                  f"-> bucketed speedup {serial_s / parallel_s:.2f}x",
                  flush=True)
        return

    space = search_space(args.space)
    done = step = 0
    while done < args.trials:
        # save/resume every save_step trials (notebook workflow)
        seed = None if args.seed is None else args.seed + step
        done = run_a_trial(space, objective, args.root,
                           min(args.save_step, args.trials - done), seed=seed)
        step += 1
        print(f"{done} trials complete", flush=True)


if __name__ == "__main__":
    main()
