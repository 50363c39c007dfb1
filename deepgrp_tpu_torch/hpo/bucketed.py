"""Shape-bucketed parallel TPE sweep over the whole reference search space.

Counterpart of ``deepgrp_tpu/hpo/bucketed.py``.  The published search
space (``space.reference_search_space``) sweeps two architecture
dimensions, ``qnormal vecsize(200,20,2)`` and ``qnormal units(34,5,2)``,
beside five continuous ones.  Architecture dimensions change shapes, so
they cannot share a fleet; instead each sweep round proposes a batch of
TPE candidates, groups them by their shape bucket, and trains each group
as one fleet with :func:`deepgrp_tpu_torch.hpo.vmapped.run_parallel_trials`.
The bucket key is the tuple that fixes the shapes:

  * ``int(vecsize)`` and ``int(units)`` (the reference's int coercion,
    its ``optimization.py:24-29``), and
  * ``one_class_size = int(batch * repeat_probability / n_repeats)``:
    ``repeat_probability`` enters the sampler only through this integer
    (``train/sampler.py``), so trials whose probabilities give the same
    integer train together exactly.

After training, each trial is evaluated with the MSS-post-processed MCC
objective and recorded in the same pickled ``Trials`` store the serial
sweep (``run_a_trial``) uses: resume, the trial logdir's ``hparams.json``
and ``metrics.jsonl`` and the result dict's schema are the serial sweep's.
"""

from __future__ import annotations

import logging
import pickle
from os import PathLike, path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

import torch

from deepgrp_tpu_torch.config import Options, create_logdir
from deepgrp_tpu_torch.data.preprocess import Data
from deepgrp_tpu_torch.hpo.optimization import (_load_trials,
                                                _update_options,
                                                evaluate_trained,
                                                record_trial_summary)
from deepgrp_tpu_torch.hpo.space import Dimension
from deepgrp_tpu_torch.hpo.tpe import (STATUS_FAIL, STATUS_OK, Trials,
                                       suggest)
from deepgrp_tpu_torch.hpo.vmapped import VARYING_KEYS, run_parallel_trials

_LOGGER = logging.getLogger(__name__)

ShapeKey = Tuple[int, int, int]
Device = Union[str, torch.device]


def shape_bucket_key(options: Options, trial: Dict[str, Any]) -> ShapeKey:
    """The (vecsize, units, one_class_size) tuple fixing the shapes."""
    vecsize = int(trial.get("vecsize", options.vecsize))
    units = int(trial.get("units", options.units))
    repeat_probability = float(
        trial.get("repeat_probability", options.repeat_probability))
    n_repeats = max(len(options.repeats_to_search), 1)
    one_class_size = int(
        int(options.batch_size) * repeat_probability / n_repeats)
    return vecsize, units, one_class_size


def _group_by_bucket(options: Options, proposals: List[Dict[str, Any]]
                     ) -> Dict[ShapeKey, List[int]]:
    groups: Dict[ShapeKey, List[int]] = {}
    for idx, trial in enumerate(proposals):
        groups.setdefault(shape_bucket_key(options, trial), []).append(idx)
    return groups


def _evaluate_bucket(base_options: Options, proposals: List[Dict[str, Any]],
                     train_data: Data, val_data: Data, step_size: int,
                     seed: int, device: Device = "cuda"
                     ) -> List[Dict[str, Any]]:
    """Train one shape bucket's trials as one fleet; return result dicts
    in the schema of ``build_and_optimize``."""
    # The bucket's shape assignment (the same for all its trials after the
    # int/one_class_size bucketing above).
    bucket_options = _update_options(
        Options(**base_options.todict()), proposals[0])
    varying = [{k: t[k] for k in VARYING_KEYS if k in t} for t in proposals]
    outcomes = run_parallel_trials(bucket_options, varying, train_data,
                                   val_data, seed=seed, device=device)
    results = []
    for trial, outcome in zip(proposals, outcomes):
        options = _update_options(Options(**base_options.todict()), trial)
        logdir = create_logdir(options)
        result: Dict[str, Any] = {
            "loss": np.inf, "Metrics": None, "options": options.todict(),
            "logdir": None, "status": STATUS_FAIL, "error": "",
        }
        try:
            metrics = evaluate_trained(options, step_size, logdir, val_data,
                                       outcome["params"], device=device)
        except Exception as err:  # pylint: disable=broad-except
            _LOGGER.exception("bucketed trial evaluation raised")
            result["error"] = str(err)
        else:
            loss = -1 * metrics["MCC"]
            if np.isnan(loss):
                result["loss"] = np.inf
            else:
                result.update(loss=loss, status=STATUS_OK, Metrics=metrics,
                              logdir=logdir)
                record_trial_summary(logdir, trial, metrics["MCC"])
        results.append(result)
    return results


def run_bucketed_sweep(space: Dict[str, Dimension], base_options: Options,
                       train_data: Data, val_data: Data, step_size: int,
                       project_root_dir: PathLike, max_evals: int,
                       batch_evals: int = 8,
                       seed: Optional[int] = None,
                       device: Device = "cuda") -> Trials:
    """TPE sweep evaluating up to ``batch_evals`` proposals a round, each
    shape bucket as one fleet (``bucketed.py:108-149``).

    Resumes from / checkpoints to ``results.pkl`` after every round, like
    the serial sweep (``run_a_trial``).  Returns the ``Trials`` store.
    """
    results_path = path.join(project_root_dir, "results.pkl")
    trials = _load_trials(results_path)
    target = len(trials.trials) + max_evals
    rng = np.random.default_rng(seed)
    round_idx = 0
    while len(trials) < target:
        n_propose = min(batch_evals, target - len(trials))
        proposals = [suggest(space, trials, rng) for _ in range(n_propose)]
        groups = _group_by_bucket(base_options, proposals)
        _LOGGER.info("round %d: %d proposals in %d shape buckets %s",
                     round_idx, n_propose, len(groups), sorted(groups))
        for key, indices in sorted(groups.items()):
            bucket = [proposals[i] for i in indices]
            try:
                results = _evaluate_bucket(
                    base_options, bucket, train_data, val_data, step_size,
                    seed=int(rng.integers(1 << 31)), device=device)
            except Exception as err:  # pylint: disable=broad-except
                _LOGGER.exception("bucket %s failed; marking its trials",
                                  key)
                results = [{
                    "loss": np.inf, "Metrics": None, "logdir": None,
                    "options": None, "status": STATUS_FAIL,
                    "error": str(err),
                } for _ in bucket]
            for trial, result in zip(bucket, results):
                trials.record(trial, result)
        with open(results_path, "wb") as file:
            pickle.dump(trials, file)
        round_idx += 1
    return trials
