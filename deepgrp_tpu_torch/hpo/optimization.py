"""HPO objective and the serial sweep.

Counterpart of ``deepgrp_tpu/hpo/optimization.py`` (parity with the
reference DeepGRP's ``optimization.py:24-154``): ``build_and_optimize``
updates the Options from the trial dict (vecsize and units coerced to
int), trains, runs an MSS-post-processed prediction of the validation
sequence with the best weights, filters short segments, computes the
metrics and returns the hyperopt-style result dict ``{loss: -MCC | inf,
status, Metrics, options, logdir, error}``; a trial whose MCC is NaN is
failed and its logdir deleted.  ``run_a_trial`` resumes a pickled
``results.pkl`` and appends ``max_evals`` more TPE evaluations.

Training runs the fused training kernels and every evaluation the fused
inference kernels, on ``device`` (default ``cuda``; their plain versions
for ``device="cpu"``).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
from os import PathLike, path
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from deepgrp_tpu_torch.config import Options, create_logdir
from deepgrp_tpu_torch.data.preprocess import Data
from deepgrp_tpu_torch.hpo.space import Dimension
from deepgrp_tpu_torch.hpo.tpe import STATUS_FAIL, STATUS_OK, Trials, fmin
from deepgrp_tpu_torch.models.model import DeepGRPModel, ModelConfig
from deepgrp_tpu_torch.ops.segments import filter_segments
from deepgrp_tpu_torch.predict.engine import PredictionEngine
from deepgrp_tpu_torch.predict.metrics import calculate_metrics
from deepgrp_tpu_torch.predict.postprocess import (predict_complete,
                                                   predict_sequence)
from deepgrp_tpu_torch.train.sampler import codes_from_onehot_rows
from deepgrp_tpu_torch.train.training import MetricsWriter, training

_LOGGER = logging.getLogger(__name__)

Device = Union[str, torch.device]


def record_trial_summary(logdir: PathLike, hparams: Dict[str, Any],
                         mcc: float) -> None:
    """Keep a trial's hyperparameters and final MCC in its logdir
    (``optimization.py:38-59``; the reference writes a TensorBoard hparams
    record and a final MCC scalar a trial, its ``optimization.py:54,
    82-88``): ``hparams.json`` holds the searched assignment, and the MCC
    goes to ``metrics.jsonl`` and the TensorBoard events as ``hpo/MCC``."""
    os.makedirs(os.fspath(logdir), exist_ok=True)
    serializable = {
        key: (value.item() if isinstance(value, np.generic) else value)
        for key, value in hparams.items()
    }
    with open(path.join(os.fspath(logdir), "hparams.json"), "w") as fh:
        json.dump(serializable, fh, indent=2, sort_keys=True)
    writer = MetricsWriter(logdir, tensorboard=True)
    try:
        writer.write(step=0, metrics={"hpo/MCC": float(mcc)})
    finally:
        writer.close()


def _update_options(options: Options, dictionary: Dict[str, Any]) -> Options:
    for key, value in dictionary.items():
        options[key] = value
    options.vecsize = int(options.vecsize)
    options.units = int(options.units)
    return options


def evaluate_trained(options: Options, step_size: int, logdir: PathLike,
                     val_data: Data, params: Mapping[str, torch.Tensor],
                     compute_dtype: Optional[torch.dtype] = None,
                     rnn_kernel: str = "auto",
                     device: Device = "cuda") -> Dict[str, Any]:
    """MSS-post-processed validation metrics of trained parameters (the
    evaluation half of the reference objective, its
    ``optimization.py:58-68``; ``optimization.py:70-119``).

    The scored route: ``predict_sequence`` with the MSS (classes and max
    probability off the device, 5 B/bp), the metrics equal to those of the
    full probability matrix's ``apply_mss(...).argmax(axis=1)``.  Where the
    lengths of ``fwd`` and ``truelbl`` differ it keeps the full-matrix
    ``predict_complete`` route, as the JAX package does.
    ``compute_dtype`` (default float32) and ``rnn_kernel`` pick the
    engine's mode and route.
    """
    out_len = int(val_data.truelbl.shape[1])
    fwd = np.asarray(val_data.fwd)
    if fwd.shape[-1] != out_len:
        predictions = predict_complete(step_size, options, logdir, val_data,
                                       use_mss=True, params=params,
                                       compute_dtype=compute_dtype,
                                       rnn_kernel=rnn_kernel, device=device)
        is_not_na = np.logical_not(np.isnan(predictions[:, 0]))
        predictions_class = predictions[is_not_na].argmax(axis=1)
        filter_segments(predictions_class, options.min_mss_len)
        _, metrics = calculate_metrics(
            predictions_class, val_data.truelbl[:, is_not_na].argmax(axis=0))
        return metrics
    model = DeepGRPModel.from_params(ModelConfig.from_options(options),
                                     params, device)
    engine = PredictionEngine(model, batch_size=options.batch_size,
                              step_size=step_size,
                              compute_dtype=(torch.float32
                                             if compute_dtype is None
                                             else compute_dtype),
                              rnn_kernel=rnn_kernel)
    predictions_class = np.asarray(
        predict_sequence(engine, codes_from_onehot_rows(fwd), options),
        dtype=np.int64)
    filter_segments(predictions_class, options.min_mss_len)
    _, metrics = calculate_metrics(predictions_class,
                                   val_data.truelbl.argmax(axis=0))
    return metrics


def build_and_optimize(
        train_data: Data, val_data: Data, step_size: int, options: Options,
        options_dict: Dict[str, Union[str, float]],
        device: Device = "cuda") -> Dict[str, Any]:
    """Train and evaluate one hyperparameter assignment (the TPE
    objective, ``optimization.py:122-162``).  A trial that raises is
    marked ``STATUS_FAIL`` with its error, as in the JAX package."""
    options = _update_options(options, options_dict)
    logdir = create_logdir(options)

    def _train_test() -> Dict[str, Any]:
        best_params, _ = training((train_data, val_data), options,
                                  logdir=logdir, device=device)
        return evaluate_trained(options, step_size, logdir, val_data,
                                best_params, device=device)

    results: Dict[str, Any] = {
        "loss": np.inf,
        "Metrics": None,
        "options": options.todict(),
        "logdir": None,
        "status": STATUS_FAIL,
        "error": "",
    }
    try:
        metrics = _train_test()
    except Exception as err:  # pylint: disable=broad-except
        _LOGGER.exception("trial raised; marking it failed")
        results["error"] = str(err)
        results["status"] = STATUS_FAIL
    else:
        results["logdir"] = logdir
        results["loss"] = -1 * metrics["MCC"]
        results["status"] = STATUS_OK
        results["Metrics"] = metrics
        if np.isnan(results["loss"]):
            results["status"] = STATUS_FAIL
            results["loss"] = np.inf
        else:
            record_trial_summary(logdir, options_dict, metrics["MCC"])
    if results["status"] == STATUS_FAIL and results["logdir"]:
        shutil.rmtree(results["logdir"], ignore_errors=True)
    return results


def _load_trials(results_path: str) -> Trials:
    if not path.exists(results_path):
        _LOGGER.info("no pickled sweep state at %s; starting a fresh one",
                     results_path)
        return Trials()
    with open(results_path, "rb") as file:
        trials = pickle.load(file)
    _LOGGER.info("resuming sweep: %d completed trials loaded from %s",
                 len(trials.trials), results_path)
    return trials


def run_a_trial(space: Dict[str, Dimension],
                objective: Callable[[Dict[str, Any]], Dict[str, Any]],
                project_root_dir: PathLike, max_evals: int,
                seed: Optional[int] = None) -> int:
    """One TPE increment with ``results.pkl`` resume
    (``optimization.py:177-193``; the reference sweep's incremental
    checkpointing, its ``optimization.py:109-154``): adds ``max_evals``
    evaluations to the pickled trials and returns the total count."""
    results_path = path.join(project_root_dir, "results.pkl")
    trials = _load_trials(results_path)
    target_evals = len(trials.trials) + max_evals
    fmin(objective, space, trials, target_evals, seed=seed)
    with open(results_path, "wb") as file:
        pickle.dump(trials, file)
    return len(trials.losses())
