"""Evaluation metrics (confusion matrix, per-class rates, multiclass MCC).

A numpy copy of ``deepgrp_tpu/predict/metrics.py`` (parity with the
reference DeepGRP's ``prediction.py:144-239``; the confusion matrix is
vectorized with ``np.add.at`` instead of a python loop).  The bfloat16
quality contract measures the fast mode with it.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

MetricDict = Dict[str, Union[np.ndarray, float]]


def calculate_multiclass_matthews_cc(cnf_matrix: np.ndarray) -> float:
    """R_K correlation coefficient (multiclass MCC) from a confusion matrix."""
    t_sum = cnf_matrix.sum(axis=1, dtype=float)
    p_sum = cnf_matrix.sum(axis=0, dtype=float)
    n_correct = np.trace(cnf_matrix, dtype=float)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples**2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples**2 - np.dot(t_sum, t_sum)
    return cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp)


def _calculate_metrics(cnf_matrix: np.ndarray) -> MetricDict:
    true_positive = np.diag(cnf_matrix).astype(float)
    false_positive = (cnf_matrix.sum(axis=0) - true_positive).astype(float)
    false_negative = (cnf_matrix.sum(axis=1) - true_positive).astype(float)
    true_negative = (cnf_matrix.sum() -
                     (false_positive + false_negative +
                      true_positive)).astype(float)
    metrics: MetricDict = {}
    metrics["TPR"] = true_positive / (true_positive + false_negative)
    metrics["TNR"] = true_negative / (true_negative + false_positive)
    metrics["PPV"] = true_positive / (true_positive + false_positive)
    metrics["NPV"] = true_negative / (true_negative + false_negative)
    metrics["FPR"] = false_positive / (false_positive + true_negative)
    metrics["FNR"] = false_negative / (true_positive + false_negative)
    metrics["FDR"] = false_positive / (true_positive + false_positive)
    metrics["ACC"] = (true_positive + true_negative) / (
        true_positive + false_positive + false_negative + true_negative)
    metrics["F1"] = (2 * metrics["TPR"] * metrics["PPV"] /
                     (metrics["TPR"] + metrics["PPV"]))
    metrics["MCC"] = calculate_multiclass_matthews_cc(cnf_matrix)
    return metrics


def confusion_matrix(truelbl: np.ndarray,
                     predictedlbl: np.ndarray) -> np.ndarray:
    """Confusion matrix over integer label arrays (prediction.py:200-218).

    Class count spans min..max over both arrays, like the reference.
    """
    assert truelbl.size == predictedlbl.size
    low = min(truelbl.min(), predictedlbl.min())
    n_classes = int(max(truelbl.max(), predictedlbl.max()) - low + 1)
    cnf = np.zeros((n_classes, n_classes), dtype=int)
    np.add.at(cnf, (truelbl - low, predictedlbl - low), 1)
    return cnf


def calculate_metrics(
        predictions_class: np.ndarray,
        true_class: np.ndarray) -> Tuple[np.ndarray, MetricDict]:
    """Confusion matrix + metric dict incl. TotalACC (prediction.py:221-239)."""
    overall_acc = (true_class == predictions_class).sum() / true_class.shape[0]
    cnf_matrix = confusion_matrix(true_class, predictions_class)
    metrics = _calculate_metrics(cnf_matrix)
    metrics["TotalACC"] = overall_acc
    return cnf_matrix, metrics
