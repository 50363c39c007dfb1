"""Prediction post-processing: MSS labelling and softmax.

Counterpart of ``deepgrp_tpu/predict/postprocess.py`` (parity with the
reference DeepGRP's ``prediction.py:40-65,114-141`` and
``__main__.py:46-83``): ``predict_sequence`` on its host-MSS route and its
``use_mss=False`` route (``predict -m``), the full-matrix ``apply_mss`` and
``softmax``, and ``predict_complete``, which restores a model and predicts
a whole validation sequence.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import numpy as np
import torch

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.data.preprocess import Data
from deepgrp_tpu_torch.models.convert import params_from_jax
from deepgrp_tpu_torch.models.model import DeepGRPModel, ModelConfig
from deepgrp_tpu_torch.ops import mss
from deepgrp_tpu_torch.predict.engine import (PredictionEngine,
                                              mss_score_transform)
from deepgrp_tpu_torch.train.checkpoint import latest_checkpoint_params
from deepgrp_tpu_torch.train.sampler import codes_from_onehot_rows


def apply_mss(probs: np.ndarray, options: Options) -> np.ndarray:
    """MSS labels of merged probabilities ``[L, C]``, one-hot float64
    ``[L, C]`` (``apply_mss``, ``postprocess.py:20-37``; the reference's
    ``prediction.py:40-59``): the score of a position is the clamped logit
    of its max probability, ``-10 t`` on background and ``+t`` on repeat
    positions, then Ruzzo–Tompa with majority-vote labelling."""
    nof_labels = probs.shape[1]
    results_classes = probs.argmax(axis=1)
    mins = probs.max(axis=1) + 1e-6
    mins = np.where(mins > 0.99, 0.99, mins)
    t_scores = np.log(mins / (1 - mins))
    scores = np.where(results_classes > 0, t_scores,
                      -10 * t_scores).astype(float)
    return mss.find_mss_labels(scores, results_classes.astype(np.int64),
                               nof_labels, options.min_mss_len,
                               options.xdrop_len)


def softmax(array: np.ndarray) -> np.ndarray:
    """The reference's softmax (``prediction.py:62-65``), kept as it is:
    the global maximum, not each row's, is subtracted."""
    e_x = np.exp(array - np.max(array))
    return e_x / e_x.sum(axis=1, keepdims=True)


def predict_sequence(engine: PredictionEngine, codes: np.ndarray,
                     options: Options, threads: int = 0,
                     use_mss: bool = True) -> np.ndarray:
    """Code track ``int8 [L]`` -> per-position class ``[L]``.

    With ``use_mss`` (the default) the engine scores every position on the
    device (argmax class and max probability) and the host applies the
    reference score transform and the Ruzzo–Tompa labelling.  A sequence
    with no window (``L <= vecsize``) scores as all-zero probabilities,
    which the transform gives a positive background score, so the whole
    record is labelled class 1: the reference applies the MSS to its
    all-zero buffer (``prediction.py:51-57``), and this keeps that quirk.
    ``threads`` bounds the MSS workers (0 = auto); the output does not
    depend on it.

    Without it (``predict -m``, ``postprocess.py:404-406``) the class is
    the argmax of :func:`softmax` over the merged probabilities
    (``engine.predict``); a position no window covers is class 0.
    """
    if not use_mss:
        return softmax(engine.predict(codes)).argmax(axis=1)
    classes, maxp = engine.predict_scored(codes)
    scores = mss_score_transform(classes, maxp).astype(np.float64)
    return mss.find_mss_classes(scores, classes.astype(np.int64),
                                engine.model.config.n_classes,
                                options.min_mss_len, options.xdrop_len,
                                threads=threads)


def setup_prediction_from_options_checkpoint(
        options: Options, logdir: os.PathLike,
        device: Union[str, torch.device] = "cuda") -> DeepGRPModel:
    """The model of ``options`` holding the latest checkpoint's weights in
    ``logdir`` (``postprocess.py:409-420``; the reference's
    ``prediction.py:68-86``), on ``device``.  Raises if there is none."""
    params = params_from_jax(latest_checkpoint_params(logdir))
    return DeepGRPModel.from_params(ModelConfig.from_options(options),
                                    params, device)


def predict_complete(step_size: int, options: Options, logdir: os.PathLike,
                     data: Data, use_mss: bool = False,
                     params: Optional[Mapping[str, torch.Tensor]] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     rnn_kernel: str = "auto",
                     device: Union[str, torch.device] = "cuda"
                     ) -> np.ndarray:
    """Predict a whole sequence with a restored model
    (``postprocess.py:423-454``; the reference's ``prediction.py:114-141``).

    ``params`` (flat, as :func:`~deepgrp_tpu_torch.train.training.training`
    returns them) give the weights, else the latest checkpoint in
    ``logdir`` does.  ``data.fwd`` is the one-hot sequence ``[5, L]``
    (all-zero columns become the pad code).  Returns the one-hot MSS labels
    with ``use_mss``, else the softmaxed probabilities, shaped
    ``[truelbl length, n_classes]``.  ``compute_dtype`` (default float32)
    and ``rnn_kernel`` pick the engine's mode and route.
    """
    if params is None:
        model = setup_prediction_from_options_checkpoint(options, logdir,
                                                         device)
    else:
        model = DeepGRPModel.from_params(ModelConfig.from_options(options),
                                         params, device)
    engine = PredictionEngine(model, batch_size=options.batch_size,
                              step_size=step_size,
                              compute_dtype=(torch.float32
                                             if compute_dtype is None
                                             else compute_dtype),
                              rnn_kernel=rnn_kernel)
    codes = codes_from_onehot_rows(np.asarray(data.fwd))
    predictions = engine.predict(codes, out_len=data.truelbl.shape[1])
    if use_mss:
        return apply_mss(predictions, options)
    return softmax(predictions)
