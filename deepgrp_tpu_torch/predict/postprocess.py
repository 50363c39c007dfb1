"""Prediction post-processing: MSS labelling and softmax.

Counterpart of ``deepgrp_tpu/predict/postprocess.py`` (parity with the
reference DeepGRP's ``prediction.py:40-65,114-141`` and
``__main__.py:46-83``): ``predict_sequence`` with its three MSS routes
(the streaming host MSS, the MSS on the track's device and the whole-array
host MSS; on the sharded engine routing by sparsity) and its
``use_mss=False`` route (``predict -m``), the full-matrix ``apply_mss`` and
``softmax``, and ``predict_complete``, which restores a model and predicts
a whole validation sequence.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.data.preprocess import Data
from deepgrp_tpu_torch.models.convert import params_from_jax
from deepgrp_tpu_torch.models.model import DeepGRPModel, ModelConfig
from deepgrp_tpu_torch.ops import mss, mss_device
from deepgrp_tpu_torch.predict.engine import (PredictionEngine,
                                              ScoredReadings,
                                              mss_score_transform)
from deepgrp_tpu_torch.train.checkpoint import latest_checkpoint_params
from deepgrp_tpu_torch.train.sampler import codes_from_onehot_rows

_LOG = logging.getLogger(__name__)


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


def apply_mss_scored(classes: np.ndarray, maxp: np.ndarray,
                     options: Options, nof_labels: int) -> np.ndarray:
    """:func:`apply_mss` from the engine's scored track, ``(argmax class,
    max probability)`` on the host, one-hot float64 ``[L, C]``
    (``apply_mss_scored``, ``postprocess.py:40-53``): the transform reads
    only the row maxima in float32, so nothing is lost."""
    scores = mss_score_transform(classes, maxp).astype(np.float64)
    return mss.find_mss_labels(scores, classes.astype(np.int64), nof_labels,
                               options.min_mss_len, options.xdrop_len)


def _pad_uncovered(classes: torch.Tensor, maxp: torch.Tensor,
                   out_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions past the track that no window covers, as zero-probability
    rows: the reference scores them (``prediction.py:90`` zeros, ``:51-57``:
    a positive background score), so they take part in the MSS."""
    pad = out_len - classes.shape[0]
    if pad <= 0:
        return classes, maxp
    return (torch.cat([classes, classes.new_zeros(pad)]),
            torch.cat([maxp, maxp.new_zeros(pad)]))


scored_run_count = mss_device.scored_run_count


def apply_mss_on_device(classes: torch.Tensor, maxp: torch.Tensor,
                        options: Options, nof_labels: int, out_len: int,
                        runs: Optional[int] = None) -> np.ndarray:
    """The whole MSS where the scored track lies (``apply_mss_on_device``,
    ``postprocess.py:56-94``): the transform, the run collapse, the stack
    scan (``dg_mss_stack`` on a CUDA track) and the labelling run there,
    and only the ``uint8`` classes ``[out_len]`` come back.  The run
    capacity is sized from ``runs`` (counted on the device if not given),
    and doubled until it holds every run."""
    classes, maxp = _pad_uncovered(classes, maxp, out_len)
    if runs is None:
        runs = scored_run_count(classes, maxp, out_len)
    max_runs = mss_device.run_capacity(runs)
    while True:
        assigned, overflow = mss_device.mss_classes_from_scored(
            classes, maxp, out_len, nof_labels, options.min_mss_len,
            options.xdrop_len, max_runs=max_runs)
        if not bool(overflow):
            return assigned[:out_len].to(torch.uint8).cpu().numpy()
        max_runs *= 2


#: The sharded engine's ``auto`` route takes the MSS on the track's device
#: for a track with at most this many positive runs (a trained model's
#: track: 0.1-4 % runs a position), the host MSS for a noisier one
#: (``postprocess.py:274`` of the JAX package).
DEVICE_MSS_AUTO_MAX_RUNS = 16384

DEVICE_MSS_ROUTES = ("auto", "on", "off")


def predict_sequence(engine: ScoredReadings, codes: np.ndarray,
                     options: Options, threads: int = 0,
                     use_mss: bool = True,
                     device_mss: Union[str, bool] = "auto") -> np.ndarray:
    """Code track ``int8 [L]`` -> per-position class ``[L]``.

    With ``use_mss`` (the default) the engine scores every position (argmax
    class and max probability) and the reference score transform and
    Ruzzo–Tompa labelling follow on one of three routes, chosen by
    ``device_mss`` (``postprocess.py:296-406``); every route gives the same
    classes:

    * ``"auto"``: on the single engine the streaming host MSS
      (:meth:`~deepgrp_tpu_torch.predict.engine.ScoredTrack.
      host_mss_classes`), overlapped with the chunk loop; on the sharded
      engine, routing by sparsity: a track of at most
      :data:`DEVICE_MSS_AUTO_MAX_RUNS` positive runs takes the MSS on its
      device (:func:`apply_mss_on_device`, its capacity sized from the
      count), a noisier one the host MSS;
    * ``"on"`` (or True): the whole MSS where the track lies
      (:func:`apply_mss_on_device`);
    * ``"off"`` (or False): the whole-array host MSS after the whole track
      has come to the host.

    An engine whose track cannot stay on a device (the sharded engine
    across processes: ``device_route_ok()`` is False) takes the host MSS
    on every route.  A sequence with no window (``L <= vecsize``) scores as
    all-zero probabilities, which the transform gives a positive background
    score, so the whole record is labelled class 1: the reference applies
    the MSS to its all-zero buffer (``prediction.py:51-57``), and every
    route keeps that quirk.  ``threads`` bounds the host MSS's workers (0 =
    auto); the output does not depend on it.

    Without ``use_mss`` (``predict -m``, ``postprocess.py:404-406``) the
    class is the argmax of :func:`softmax` over the merged probabilities
    (``engine.predict``); a position no window covers is class 0.  An
    empty track (an empty or all-N record) gives no class, as on the MSS
    routes; the JAX package's (and the reference's) softmax raises on it.
    """
    if not use_mss:
        if codes.shape[0] == 0:
            return np.zeros(0, np.int64)
        return softmax(engine.predict(codes)).argmax(axis=1)
    route = {True: "on", False: "off"}.get(device_mss, device_mss)
    if route not in DEVICE_MSS_ROUTES:
        raise ValueError(f"device_mss must be one of {DEVICE_MSS_ROUTES} "
                         f"(or a bool), got {device_mss!r}")
    nof_labels = engine.model.config.n_classes
    out_len = int(codes.shape[0])
    if route != "off" and not engine.device_route_ok():
        _LOG.info("device_mss=%r: the track is gathered on the host in a "
                  "run of several processes; using the host MSS", route)
        route = "off"

    def host_mss() -> np.ndarray:
        # The whole-array route, and the zero-window quirk of the others.
        classes, scores = engine.predict_mss_scores(codes)
        return mss.find_mss_classes(scores.astype(np.float64),
                                    classes.astype(np.int64), nof_labels,
                                    options.min_mss_len, options.xdrop_len,
                                    threads=threads)

    if route == "off":
        return host_mss()
    if route == "on":
        classes_d, maxp_d, _ = engine.predict_scored_device(codes)
        if classes_d is None:
            return host_mss()
        return apply_mss_on_device(classes_d, maxp_d, options, nof_labels,
                                   out_len)
    track = engine.scored_tracks(codes)
    if track is None:
        return host_mss()
    if engine.routes_by_sparsity():
        runs = track.count_runs()
        if runs <= DEVICE_MSS_AUTO_MAX_RUNS:
            return apply_mss_on_device(*track.device(), options, nof_labels,
                                       out_len, runs=runs)
    return track.host_mss_classes(options, nof_labels, threads)


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
