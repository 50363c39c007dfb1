"""Prediction post-processing: MSS labelling of a scored sequence.

Counterpart of ``predict_sequence`` in ``deepgrp_tpu/predict/postprocess.py``
on its host-MSS route (parity with the reference DeepGRP's
``prediction.py:40-59`` and ``__main__.py:46-83``).
"""

from __future__ import annotations

import numpy as np

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.ops import mss
from deepgrp_tpu_torch.predict.engine import (PredictionEngine,
                                              mss_score_transform)


def predict_sequence(engine: PredictionEngine, codes: np.ndarray,
                     options: Options, threads: int = 0) -> np.ndarray:
    """Code track ``int8 [L]`` -> per-position class ``int32 [L]``.

    The engine scores every position on the device (argmax class and max
    probability); the host applies the reference score transform and the
    Ruzzo–Tompa labelling.  A sequence with no window (``L <= vecsize``)
    scores as all-zero probabilities, which the transform gives a positive
    background score, so the whole record is labelled class 1: the
    reference applies the MSS to its all-zero buffer
    (``prediction.py:51-57``), and this keeps that quirk.

    ``threads`` bounds the MSS workers (0 = auto); the output does not
    depend on it.
    """
    classes, maxp = engine.predict_scored(codes)
    scores = mss_score_transform(classes, maxp).astype(np.float64)
    return mss.find_mss_classes(scores, classes.astype(np.int64),
                                engine.model.config.n_classes,
                                options.min_mss_len, options.xdrop_len,
                                threads=threads)
