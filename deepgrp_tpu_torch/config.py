"""Run configuration: the fields of ``Options`` that prediction reads.

Counterpart of ``deepgrp_tpu/config.py`` (``Options``, itself a copy of the
reference DeepGRP's ``Options``), cut to what ``predict`` needs, with the
same names and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Options:
    """Prediction options (names and defaults as in the JAX package).

    Attributes:
        vecsize: window length; ``predict`` takes it from the model file.
        batch_size: windows per chunk of the prediction scan.
        min_mss_len: minimal segment length of the MSS labelling.
        xdrop_len: X-drop length of the MSS labelling (<= 0 disables it).
    """

    vecsize: int = 150
    batch_size: int = 256
    min_mss_len: int = 50
    xdrop_len: int = 50
