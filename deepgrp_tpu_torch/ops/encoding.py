"""DNA sequence -> compact integer codes (host side).

Counterpart of ``encode_codes_trimmed`` and ``one_hot_encode_dna_sequence``
in ``deepgrp_tpu/ops/encoding.py`` (behavioural parity with the reference
DeepGRP's ``sequence.pyx:11-36``): ASCII bases map through a lookup table
A->0 C->1 G->2 T->3 other->4 (both cases), and leading and trailing
uppercase ``'N'`` characters are trimmed.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from deepgrp_tpu_torch import native

# 256-entry ASCII -> code lookup (bytes >= 128 also map to 4).
_LUT = np.full(256, 4, dtype=np.int8)
for _base, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
    for _ch in _base:
        _LUT[ord(_ch)] = _code


def encode_codes_trimmed(sequence: str) -> Tuple[int, np.ndarray]:
    """Trimmed compact encoding: ``(startpos, codes int8[length])``.

    ``startpos`` is the number of leading N's dropped.  Only uppercase
    ``'N'`` is trimmed (callers upper-case FASTA lines first); an all-N
    sequence yields ``(len(sequence), [])``.
    """
    raw = sequence.encode("utf-8")
    start = ctypes.c_int64()
    end = ctypes.c_int64()
    native.load().dg_trim_n(raw, len(raw), ctypes.byref(start),
                            ctypes.byref(end))
    lo, hi = start.value, end.value
    return lo, _LUT[np.frombuffer(raw, dtype=np.uint8)[lo:hi]]


def one_hot_rows(codes: np.ndarray) -> np.ndarray:
    """Codes ``int8 [L]`` (0..4) -> one-hot ``int8 [5, L]``."""
    out = np.zeros((5, codes.size), dtype=np.int8)
    out[codes, np.arange(codes.size)] = 1
    return out


def one_hot_encode_dna_sequence(sequence: str) -> Tuple[int, np.ndarray]:
    """The reference's one-hot encoding (``sequence.pyx:11-36``):
    ``(startpos, int8[5, trimmed length])``, ``startpos`` the number of
    leading N's dropped."""
    startpos, codes = encode_codes_trimmed(sequence)
    return startpos, one_hot_rows(codes)
