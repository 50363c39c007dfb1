"""Label preprocessing for training.

Counterpart of ``deepgrp_tpu/data/preprocess.py`` (parity with the
reference DeepGRP's ``preprocessing.py``):

* ``preprocess_y`` reads a whitespace-separated BED-like file
  (``chrom begin end repeatnumber``, further columns ignored), keeps the
  rows of one chromosome and of the repeat numbers searched, and builds an
  ``int8 [n_repeats + 1, length]`` one-hot whose row index is the repeat
  number itself (``yarray[number, begin:end] = 1``), with row 0 the
  background wherever no repeat matched (preprocessing.py:9-48);
* ``drop_start_end_n`` trims the positions where the first four one-hot
  rows are all zero at both ends, with the reference's off-by-one that
  drops the final non-N position (``end = shape-1 - argmax(...)``,
  preprocessing.py:64-68), kept for output parity.

The file is parsed with plain Python (no ``pandas``).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np


class Data(NamedTuple):
    """Forward one-hot sequence and true annotation labels."""

    fwd: np.ndarray      # int8-ish [5, length]
    truelbl: np.ndarray  # int8-ish [n_repeats + 1, length]


def preprocess_y(filename: os.PathLike, chromosom: str, length: int,
                 repeats_to_search: List[int]) -> np.ndarray:
    """One-hot encode the repeat annotations of one chromosome.

    Args:
        filename: whitespace-separated file with columns
            ``chrom begin end repeatnumber`` (output of ``parse_rm``).
        chromosom: chromosome name to select, e.g. ``"chr11"``.
        length: chromosome length in bp.
        repeats_to_search: repeat class ids to keep (become rows 1..n).

    Returns:
        ``int8[(len(repeats_to_search) + 1, length)]`` one-hot labels.
    """
    wanted = set(int(number) for number in repeats_to_search)
    yarray = np.zeros((len(repeats_to_search) + 1, length), dtype=np.int8)
    with open(filename) as file:
        for line in file:
            fields = line.split()
            if not fields or fields[0] != chromosom:
                continue
            begin, end, number = (int(f) for f in fields[1:4])
            if number in wanted:
                yarray[number, begin:end] = 1
    yarray[0, yarray[1:].sum(axis=0) == 0] = 1
    return yarray


def drop_start_end_n(fwd: np.ndarray,
                     array: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop leading/trailing all-N positions from sequence and labels.

    Keeps the reference's off-by-one (preprocessing.py:67): the returned
    slice ends one position before the last non-N base.
    """
    sums = fwd[0:4].sum(axis=0)
    start = np.argmax(sums > 0)
    end = fwd.shape[1] - 1 - np.argmax(np.flip(sums) > 0)
    return fwd[:, start:end], array[:, start:end]
