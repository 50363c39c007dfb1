"""FASTA reading and the ``preprocess_sequence`` npz pipeline.

Counterpart of ``deepgrp_tpu/data/fasta.py``:

* ``read_multi_fasta`` streams ``(header, sequence)`` records and
  upper-cases sequence lines (the reference DeepGRP's
  ``__main__.py:20-43``);
* ``parse_gzip_fasta``, ``one_hot_from_sequence`` and
  ``preprocess_sequence_file`` are the ``preprocess_sequence`` tool
  (``fasta.py:45-94``; the reference's
  ``_scripts/preprocess_sequence.py:19-74``): a gzip FASTA becomes the
  one-hot ``int8[5, L]`` array ``fwd`` beside the md5 ``hash`` of its raw
  stripped sequence lines, saved as ``<path>.npz`` and regenerated only when
  the hash changes.  A multi-record file is concatenated into one sequence,
  as the reference parser does.
"""

from __future__ import annotations

import gzip
import hashlib
from typing import BinaryIO, Iterator, TextIO, Tuple

import numpy as np

from deepgrp_tpu_torch.ops.encoding import _LUT, one_hot_rows


def read_multi_fasta(filestream: TextIO) -> Iterator[Tuple[str, str]]:
    """Yield ``(header, sequence)`` for each record of a multi-FASTA stream;
    sequence lines are upper-cased."""
    header = ""
    sequence = []
    for line in filestream:
        line = line.strip()
        if not line:
            continue
        if line[0] == ">":
            if header:
                yield header, "".join(sequence)
            header = line[1:]
            sequence = []
        else:
            sequence.append(line.upper())
    if header:
        yield header, "".join(sequence)


def parse_gzip_fasta(filestream: BinaryIO) -> Tuple[str, str, str]:
    """Read a (possibly multi-record) FASTA byte stream.

    Returns ``(last header, md5 hex digest of the raw stripped sequence
    lines before upper-casing, concatenated upper-cased sequence)``.
    """
    sequence = []
    header = ""
    hash_md5 = hashlib.md5()
    for line in filestream:
        line = line.strip()
        if not line:
            continue
        if line[0:1] == b">":
            header = line[1:].decode()
        else:
            sequence.append(line.decode().upper())
            hash_md5.update(line)
    return header, hash_md5.hexdigest(), "".join(sequence)


def one_hot_from_sequence(seq: str) -> np.ndarray:
    """Full-length one-hot ``int8[5, len]`` (A, C, G, T, other; no N
    trimming)."""
    return one_hot_rows(_LUT[np.frombuffer(seq.encode("utf-8"),
                                           dtype=np.uint8)])


def preprocess_sequence_file(fasta_path: str, force: bool = False) -> bool:
    """Create ``<fasta_path>.npz`` with keys ``fwd`` and ``hash``.

    Skips the regeneration when the stored hash matches, unless ``force``.
    Returns True when a new npz was written.
    """
    with gzip.open(fasta_path, "rb") as infile:
        _, hash_val, seq = parse_gzip_fasta(infile)

    create_new = force
    try:
        with np.load(fasta_path + ".npz") as stored:
            if hash_val != stored["hash"][0]:
                create_new = True
    except (IOError, KeyError):
        create_new = True

    if create_new:
        np.savez_compressed(fasta_path, fwd=one_hot_from_sequence(seq),
                            hash=np.array([hash_val]))
    return create_new
