"""FASTA reading (counterpart of ``read_multi_fasta`` in
``deepgrp_tpu/data/fasta.py``; parity with the reference DeepGRP's
``__main__.py:20-43``)."""

from __future__ import annotations

from typing import Iterator, TextIO, Tuple


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
