"""``preprocess_sequence`` console tool: gzip FASTA -> one-hot npz.

Counterpart of ``deepgrp_tpu/data/preprocess_sequence.py`` (the reference
DeepGRP's ``_scripts/preprocess_sequence.py``)::

    python -m deepgrp_tpu_torch.data.preprocess_sequence GENOME.fa.gz [--force]

writes ``GENOME.fa.gz.npz`` (``fwd``, ``hash``); an unchanged input is
skipped unless ``--force``.  A host tool: it needs neither a card nor
torch.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from deepgrp_tpu_torch.data.fasta import preprocess_sequence_file


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Format fasta file to onehot encoded sequences")
    parser.add_argument("FASTAFILE", type=str, help="Fastafile (gzip)")
    parser.add_argument("--force", action="store_true",
                        help="forces recreation even if files not changed")
    args = parser.parse_args(argv)
    try:
        preprocess_sequence_file(args.FASTAFILE, force=args.force)
    except IOError:
        sys.stderr.write("Could not open file!\n")
        sys.exit(1)


if __name__ == "__main__":
    main()
