"""RepeatMasker ``.out`` parser: the ``parse_rm`` console tool.

The port's own copy of ``deepgrp_tpu/data/parse_rm.py`` (behavioural parity
with the reference DeepGRP's ``_scripts/parse_rm.py``): two row formats
(classic aligned RepeatMasker output and the tab-separated variant), a fixed
class map assigning ids 1..10 to the tracked repeat families, and HSATII
recovery for ``(MOTIF)n`` Simple_repeat/Satellite rows whose motif is
composed of GGAAT rotations / reverse complements / one-base mutations.
Classic-format rows are converted to 0-based starts (parse_rm.py:97)::

    python -m deepgrp_tpu_torch.data.parse_rm GENOME.fa.out -o repeats.bed

writes one ``ctg  start  end  class  repeat  family`` row (tab-separated)
per kept repeat; ``train`` reads the first four columns.  A host tool in
pure Python.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, NamedTuple, Optional, TextIO, Tuple

_COMPLEMENT = str.maketrans("ATCG", "TAGC")
_BASES = "ACGT"
MOTIF = "GGAAT"

# Family -> class id 1..10 (parse_rm.py:17-32); everything else is 0.
REPEAT_CLASSES: List[str] = [
    "HSATII",
    "ALR/Alpha",
    "SINE/Alu",
    "LINE/L1",
    "SINE/MIR",
    "LINE/L2",
    "LTR/ERV1",
    "LTR/ERVL",
    "LTR/ERVL-MaLR",
    "LTR/Gypsy",
]
_TYPE_IDS: Dict[str, int] = {name: i for i, name in enumerate(REPEAT_CLASSES, 1)}

# Classic RepeatMasker space-aligned row (parse_rm.py:34-36).
_REGEX1 = re.compile(r"^\s*\d+\s+\S+\s+\S+\s+\S+\s+(\S+)\s+"
                     r"(\d+)\s+(\d+)\s+\S+\s+[+C]\s+(\S+)\s+(\S+)")
# Tab-separated variant (parse_rm.py:37-38).
_REGEX2 = re.compile(r"^\d+(\t\d+){4}\t(\S+)\t(\d+)\t(\d+)\t\S+\t[+-]"
                     r"\t(\S+)\t(\S+)\t(\S+)")

_MOTIF_RE = re.compile(r"^\(([ACGT]+)\)n")


class Repeat(NamedTuple):
    ctg: Optional[str]
    start: Optional[int]
    end: Optional[int]
    typ: int
    rep: str
    fam: Optional[str]

    def __str__(self) -> str:
        return (f"{self.ctg}\t{self.start}\t{self.end}\t{self.typ}"
                f"\t{self.rep}\t{self.fam}")


def reverse_complements(motifs: List[str]) -> List[str]:
    return [m[::-1].translate(_COMPLEMENT) for m in motifs]


def rotations(motifs: List[str]) -> List[str]:
    out = []
    for motif in motifs:
        for j in range(1, len(motif)):
            out.append(motif[j:] + motif[:j])
    return out


def one_base_mutations(motifs: List[str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for motif in motifs:
        for i, char in enumerate(motif):
            for base in _BASES:
                if base != char:
                    out[motif[:i] + base + motif[i + 1:]] = 1
    return out


def build_motif_tables() -> Tuple[Dict[str, int], Dict[str, int]]:
    """GGAAT-family motif hash and its one-mutation hash (parse_rm.py:173-177)."""
    motifs = [MOTIF]
    motifs += reverse_complements(motifs)
    motifs += rotations(motifs)
    mutated = one_base_mutations(motifs)
    exact = {m: k for k, m in enumerate(motifs)}
    return exact, mutated


def _parse_row(line: str) -> Repeat:
    match1 = _REGEX1.match(line)
    ctg = start = end = fam = None
    rep = ""
    if match1:
        ctg = match1.group(1)
        start = int(match1.group(2)) - 1  # classic rows are 1-based
        end = int(match1.group(3))
        rep = match1.group(4)
        fam = match1.group(5)
    else:
        match2 = _REGEX2.match(line)
        if match2:
            ctg = match2.group(2)
            start = int(match2.group(3))
            end = int(match2.group(4))
            rep = match2.group(5)
            if match2.group(6) == match2.group(7):
                fam = match2.group(6)
            else:
                fam = match2.group(6) + "/" + match2.group(7)
    typ = _TYPE_IDS.get(fam, 0)
    if typ == 0:
        typ = _TYPE_IDS.get(rep, 0)
    return Repeat(ctg, start, end, typ, rep, fam)


def _motif_chunk_counts(motif: str, exact: Dict[str, int],
                        mutated: Dict[str, int]) -> Tuple[int, int]:
    count = count_mut = 0
    size = len(MOTIF)
    for j in range(0, len(motif), size):
        chunk = motif[j:j + size]
        if chunk in exact:
            count += 1
        elif chunk in mutated:
            count_mut += 1
    return count, count_mut


def read_repeatmasker(filestream: TextIO) -> Iterator[Repeat]:
    """Yield classified repeats from a RepeatMasker output stream."""
    exact, mutated = build_motif_tables()
    size = len(MOTIF)
    for line in filestream:
        repeat = _parse_row(line)
        if repeat.typ == 0 and repeat.fam in ("Simple_repeat", "Satellite"):
            motif = _MOTIF_RE.match(repeat.rep)
            if motif and motif.group(1) in exact:
                repeat = repeat._replace(typ=_TYPE_IDS["HSATII"])
            elif motif and len(motif.group(1)) % size == 0:
                count, count_mut = _motif_chunk_counts(motif.group(1), exact,
                                                       mutated)
                if count > 0 and (count + count_mut) * size == len(
                        motif.group(1)):
                    repeat = repeat._replace(typ=_TYPE_IDS["HSATII"])
        if repeat.ctg and repeat.typ > 0:
            yield repeat


def main(argv: Optional[List[str]] = None) -> None:
    """Console entry point: ``parse_rm GENOME.fa.out [-o out.bed]``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Convert RepeatMasker .out annotations to a BED-like "
        "TSV, keeping only the repeat families this framework models")
    parser.add_argument("file", type=argparse.FileType("r"),
                        help="Repeatmasker output")
    parser.add_argument("-o", "--outputfile", type=str, default=None,
                        help="Output filename")
    args = parser.parse_args(argv)

    with args.file:
        rows = map(str, read_repeatmasker(args.file))
        if not args.outputfile:
            for row in rows:
                print(row)
            return
        with open(args.outputfile, "w") as file:
            for row in rows:
                file.write(row + "\n")


if __name__ == "__main__":
    main()
