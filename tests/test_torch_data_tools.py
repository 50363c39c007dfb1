"""The port's data console tools against the JAX package's: the
``preprocess_sequence`` npz (``fwd`` and ``hash``) of a gzip FASTA and the
``parse_rm`` rows of a RepeatMasker ``.out`` file, on inputs built here
from a seed."""

import gzip
import io
import os
import shutil

import numpy as np
import pytest

from deepgrp_tpu.data import fasta as jax_fasta
from deepgrp_tpu.data import parse_rm as jax_parse_rm
from deepgrp_tpu.data import preprocess_sequence as jax_tool
from deepgrp_tpu_torch.data import fasta, parse_rm, preprocess_sequence


def write_gzip_fasta(path, seed):
    """A multi-record FASTA with lowercase, N runs, IUPAC letters and
    blank lines, in lines of 60 bases."""
    rng = np.random.default_rng(seed)
    lines = []
    for record in range(3):
        seq = np.array(list("ACGTacgtN"))[rng.integers(0, 9, 500)]
        seq[100:160] = "N"
        seq[7] = "R"
        text = "".join(seq)
        lines.append(f">chr{record} description {record}")
        lines += [text[i:i + 60] for i in range(0, len(text), 60)]
        lines.append("")
    with gzip.open(path, "wb") as fh:
        fh.write(("\n".join(lines) + "\n").encode())


@pytest.mark.parametrize("seed", [0, 1])
def test_npz_equals_jax_tool(tmp_path, seed):
    ours, theirs = str(tmp_path / "ours.fa.gz"), str(tmp_path / "jax.fa.gz")
    write_gzip_fasta(ours, seed)
    shutil.copy(ours, theirs)
    preprocess_sequence.main([ours])
    jax_tool.main([theirs])
    with np.load(ours + ".npz") as got, np.load(theirs + ".npz") as want:
        assert sorted(got.files) == sorted(want.files) == ["fwd", "hash"]
        assert got["fwd"].dtype == want["fwd"].dtype == np.int8
        np.testing.assert_array_equal(got["fwd"], want["fwd"])
        np.testing.assert_array_equal(got["hash"], want["hash"])
    with gzip.open(ours, "rb") as fh, gzip.open(theirs, "rb") as jh:
        assert fasta.parse_gzip_fasta(fh) == jax_fasta.parse_gzip_fasta(jh)


def test_one_hot_from_sequence_equals_jax():
    seq = "".join(np.array(list("ACGTNacgtnRYK"))[
        np.random.default_rng(2).integers(0, 13, 1000)])
    np.testing.assert_array_equal(fasta.one_hot_from_sequence(seq),
                                  jax_fasta.one_hot_from_sequence(seq))


def test_preprocess_sequence_caching(tmp_path):
    """``tests/test_data.py::test_preprocess_sequence_caching`` against the
    port: written, skipped on an unchanged hash, forced, rewritten on a
    changed input."""
    path = str(tmp_path / "genome.fa.gz")
    with gzip.open(path, "wb") as f:
        f.write(b">chr1\nACGT\nNNAC\n")
    assert fasta.preprocess_sequence_file(path) is True
    with np.load(path + ".npz") as data:
        assert data["fwd"].shape == (5, 8)
        np.testing.assert_array_equal(data["fwd"].argmax(axis=0),
                                      [0, 1, 2, 3, 4, 4, 0, 1])
    mtime = os.stat(path + ".npz").st_mtime_ns
    assert fasta.preprocess_sequence_file(path) is False
    assert os.stat(path + ".npz").st_mtime_ns == mtime
    assert fasta.preprocess_sequence_file(path, force=True) is True
    with gzip.open(path, "wb") as f:
        f.write(b">chr1\nTTTT\n")
    assert fasta.preprocess_sequence_file(path) is True
    with np.load(path + ".npz") as data:
        np.testing.assert_array_equal(data["fwd"].argmax(axis=0),
                                      [3, 3, 3, 3])


def test_preprocess_sequence_force_flag(tmp_path):
    path = str(tmp_path / "genome.fa.gz")
    write_gzip_fasta(path, 3)
    preprocess_sequence.main([path])
    os.utime(path + ".npz", ns=(0, 0))
    preprocess_sequence.main([path])
    assert os.stat(path + ".npz").st_mtime_ns == 0
    preprocess_sequence.main([path, "--force"])
    assert os.stat(path + ".npz").st_mtime_ns > 0


def test_preprocess_sequence_missing_file_exits_1(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        preprocess_sequence.main([str(tmp_path / "absent.fa.gz")])
    assert exc.value.code == 1
    assert capsys.readouterr().err == "Could not open file!\n"


ROWS = [
    # classic rows, 1-based: a tracked family, the C strand, motif rows
    "  463 1.3 0.6 1.7 chr21 100 200 (46000000) + AluYb8 SINE/Alu 1 100 "
    "(0) 1",
    "  463 1.3 0.6 1.7 chr21 300 400 (46000000) C L1PA3 LINE/L1 (0) 6155 "
    "5850 2",
    "  12 0.0 0.0 0.0 chr21 900 950 (0) + (GGAAT)n Simple_repeat 1 50 (0) 3",
    "  12 0.0 0.0 0.0 chr21 960 990 (0) + (CATTC)n Satellite 1 30 (0) 4",
    "  12 0.0 0.0 0.0 chr21 995 999 (0) + (ATTCC)n Satellite 1 4 (0) 4",
    "  12 0.0 0.0 0.0 chr21 1000 1050 (0) + (GGAATGGATT)n Simple_repeat 1 "
    "50 (0) 5",
    "  12 0.0 0.0 0.0 chr21 1060 1070 (0) + (GGATTGGATT)n Simple_repeat 1 "
    "10 (0) 5",
    "  12 0.0 0.0 0.0 chr21 1080 1090 (0) + (GGAATG)n Satellite 1 10 (0) 5",
    "  12 0.0 0.0 0.0 chr21 1100 1150 (0) + (CACAC)n Simple_repeat 1 50 "
    "(0) 6",
    "  99 1.0 1.0 1.0 chr21 1200 1300 (0) + MER5A DNA/hAT-Charlie 1 100 (0) "
    "7",
    "  99 1.0 1.0 1.0 chr22 1400 1500 (0) + ALR/Alpha Satellite/centr 1 100 "
    "(0) 8",
    "  99 1.0 1.0 1.0 chr22 1600 1700 (0) + MIRb SINE/MIR 1 100 (0) 9",
    "  99 1.0 1.0 1.0 chr22 1800 1900 (0) + MER41B LTR/ERV1 1 100 (0) 10",
    # tab-separated rows, 0-based
    "0\t0\t0\t0\t0\tchr21\t500\t600\t0\t+\tHSATII\tSatellite\tSatellite",
    "0\t0\t0\t0\t0\tchr21\t700\t800\t0\t-\tAluSx\tSINE\tAlu",
    "0\t0\t0\t0\t0\tchr21\t810\t820\t0\t+\tL2a\tLINE\tL2",
    "0\t0\t0\t0\t0\tchr21\t830\t840\t0\t+\tTigger1\tDNA\tTcMar-Tigger",
    "0\t0\t0\t0\t0\tchr21\t850\t860\t0\t+\t(GGAAT)n\tSatellite\tSatellite",
    # a header and a malformed row
    "   SW  perc perc perc  query      position in query    matching",
    "not a RepeatMasker row",
]


def test_parse_rm_rows_equal_jax():
    text = "\n".join(ROWS) + "\n"
    got = list(parse_rm.read_repeatmasker(io.StringIO(text)))
    want = list(jax_parse_rm.read_repeatmasker(io.StringIO(text)))
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert [str(r) for r in got] == [str(r) for r in want]
    # The motif rows: exact, rotation, reverse complement and one-mutation
    # chunks recover HSATII; a motif of two mutated chunks, one of the
    # wrong length and CACAC do not; untracked families are dropped.
    kept = {(r.ctg, r.start): r.typ for r in got}
    assert kept[("chr21", 899)] == kept[("chr21", 959)] == 1
    assert kept[("chr21", 994)] == kept[("chr21", 999)] == 1
    assert ("chr21", 1059) not in kept and ("chr21", 1079) not in kept
    assert ("chr21", 1099) not in kept and ("chr21", 1199) not in kept
    assert ("chr21", 830) not in kept
    assert kept[("chr21", 99)] == 3 and kept[("chr21", 299)] == 4
    assert kept[("chr21", 500)] == 1 and kept[("chr21", 700)] == 3


def test_parse_rm_tables_equal_jax():
    assert parse_rm.REPEAT_CLASSES == jax_parse_rm.REPEAT_CLASSES
    assert parse_rm.build_motif_tables() == jax_parse_rm.build_motif_tables()


@pytest.mark.parametrize("to_file", [True, False])
def test_parse_rm_main_equals_jax(tmp_path, capsys, to_file):
    infile = tmp_path / "genome.fa.out"
    infile.write_text("\n".join(ROWS) + "\n")
    outputs = []
    for tool, name in ((parse_rm, "ours.bed"), (jax_parse_rm, "jax.bed")):
        out = tmp_path / name
        tool.main([str(infile)] + (["-o", str(out)] if to_file else []))
        outputs.append(out.read_text() if to_file
                       else capsys.readouterr().out)
    assert outputs[0] == outputs[1]
    assert len(outputs[0].splitlines()) == 13


def test_parse_rm_missing_file_exits_as_jax(tmp_path):
    codes = []
    for tool in (parse_rm, jax_parse_rm):
        with pytest.raises(SystemExit) as exc:
            tool.main([str(tmp_path / "absent.out")])
        codes.append(exc.value.code)
    assert codes == [2, 2]
