"""Four faults of the port's CLI against the JAX package's, each closed
here: ``--xla`` is accepted as a no-op, an HDF5 model without an
``.h5``/``.hdf5`` suffix loads (the magic is sniffed), ``-t N`` bounds
torch's host threads, and ``predict -m`` writes no rows for an empty or
all-N record (where the JAX package's softmax raises) and every other
record's rows unchanged.  Also ``--profile DIR`` on a CPU predict."""

import json
import os
import shutil
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

from deepgrp_tpu import cli as jax_cli  # noqa: E402
from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.__main__ import _prescan_threads  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXDIR = os.path.join(HERE, "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "fixtures", "torch")
REF_ARGS = ["-b", "64", "-s", "50", "-x", "50", "-l", "50"]
MODEL = os.path.join(TORCH_FIXDIR, "gru_att.npz")
FASTA = os.path.join(FIXDIR, "gru_att.fa")


def bed_rows(path):
    """The rows without the file-name column."""
    with open(path) as fh:
        return [line.split("\t", 1)[1] for line in fh.read().splitlines()]


def reference_rows():
    with open(os.path.join(FIXDIR, "gru_att.bed")) as fh:
        return fh.read().splitlines()


def test_xla_flag_is_a_no_op(tmp_path):
    out = tmp_path / "gru_att.bed"
    cli.main(["--xla", "--device", "cpu", *REF_ARGS, "predict", MODEL,
              FASTA, "--output", str(out)])
    assert bed_rows(out) == reference_rows()
    assert cli.build_parser().parse_args(
        ["--xla", "predict", "m", "f"]).xla is True


def test_suffixless_h5_model_loads(tmp_path):
    model = tmp_path / "gru_att_model"
    shutil.copy(os.path.join(FIXDIR, "gru_att.h5"), model)
    out = tmp_path / "gru_att.bed"
    cli.main(["--device", "cpu", *REF_ARGS, "predict", str(model), FASTA,
              "--output", str(out)])
    assert bed_rows(out) == reference_rows()


def test_threads_prescan_sets_omp(monkeypatch):
    """``tests/test_cli.py::test_threads_prescan_sets_omp`` against the
    port's ``__main__``."""
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    _prescan_threads(["-b", "8", "-t", "3", "predict", "m", "f"])
    assert os.environ["OMP_NUM_THREADS"] == "3"
    monkeypatch.setenv("OMP_NUM_THREADS", "7")
    _prescan_threads(["-t", "2"])  # existing value wins
    assert os.environ["OMP_NUM_THREADS"] == "7"
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    _prescan_threads(["--threads=4"])
    assert os.environ["OMP_NUM_THREADS"] == "4"
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    _prescan_threads(["-t", "0"])  # 0 = all threads: leave unset
    assert "OMP_NUM_THREADS" not in os.environ


def test_threads_bound_torch_in_a_run(tmp_path):
    """``python -m deepgrp_tpu_torch -t 2`` runs torch on 2 threads (the
    run logs its count at ``-v``) and exports ``OMP_NUM_THREADS`` before
    torch loads; the BED is unchanged."""
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    out = tmp_path / "gru_att.bed"
    result = subprocess.run(
        [sys.executable, "-m", "deepgrp_tpu_torch", "-t", "2", "-v",
         "--device", "cpu", *REF_ARGS, "predict", MODEL, FASTA,
         "--output", str(out)], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600, check=True)
    assert "host threads: torch 2, OMP_NUM_THREADS 2" in result.stderr
    assert bed_rows(out) == reference_rows()


def test_threads_restored_after_main(tmp_path):
    import torch

    threads = torch.get_num_threads()
    cli.main(["-t", "1", "--device", "cpu", *REF_ARGS, "predict", MODEL,
              FASTA, "--output", str(tmp_path / "out.bed")])
    assert torch.get_num_threads() == threads


def test_no_mss_skips_empty_and_all_n_records(tmp_path):
    """``-m`` on a FASTA with an empty record, an all-N record and the
    fixture's records: the rows equal the JAX package's ``-m`` rows on the
    fixture alone."""
    mixed = tmp_path / "mixed.fa"
    with open(FASTA) as fh:
        mixed.write_text(">empty\n>all_n\n" + "N" * 700 + "\n" + fh.read())
    got, want = tmp_path / "port.bed", tmp_path / "jax.bed"
    cli.main(REF_ARGS + ["--device", "cpu", "predict", MODEL, str(mixed),
                         "-m", "--output", str(got)])
    jax_cli.main(REF_ARGS + ["predict", os.path.join(FIXDIR, "gru_att.h5"),
                             FASTA, "-m", "--mesh", "off", "--output",
                             str(want)])
    assert bed_rows(want), "the JAX package wrote no rows"
    assert bed_rows(got) == bed_rows(want)


def test_profile_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    out = tmp_path / "out.bed"
    cli.main(["--profile", str(trace_dir), "--device", "cpu", *REF_ARGS,
              "predict", MODEL, FASTA, "--output", str(out)])
    assert bed_rows(out) == reference_rows()
    traces = list(trace_dir.glob("predict.*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(event.get("name") == "aten::mm" for event in events)
