"""The port's ``hpo_sweep`` example (``deepgrp_tpu_torch/examples/
hpo_sweep.py``) on the CPU, on the dataset of ``tests/test_examples.py``'s
``tiny_dataset`` fixture: the serial TPE sweep writes ``results.pkl``, a
second call resumes it to the total, ``--parallel 2`` (the bucketed sweep)
finishes, ``--seed`` repeats the proposals, and each trial's result has
the keys of the JAX example's ``results.pkl``."""

import os
import pickle
import subprocess
import sys

import pytest

pytest.importorskip("jax")
from deepgrp_tpu_torch.examples import hpo_sweep  # noqa: E402

from test_examples import tiny_dataset  # noqa: E402,F401
from test_torch_examples import dataset_args, run_port_example  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep_args(root, name, trials, *extra):
    return [*dataset_args(root), "--trials", str(trials), "--save-step",
            "1", "--space", "quick", "--config", str(root / "tiny.toml"),
            "--step-size", "10", "--root", str(root / name), *extra]


def load_trials(path):
    with open(path, "rb") as fh:
        return pickle.load(fh).trials


def test_hpo_sweep_saves_resumes_and_runs_fleets(tiny_dataset):
    result = run_port_example(
        ["hpo_sweep", *sweep_args(tiny_dataset, "sweep", 2, "--device",
                                  "cpu")], cwd=str(tiny_dataset),
        module=True)
    assert result.returncode == 0, result.stdout + result.stderr
    results = tiny_dataset / "sweep" / "results.pkl"
    assert len(load_trials(results)) == 2
    # Resume: three trials in all.
    hpo_sweep.main(sweep_args(tiny_dataset, "sweep", 3, "--device", "cpu"))
    trials = load_trials(results)
    assert len(trials) == 3
    assert all(set(t["params"]) == {"learning_rate", "dropout"}
               for t in trials)
    # The bucketed sweep: one fleet of two trials.
    hpo_sweep.main(sweep_args(tiny_dataset, "fleet", 2, "--parallel", "2",
                              "--device", "cpu"))
    fleet = load_trials(tiny_dataset / "fleet" / "results.pkl")
    assert len(fleet) == 2
    assert all(t["result"]["status"] in ("ok", "fail") for t in fleet)


def test_hpo_sweep_seed_repeats_proposals(tiny_dataset):
    """``--seed`` makes the serial sweep's proposals repeatable."""
    params = []
    for name in ("seeded-a", "seeded-b"):
        hpo_sweep.main(sweep_args(tiny_dataset, name, 2, "--seed", "3",
                                  "--device", "cpu"))
        params.append([t["params"] for t in load_trials(
            tiny_dataset / name / "results.pkl")])
    assert params[0] == params[1]
    assert params[0][0] != params[0][1]  # each save step draws anew


def test_hpo_sweep_result_keys_match_jax_example(tiny_dataset):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    result = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "hpo_sweep.py"),
         *sweep_args(tiny_dataset, "jax", 1)], cwd=str(tiny_dataset),
        env=env, capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stdout + result.stderr
    hpo_sweep.main(sweep_args(tiny_dataset, "port", 1, "--device", "cpu"))
    want = load_trials(tiny_dataset / "jax" / "results.pkl")
    got = load_trials(tiny_dataset / "port" / "results.pkl")
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    assert set(got[0]["result"]) == set(want[0]["result"])
    assert set(got[0]["params"]) == set(want[0]["params"])
