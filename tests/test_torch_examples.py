"""The port's examples (``deepgrp_tpu_torch/examples/``) on the CPU: the
counterparts of ``tests/test_examples.py``, on the dataset of that file's
``tiny_dataset`` fixture.

``train_and_evaluate`` (run as a script path) writes one CSV row and
``model00.npz``; the JAX package loads that model file and its example's
evaluation lines (``predict_complete(..., use_mss=True)``,
``filter_segments``, ``calculate_metrics``) give the CSV's MCC to 1e-6.
``multihost_sim --device cpu`` exits 0 (every rank bit-identical to one
process), and its single-process output matches the JAX package's
``PredictionEngine`` on the same numpy weights: classes equal, max
probabilities within 1e-6.  With ``--device cuda`` and no GPU every
example raises.  ``hpo_sweep`` is in ``tests/test_torch_hpo_sweep.py``.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.data import preprocess as jax_prep  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.models.keras_io import load_model as jax_load  # noqa: E402
from deepgrp_tpu.predict import (calculate_metrics,  # noqa: E402
                                 filter_segments, predict_complete)
from deepgrp_tpu.predict.engine import \
    PredictionEngine as JaxEngine  # noqa: E402
from deepgrp_tpu_torch.examples import (hpo_sweep,  # noqa: E402
                                        multihost_sim, train_and_evaluate)

from test_examples import tiny_dataset  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "deepgrp_tpu_torch", "examples")


def run_port_example(args, cwd, module=False):
    """The example as a script path (with no ``PYTHONPATH``: the script
    finds its checkout) or, with ``module``, through ``python -m``."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    if module:
        command = [sys.executable, "-m",
                   f"deepgrp_tpu_torch.examples.{args[0]}", *args[1:]]
        env["PYTHONPATH"] = REPO
    else:
        command = [sys.executable, os.path.join(EXAMPLES, f"{args[0]}.py"),
                   *args[1:]]
    return subprocess.run(command, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def dataset_args(root):
    return [str(root / "chrT.train.npz"), str(root / "chrV.val.npz"),
            str(root / "anno.bed")]


def test_train_and_evaluate_matches_jax_evaluation(tiny_dataset):
    out = tiny_dataset / "out"
    result = run_port_example(
        ["train_and_evaluate", *dataset_args(tiny_dataset), "--runs", "1",
         "--outdir", str(out), "--config", str(tiny_dataset / "tiny.toml"),
         "--device", "cpu"], cwd=str(tiny_dataset))
    assert result.returncode == 0, result.stdout + result.stderr
    with open(out / "training_times.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert list(rows[0]) == ["run", "seconds", "epochs", "val_loss", "MCC"]
    assert float(rows[0]["seconds"]) > 0
    assert int(rows[0]["epochs"]) == 2
    assert os.path.isdir(out / "run00")

    # The JAX example's evaluation lines on the port's model file.
    with open(tiny_dataset / "tiny.toml") as f:
        options = JaxOptions.from_toml(f)
    fwd = np.load(tiny_dataset / "chrV.val.npz")["fwd"]
    labels = jax_prep.preprocess_y(str(tiny_dataset / "anno.bed"), "chrV",
                                   fwd.shape[1], options.repeats_to_search)
    val_data = jax_prep.Data(*jax_prep.drop_start_end_n(fwd, labels))
    _, params = jax_load(str(out / "model00.npz"))
    predictions = predict_complete(50, options, str(out / "run00"),
                                   val_data, use_mss=True, params=params)
    classes = predictions.argmax(axis=1)
    filter_segments(classes, options.min_mss_len)
    _, metrics = calculate_metrics(classes, val_data.truelbl.argmax(axis=0))
    mcc = float(rows[0]["MCC"])
    assert np.isfinite(mcc)
    assert abs(metrics["MCC"] - mcc) <= 1e-6


def test_multihost_sim_on_cpu():
    result = run_port_example(["multihost_sim", "--device", "cpu"],
                              cwd=REPO, module=True)
    assert result.returncode == 0, result.stdout + result.stderr
    assert "bit-identical" in result.stdout


def test_multihost_sim_single_process_matches_jax():
    classes, maxp = multihost_sim.single_process("cpu")
    config = multihost_sim.model_config()
    engine = JaxEngine(jax_model.DeepGRPModel(jax_model.ModelConfig(
        **config.todict())), batch_size=multihost_sim.BATCH,
        step_size=multihost_sim.STEP)
    want_classes, want_maxp = engine.predict_scored(
        multihost_sim.jax_layout_params(), multihost_sim.build_inputs())
    assert classes.shape == (multihost_sim.SEQ_LEN,)
    assert len(np.unique(classes)) > 1
    np.testing.assert_array_equal(classes, np.asarray(want_classes))
    np.testing.assert_allclose(maxp, np.asarray(want_maxp), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("example,args", [
    (train_and_evaluate, ["a.npz", "b.npz", "r.bed"]),
    (hpo_sweep, ["a.npz", "b.npz", "r.bed"]),
    (multihost_sim, [])])
def test_examples_refuse_cuda_without_a_card(example, args):
    """``--device cuda`` (the default) with no GPU raises before any data
    is read; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(args)
