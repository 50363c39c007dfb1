"""The port's HPO slice (``deepgrp_tpu_torch.hpo``) against the JAX
package: search space, TPE, the objective and its resume, the trial fleet
and the shape-bucketed sweep.

Sizes follow ``tests/test_hpo.py`` (vecsize 20, units 4-8, batch 8-16,
``make_tiny_data``); the port runs on the CPU (the kernels' plain
versions).  Inputs come from numpy seeds; weights from the JAX package's
initialiser through ``params_from_jax``.  Tolerances are stated per test.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.hpo import space as jax_space  # noqa: E402
from deepgrp_tpu.hpo import tpe as jax_tpe  # noqa: E402
from deepgrp_tpu.hpo import vmapped as jax_vmapped  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.models import rnn as jax_rnn  # noqa: E402
from deepgrp_tpu.train import sampler as jax_sampler  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.preprocess import Data  # noqa: E402
from deepgrp_tpu_torch.hpo import (STATUS_FAIL, STATUS_OK,  # noqa: E402
                                   Trials, build_and_optimize, fmin,
                                   run_a_trial, run_bucketed_sweep)
from deepgrp_tpu_torch.hpo import optimization, space, tpe  # noqa: E402
from deepgrp_tpu_torch.hpo import vmapped  # noqa: E402
from deepgrp_tpu_torch.hpo.bucketed import shape_bucket_key  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig, init_params)
from deepgrp_tpu_torch.train.optimizers import fleet_optimizer  # noqa: E402
from deepgrp_tpu_torch.train.sampler import BatchSampler  # noqa: E402


def make_tiny_data(seed=0):
    """``tests/test_hpo.py:73-84``."""
    rng = np.random.default_rng(seed)
    length = 1500
    codes = rng.integers(0, 4, size=length)
    truelbl = np.zeros((3, length), dtype=np.int8)
    for start in range(100, length - 100, 400):
        codes[start:start + 80] = 0
        truelbl[1, start:start + 80] = 1
    truelbl[0] = truelbl[1:].sum(axis=0) == 0
    fwd = np.zeros((5, length), dtype=np.int8)
    fwd[codes, np.arange(length)] = 1
    return Data(fwd=fwd, truelbl=truelbl)


def base_options(tmp_path, **kwargs):
    """``tests/test_hpo.py:87-91``."""
    base = dict(vecsize=20, units=4, batch_size=8, n_epochs=2, n_batches=2,
                early_stopping_th=3, dropout=0.0, repeats_to_search=[1, 2],
                project_root_dir=str(tmp_path))
    base.update(kwargs)
    return Options(**base)


# -- search space and TPE -----------------------------------------------------


def test_reference_space_equals_jax():
    def fields(sp):
        return {name: dataclasses.astuple(dim) for name, dim in sp.items()}

    assert fields(space.reference_search_space()) == \
        fields(jax_space.reference_search_space())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_space_equals_jax(seed):
    got = [space.sample_space(space.reference_search_space(),
                              np.random.default_rng(seed))
           for _ in range(3)]
    want = [jax_space.sample_space(jax_space.reference_search_space(),
                                   np.random.default_rng(seed))
            for _ in range(3)]
    assert got == want


def history(store, seed, n_trials):
    """``n_trials`` sampled trials of the reference space, a few of them
    failed, recorded into ``store``."""
    rng = np.random.default_rng(seed)
    ref = jax_space.reference_search_space()
    for i in range(n_trials):
        params = jax_space.sample_space(ref, rng)
        if i % 7 == 3:
            result = {"loss": np.inf, "status": STATUS_FAIL}
        else:
            result = {"loss": float(rng.normal()), "status": STATUS_OK}
        store.record(params, result)
    return store


@pytest.mark.parametrize("seed,n_trials,n_startup", [
    (0, 5, 20), (1, 30, 20), (2, 12, 4), (3, 40, 10)])
def test_suggest_equals_jax(seed, n_trials, n_startup):
    """Proposals from the startup draws and from the TPE model equal the
    JAX copy's exactly for the same history and seed."""
    got_trials = history(Trials(), seed, n_trials)
    want_trials = history(jax_tpe.Trials(), seed, n_trials)
    got_rng, want_rng = (np.random.default_rng(seed + 100),
                         np.random.default_rng(seed + 100))
    for _ in range(3):
        got = tpe.suggest(space.reference_search_space(), got_trials,
                          got_rng, n_startup=n_startup)
        want = jax_tpe.suggest(jax_space.reference_search_space(),
                               want_trials, want_rng, n_startup=n_startup)
        assert got == want
    assert got_trials.best_trial() == want_trials.best_trial()


@pytest.mark.parametrize("seed", [0, 5])
def test_fmin_equals_jax(seed):
    def objective(params):
        return {"loss": (params["x"] - 2.0) ** 2 + params["y"],
                "status": STATUS_OK}

    got = fmin(objective, {"x": space.uniform("x", -5, 5),
                           "y": space.lognormal("y", -1, 0.5)},
               Trials(), max_evals=25, seed=seed, n_startup=8)
    want = jax_tpe.fmin(objective, {"x": jax_space.uniform("x", -5, 5),
                                    "y": jax_space.lognormal("y", -1, 0.5)},
                        jax_tpe.Trials(), max_evals=25, seed=seed,
                        n_startup=8)
    assert got.trials == want.trials


# -- the objective ----------------------------------------------------------


def test_build_and_optimize_ok_path(tmp_path):
    """``tests/test_hpo.py:94-120`` on the port: a trained trial with its
    logdir, ``hparams.json``, one ``hpo/MCC`` record (in
    ``metrics.jsonl`` and a TensorBoard events file) and the int
    coercion of vecsize and units."""
    options = base_options(tmp_path, n_epochs=5, n_batches=10,
                           batch_size=16)
    result = build_and_optimize(make_tiny_data(0), make_tiny_data(1), 10,
                                options, {"learning_rate": 0.05,
                                          "vecsize": 20.0, "units": 8.0},
                                device="cpu")
    assert result["status"] == STATUS_OK
    assert np.isfinite(result["loss"])
    assert result["Metrics"] is not None
    assert result["options"]["vecsize"] == 20
    assert result["options"]["units"] == 8
    logdir = result["logdir"]
    with open(os.path.join(logdir, "hparams.json")) as fh:
        hparams = json.load(fh)
    assert hparams == {"learning_rate": 0.05, "units": 8.0, "vecsize": 20.0}
    records = [json.loads(line) for line in
               open(os.path.join(logdir, "metrics.jsonl"))]
    mccs = [r["hpo/MCC"] for r in records if "hpo/MCC" in r]
    assert len(mccs) == 1
    assert mccs[0] == pytest.approx(-result["loss"])
    assert any(name.startswith("events.out.tfevents")
               for name in os.listdir(logdir))
    assert any(name.endswith(".npz") for name in os.listdir(logdir))


def test_build_and_optimize_failure_paths(tmp_path, monkeypatch):
    """A trial that raises is failed with its error, as in the JAX package
    (``tests/test_hpo.py:153-160``); a trial whose MCC is NaN is failed
    and its logdir removed."""
    options = base_options(tmp_path)
    result = build_and_optimize(make_tiny_data(0), make_tiny_data(1), 10,
                                options, {"vecsize": 100000}, device="cpu")
    assert result["status"] == STATUS_FAIL
    assert result["loss"] == np.inf
    assert result["error"]
    assert result["logdir"] is None

    logdirs = []

    def nan_metrics(options, step_size, logdir, *args, **kwargs):
        logdirs.append(logdir)
        return {"MCC": float("nan")}

    monkeypatch.setattr(optimization, "evaluate_trained", nan_metrics)
    result = build_and_optimize(make_tiny_data(0), make_tiny_data(1), 10,
                                base_options(tmp_path), {"vecsize": 20},
                                device="cpu")
    assert (result["status"], result["loss"]) == (STATUS_FAIL, np.inf)
    assert result["Metrics"] == {"MCC": result["Metrics"]["MCC"]}
    assert len(logdirs) == 1 and not os.path.exists(logdirs[0])


def test_run_a_trial_resumes(tmp_path):
    """``tests/test_hpo.py:163-178`` on the port, and the pickled proposals
    equal the JAX package's for the same seeds."""
    sp = {"x": space.uniform("x", 0, 1)}

    def objective(params):
        return {"loss": params["x"], "status": STATUS_OK}

    assert run_a_trial(sp, objective, str(tmp_path), 3, seed=0) == 3
    assert run_a_trial(sp, objective, str(tmp_path), 2, seed=1) == 5
    with open(tmp_path / "results.pkl", "rb") as fh:
        trials = pickle.load(fh)
    assert len(trials) == 5

    from deepgrp_tpu.hpo.optimization import run_a_trial as jax_run

    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_run({"x": jax_space.uniform("x", 0, 1)}, objective, str(jax_dir), 3,
            seed=0)
    jax_run({"x": jax_space.uniform("x", 0, 1)}, objective, str(jax_dir), 2,
            seed=1)
    with open(jax_dir / "results.pkl", "rb") as fh:
        assert pickle.load(fh).trials == trials.trials


# -- the trial fleet --------------------------------------------------------


FLEET_TRIALS = [{"learning_rate": 0.01, "dropout": 0.1},
                {"learning_rate": 0.02, "momentum": 0.5, "dropout": 0.2},
                {"learning_rate": 0.05, "rho": 0.7, "epsilon": 1e-7}]


@pytest.mark.parametrize("rnn_type,attention,optimizer", [
    ("GRU", True, "RMSprop"), ("LSTM", False, "RMSprop"),
    ("GRU", False, "Adam")])
def test_fleet_step_matches_jax(tmp_path, rnn_type, attention, optimizer):
    """One fleet step equals the JAX package's ``_parallel_step`` at atol
    1e-5 (per-trial losses and updated parameters), fed the same windows
    and masks: the test recomputes them through the JAX package's
    ``_sample_starts`` and ``_input_dropout_masks`` from the keys the step
    splits.  The second trial is inactive: its parameters stay bit for
    bit.  (The JAX fleet trains on the one-hot scan route, the port's on
    the fused route: the same function.)"""
    options = base_options(tmp_path, rnn=rnn_type, attention=attention,
                           optimizer=optimizer, units=6)
    jax_options = JaxOptions(**options.todict())
    data = make_tiny_data(0)
    model = jax_model.create_model(jax_options)
    n_trials = len(FLEET_TRIALS)
    params = jax.vmap(model.init)(
        jax.random.split(jax.random.PRNGKey(4), n_trials))
    host = jax.device_get(params)
    hp_np = jax_vmapped.stack_trial_hyperparams(jax_options, FLEET_TRIALS)
    np.testing.assert_array_equal(
        np.stack(list(hp_np.values())),
        np.stack(list(vmapped.stack_trial_hyperparams(
            options, FLEET_TRIALS).values())))
    hp = {k: jnp.asarray(v) for k, v in hp_np.items()}
    jax_opt = jax_vmapped._injected_optimizer(optimizer)
    opt_states = jax.vmap(jax_opt.init)(params)
    sampler = jax_sampler.BatchSampler(jax_options, data)
    static = (sampler.n_sampled_classes, sampler.one_class_size,
              sampler.batch_size, sampler.seq_len)
    keys = jax.random.split(jax.random.PRNGKey(9), n_trials)
    active = np.array([True, False, True])
    new_params, _, jax_losses = jax_vmapped._parallel_step(
        params, opt_states, hp, keys, jnp.asarray(active), sampler._fwd,
        sampler._lbl, sampler._candidates, sampler._lengths, static, model,
        optimizer, options.vecsize)
    want = jax.device_get(new_params)

    config = ModelConfig.from_options(options)
    port_sampler = BatchSampler(options, data, "cpu")
    models, batches = [], []
    for i in range(n_trials):
        trial = jax.tree.map(lambda a, i=i: np.asarray(a[i]), host)
        models.append(DeepGRPModel.from_params(config,
                                               params_from_jax(trial), "cpu"))
        key_sample, key_dropout = jax.random.split(keys[i])
        starts = jax_sampler._sample_starts(key_sample, sampler._candidates,
                                            sampler._lengths, *static,
                                            options.vecsize)
        masks = jax_rnn._input_dropout_masks(
            key_dropout, (2 * options.batch_size, 5), hp["dropout"][i],
            config.gates, jnp.float32)
        codes, labels = port_sampler.gather(
            torch.from_numpy(np.asarray(starts, dtype=np.int64)))
        batches.append((codes, labels, torch.from_numpy(np.array(masks))))
    trial_hp = [vmapped.trial_hyperparams(hp_np, i) for i in range(n_trials)]
    opt = fleet_optimizer(optimizer, [(m.parameters(), trial_hp[i])
                                      for i, m in enumerate(models)])
    losses = vmapped.fleet_step(models, opt, batches, active)
    assert losses[1] is None
    for i in np.flatnonzero(active):
        assert abs(losses[i].item() - float(jax_losses[i])) <= 1e-5
    for i, model_i in enumerate(models):
        trial_want = params_from_jax(
            jax.tree.map(lambda a, i=i: np.asarray(a[i]), want))
        before = params_from_jax(
            jax.tree.map(lambda a, i=i: np.asarray(a[i]), host))
        for key, value in model_i.params().items():
            got = value.detach()
            if active[i]:
                np.testing.assert_allclose(got.numpy(),
                                           trial_want[key].numpy(),
                                           atol=1e-5, err_msg=key)
            else:
                assert torch.equal(got, before[key]), key
        if active[i]:
            assert not torch.equal(model_i.params()["dense.kernel"],
                                   before["dense.kernel"])


def test_parallel_trials_match_varying_lr(tmp_path):
    """``tests/test_hpo.py:181-195`` on the port: the near-zero learning
    rate barely learns, the real one wins."""
    options = base_options(tmp_path, n_epochs=3, n_batches=4)
    results = vmapped.run_parallel_trials(
        options, [{"learning_rate": 0.01}, {"learning_rate": 1e-6}],
        make_tiny_data(0), make_tiny_data(1), seed=0, device="cpu")
    assert len(results) == 2
    for result in results:
        assert np.isfinite(result["val_loss"])
        assert result["params"]["dense.kernel"].shape == (4, 3)
        assert len(result["val_history"]) == 3
    assert results[0]["val_loss"] < results[1]["val_loss"]


def test_parallel_trials_freeze_converged(tmp_path):
    """``tests/test_hpo.py:198-228`` on the port: each trial stops
    ``early_stopping_th`` epochs after its last improvement of the
    validation loss (recomputed here from its history), the fleet stops
    long before ``n_epochs``, and the trial with learning rate 0 keeps its
    initial parameters as its best.  (The validation batch changes every
    epoch, so even that trial's loss can improve by chance.)"""
    options = base_options(tmp_path, n_epochs=50, n_batches=2,
                           early_stopping_th=2)
    results = vmapped.run_parallel_trials(
        options, [{"learning_rate": 0.01}, {"learning_rate": 0.0}],
        make_tiny_data(0), make_tiny_data(1), seed=0, device="cpu")
    for result in results:
        best, since = np.inf, 0
        for epoch, loss in enumerate(result["val_history"], 1):
            if loss < best:
                best, since = loss, 0
            else:
                since += 1
            if since >= options.early_stopping_th:
                break
        assert result["stopped_epoch"] == epoch < options.n_epochs
        assert result["val_loss"] == best
        assert len(result["val_history"]) == max(r["stopped_epoch"]
                                                 for r in results)
    config = ModelConfig.from_options(options)
    init = init_params(config, torch.Generator().manual_seed(
        vmapped._trial_seed(0, 0, 1)))
    for key, value in init.items():
        assert torch.equal(results[1]["params"][key], value), key


def test_parallel_trials_reject_shape_keys(tmp_path):
    with pytest.raises(ValueError, match="can only vary"):
        vmapped.run_parallel_trials(
            base_options(tmp_path), [{"vecsize": 30}, {"vecsize": 30}],
            make_tiny_data(0), make_tiny_data(1), device="cpu")


def test_bucketed_sweep_covers_shape_dimensions(tmp_path):
    """``tests/test_hpo.py:257-297`` on the port: vecsize, units and
    repeat_probability vary across proposals; same-shape trials train as
    one fleet; every proposal is recorded with the serial schema; a
    second call resumes."""
    sp = {
        "vecsize": space.qnormal("vecsize", 20, 3, 2),
        "units": space.qnormal("units", 6, 2, 2),
        "learning_rate": space.lognormal("learning_rate", -4, 0.5),
        "dropout": space.uniform("dropout", 0, 0.2),
        "repeat_probability": space.uniform("repeat_probability", 0.1, 0.45),
    }
    options = base_options(tmp_path, n_epochs=5, n_batches=8, batch_size=16)
    trials = run_bucketed_sweep(sp, options, make_tiny_data(0),
                                make_tiny_data(1), step_size=10,
                                project_root_dir=str(tmp_path), max_evals=5,
                                batch_evals=5, seed=3, device="cpu")
    assert len(trials) == 5
    keys = {shape_bucket_key(options, t["params"]) for t in trials.trials}
    assert len(keys) > 1
    ok = [t for t in trials.trials if t["result"]["status"] == STATUS_OK]
    assert ok, "no trial succeeded"
    for t in ok:
        assert np.isfinite(t["result"]["loss"])
        assert t["result"]["options"]["vecsize"] == int(
            t["params"]["vecsize"])
        assert os.path.exists(
            os.path.join(t["result"]["logdir"], "hparams.json"))
    trials = run_bucketed_sweep(sp, options, make_tiny_data(0),
                                make_tiny_data(1), step_size=10,
                                project_root_dir=str(tmp_path), max_evals=2,
                                batch_evals=2, seed=4, device="cpu")
    assert len(trials) == 7
