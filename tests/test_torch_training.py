"""The port's training slice (sampler, optimizers, train step, Trainer,
checkpoints, label preprocessing, ``train`` CLI) against the JAX package.

Data come from a numpy seed and go to both sides.  The JAX recurrence runs
the trainable Pallas kernels in interpret mode with explicit masks, as
``tests/test_pallas_train.py`` runs them on the CPU.  Tolerances are
stated per test.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.data import preprocess as jax_preprocess  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.models.pallas_rnn_train import (  # noqa: E402
    pallas_gru_avg_train, pallas_lstm_avg_train)
from deepgrp_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from deepgrp_tpu.train import optimizers as jax_optimizers  # noqa: E402
from deepgrp_tpu.train import sampler as jax_sampler  # noqa: E402
from deepgrp_tpu.train.training import (  # noqa: E402
    categorical_crossentropy as jax_cce, codes_from_onehot_rows)
from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data import preprocess  # noqa: E402
from deepgrp_tpu_torch.models import cuda_rnn, rnn  # noqa: E402
from deepgrp_tpu_torch.models.convert import (params_from_jax,  # noqa: E402
                                              params_to_jax)
from deepgrp_tpu_torch.models.keras_io import load_model  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig, init_params)
from deepgrp_tpu_torch.train import checkpoint, sampler  # noqa: E402
from deepgrp_tpu_torch.train.optimizers import get_optimizer  # noqa: E402
from deepgrp_tpu_torch.train.training import (Trainer,  # noqa: E402
                                              categorical_crossentropy,
                                              train_step, training)


def make_data(length=2000, seed=0):
    """Learnable data (``tests/test_training.py:15-29``): class-1 regions
    are poly-A runs, class-2 regions poly-C runs, background random."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length)
    truelbl = np.zeros((3, length), dtype=np.int8)
    for start in range(100, length - 200, 400):
        codes[start:start + 100] = 0
        truelbl[1, start:start + 100] = 1
        codes[start + 200:start + 260] = 1
        truelbl[2, start + 200:start + 260] = 1
    truelbl[0] = truelbl[1:].sum(axis=0) == 0
    fwd = np.zeros((5, length), dtype=np.int8)
    fwd[codes, np.arange(length)] = 1
    return preprocess.Data(fwd=fwd, truelbl=truelbl)


def small_options(**kwargs):
    base = dict(vecsize=20, units=8, batch_size=16, n_epochs=4, n_batches=8,
                early_stopping_th=10, dropout=0.0, repeats_to_search=[1, 2],
                learning_rate=0.01)
    base.update(kwargs)
    return Options(**base)


# -- config -------------------------------------------------------------------


def test_options_match_jax():
    assert Options().todict() == JaxOptions().todict()
    opts = Options(gru_units=12, gru_dropout=0.5)
    assert (opts.units, opts.dropout) == (12, 0.5)
    assert opts["gru_units"] == 12


def test_options_toml_round_trip(tmp_path):
    path = tmp_path / "p.toml"
    with open(path, "w") as fh:
        Options(vecsize=342, units=60, attention=True).to_toml(fh)
    with open(path) as fh:
        got = Options.from_toml(fh)
    with open(path) as fh:
        want = JaxOptions.from_toml(fh)
    assert got.todict() == want.todict()
    assert (got.vecsize, got.units, got.attention) == (342, 60, True)


# -- sampler ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calc_indices_equals_jax(seed):
    rng = np.random.default_rng(seed)
    array = (rng.random(500) < 0.05).astype(np.int8)
    np.testing.assert_array_equal(sampler.calc_indices(array.copy(), 17),
                                  jax_sampler.calc_indices(array.copy(), 17))


def test_codes_from_onehot_rows_equals_jax():
    data = make_data(300)
    fwd = data.fwd.copy()
    fwd[:, 10:20] = 0  # hard-masked positions -> pad code
    fwd[:, 30] = 0
    fwd[4, 30] = 1  # N
    want = np.asarray(codes_from_onehot_rows(jnp.asarray(fwd.T)))
    got = sampler.codes_from_onehot_rows(fwd)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_sampler_class_quotas():
    """Exact per-class quotas (counterpart of test_training.py:47-72)."""
    options = small_options(batch_size=32, repeat_probability=0.4)
    data = make_data()
    smp = sampler.BatchSampler(options, data, "cpu")
    jax_smp = jax_sampler.BatchSampler(JaxOptions(**options.todict()), data)
    assert smp.one_class_size == jax_smp.one_class_size == 6
    assert smp.n_sampled_classes == jax_smp.n_sampled_classes == 2
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(3)
    n_batches = 50
    for _ in range(n_batches):
        starts = smp.sample_starts(gen).numpy()
        assert starts.shape == (32,)
        assert starts.min() >= 0
        assert starts.max() <= data.fwd.shape[1] - options.vecsize
        for s in starts:
            window = data.truelbl[:, s:s + 20]
            for c in (1, 2):
                counts[c] += window[c].any()
    assert counts[1] / n_batches >= smp.one_class_size
    assert counts[2] / n_batches >= smp.one_class_size


def test_sampler_gather_layout():
    """Window gathers are index arithmetic (test_training.py:75-84)."""
    options = small_options(batch_size=8)
    data = make_data()
    smp = sampler.BatchSampler(options, data, "cpu")
    gen = torch.Generator().manual_seed(1)
    starts = smp.sample_starts(gen)
    codes, labels = smp.gather(starts)
    assert codes.dtype == torch.int8 and codes.shape == (8, 20)
    assert labels.dtype == torch.float32 and labels.shape == (8, 20, 3)
    torch.testing.assert_close(labels.sum(-1), torch.ones(8, 20))
    track = sampler.codes_from_onehot_rows(data.fwd)
    for row, s in enumerate(starts.tolist()):
        np.testing.assert_array_equal(codes[row].numpy(), track[s:s + 20])
        np.testing.assert_array_equal(labels[row].numpy(),
                                      data.truelbl[:, s:s + 20].T)
    again = smp.sample_starts(torch.Generator().manual_seed(1))
    assert torch.equal(starts, again)


# -- optimizers ---------------------------------------------------------------


@pytest.mark.parametrize("name,momentum", [("RMSprop", 0.9),
                                           ("RMSprop", 0.0),
                                           ("Adam", 0.9), ("sgd", 0.9)])
def test_optimizer_matches_optax(name, momentum):
    """5 steps on the same gradients (with an input row whose gradient is
    always 0, where epsilon's place matters): atol 1e-6."""
    opts = Options(optimizer=name, momentum=momentum, learning_rate=0.01)
    rng = np.random.default_rng(4)
    start = rng.normal(size=(5, 12)).astype(np.float32)
    grads = rng.normal(size=(5, 5, 12)).astype(np.float32)
    grads[:, 4] = 0.0
    grads[:, 3] *= 1e-6
    jax_opt = jax_optimizers.get_optimizer(JaxOptions(**opts.todict()))
    params = {"w": jnp.asarray(start)}
    state = jax_opt.init(params)
    weight = torch.nn.Parameter(torch.from_numpy(start.copy()))
    opt = get_optimizer(opts, [weight])
    for grad in grads:
        updates, state = jax_opt.update({"w": jnp.asarray(grad)}, state,
                                        params)
        params = optax.apply_updates(params, updates)
        weight.grad = torch.from_numpy(grad.copy())
        opt.step()
    np.testing.assert_allclose(weight.detach().numpy(),
                               np.asarray(params["w"]), atol=1e-6)


def test_optimizer_unknown_name_raises():
    with pytest.raises(ValueError, match="nope"):
        get_optimizer(Options(optimizer="nope"), [torch.nn.Parameter(
            torch.zeros(1))])


# -- train step ---------------------------------------------------------------


def _steps_against_jax(options, params, windows):
    """The optimization steps of the port (CPU: plain versions) and of
    the JAX package's own functions on ``windows`` from ``params``: each
    side's losses, final parameters and gradients of every step (the
    port's keys)."""
    config = ModelConfig.from_options(options)
    jax_config = jax_model.ModelConfig(**config.todict())
    fn = (pallas_lstm_avg_train if config.rnn == "LSTM"
          else pallas_gru_avg_train)
    jax_opt = jax_optimizers.get_optimizer(JaxOptions(**options.todict()))
    state = jax_opt.init(params)
    jax_params = params
    jax_losses, jax_grads = [], []
    for codes, labels, masks in windows:
        def loss_fn(p, codes=codes, labels=labels, masks=masks):
            avg, hidden = fn(p["rnn"], jnp.asarray(codes.astype(np.int32)),
                             jnp.asarray(masks), True)
            logits = jax_model._head_logits(p, avg, hidden, jax_config,
                                            "highest")
            return jax_cce(
                logits, jnp.asarray(labels))

        loss, grads = jax.value_and_grad(loss_fn)(jax_params)
        updates, state = jax_opt.update(grads, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        jax_losses.append(float(loss))
        jax_grads.append(params_from_jax(grads))

    model = DeepGRPModel.from_params(config, params_from_jax(params), "cpu")
    opt = get_optimizer(options, model.parameters())
    losses, grads = [], []
    for c, y, m in windows:
        losses.append(train_step(model, opt, torch.from_numpy(c),
                                 torch.from_numpy(y),
                                 torch.from_numpy(m)).item())
        grads.append({k: v.grad.detach().clone()
                      for k, v in model.params().items()})
    return ((jax_losses, params_from_jax(jax_params), jax_grads),
            (losses, model.params(), grads))


@pytest.mark.parametrize("rnn_type,attention,units,epsilon,rerun_steps", [
    pytest.param("GRU", True, 6, None, 0, id="GRU-True"),
    pytest.param("LSTM", False, 6, None, 0, id="LSTM-False"),
    pytest.param("GRU", True, 136, None, 0, id="GRU-True-u136"),
    pytest.param("LSTM", False, 300, 1e-6, 3, id="LSTM-False-u300"),
    pytest.param("GRU", True, 4160, 1e-6, 2, id="GRU-True-u4160")])
def test_train_step_matches_jax(rnn_type, attention, units, epsilon,
                                rerun_steps):
    """3 optimization steps of the port (CPU: plain versions) against 3
    steps composed from the JAX package's own functions, from the same
    initial parameters on the same windows and masks: loss and parameters
    at atol 1e-5; also at u=136, a width of the training kernels' wide
    layout, at u=300, one of their cluster tile, and at u=4160, one of
    their grid tile (past u=4096).  At u=300 some of U's
    360,000 gradient entries lie within RMSprop's default epsilon (1e-10)
    of 0, where the float32 rounding of their sums over the batch and the
    steps (4e-10, 7e-7 of the gradient's largest magnitude) divided by
    sqrt(v) + epsilon moves the parameter by 4e-5; that case (and u=4160)
    takes epsilon 1e-6, so the steps read the gradients' agreement and not
    that division, and runs ``rerun_steps`` of the steps again with the
    default epsilon: the losses at atol 1e-5 and every step's gradients
    (those after the default optimizer's first steps included) within 1e-4
    of their largest magnitude.  At u=4160 (52 million entries of U) that
    division, after two default steps, already moves the parameters by
    1.7e-4 and the third step's gradients by 1.5e-4 of their largest
    magnitude, so its rerun compares the first two steps."""
    extra = {} if epsilon is None else {"epsilon": epsilon}
    options = small_options(units=units, batch_size=4, rnn=rnn_type,
                            attention=attention, dropout=0.0928, **extra)
    config = ModelConfig.from_options(options)
    jax_config = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(3), jax_config)
    rng = np.random.default_rng(9)
    batch, steps, gates = 4, options.vecsize, config.gates
    keep = 1.0 - options.dropout
    windows = []
    for _ in range(3):
        codes = rng.integers(0, 6, size=(batch, steps)).astype(np.int8)
        labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3,
                                                          (batch, steps))]
        masks = ((rng.random((gates, 2 * batch, 5)) < keep)
                 / keep).astype(np.float32)
        windows.append((codes, labels, masks))

    (jax_losses, want, _), (losses, got, _) = _steps_against_jax(
        options, params, windows)
    np.testing.assert_allclose(losses, jax_losses, atol=1e-5)
    for key, value in got.items():
        np.testing.assert_allclose(value.detach().numpy(), want[key].numpy(),
                                   atol=1e-5, err_msg=key)
    if epsilon is None:
        return
    default = small_options(units=units, batch_size=4, rnn=rnn_type,
                            attention=attention, dropout=0.0928)
    (jax_losses, _, jax_grads), (losses, _, grads) = _steps_against_jax(
        default, params, windows[:rerun_steps])
    np.testing.assert_allclose(losses, jax_losses, atol=1e-5)
    for step, (got_g, want_g) in enumerate(zip(grads, jax_grads)):
        for key, value in got_g.items():
            scale = want_g[key].abs().max().item()
            err = (value - want_g[key]).abs().max().item()
            assert err <= 1e-4 * scale, (step, key, err, scale)


@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_scan_train_step_matches_jax(rnn_type, attention):
    """Two scan-route steps of the port (``train_step(..., fused=False)``:
    one-hot windows through ``forward_logits(..., train=True)``, autograd
    through the plain loop) against the JAX package's scan-route step
    (``_train_step`` with ``fused=False``), from the same parameters: the
    port is fed the windows at the starts that the JAX step samples and
    the masks of its ``_input_dropout_masks`` for the step's key.  Losses
    and parameters at atol 1e-5.  The fused step (the training kernels'
    plain versions) on the same windows agrees at atol 1e-5 too."""
    import importlib

    from deepgrp_tpu.models import rnn as jax_rnn

    # The package's __init__ exports a function of the module's name.
    jax_training = importlib.import_module("deepgrp_tpu.train.training")

    options = small_options(units=6, batch_size=6, rnn=rnn_type,
                            attention=attention, dropout=0.0928)
    jax_options = JaxOptions(**options.todict())
    data = make_data(seed=3)
    model = jax_model.create_model(jax_options)
    params = model.init(jax.random.PRNGKey(5))
    jax_opt = jax_optimizers.get_optimizer(jax_options)
    state = jax_opt.init(params)
    sampler_j = jax_sampler.BatchSampler(jax_options, data)
    static = (sampler_j.n_sampled_classes, sampler_j.one_class_size,
              sampler_j.batch_size, sampler_j.seq_len)
    config = ModelConfig.from_options(options)
    port = {fused: DeepGRPModel.from_params(config, params_from_jax(params),
                                            "cpu")
            for fused in (False, True)}
    opts = {fused: get_optimizer(options, port[fused].parameters())
            for fused in port}
    port_sampler = sampler.BatchSampler(options, data, "cpu")
    key = jax.random.PRNGKey(12)
    for _ in range(2):
        key, step_key = jax.random.split(key)
        jax_params = jax.tree.map(jnp.array, params)
        params, state, jax_loss = jax_training._train_step(
            jax_params, state, step_key, sampler_j._fwd, sampler_j._lbl,
            sampler_j._candidates, sampler_j._lengths, static, model,
            jax_opt, options.vecsize, fused=False)
        key_sample, key_dropout = jax.random.split(step_key)
        starts = jax_sampler._sample_starts(
            key_sample, sampler_j._candidates, sampler_j._lengths, *static,
            options.vecsize)
        masks = torch.from_numpy(np.array(jax_rnn._input_dropout_masks(
            key_dropout, (2 * options.batch_size, 5), options.dropout,
            config.gates, jnp.float32)))
        codes, labels = port_sampler.gather(
            torch.from_numpy(np.asarray(starts, dtype=np.int64)))
        for fused in port:
            loss = train_step(port[fused], opts[fused], codes, labels, masks,
                              fused=fused)
            assert abs(loss.item() - float(jax_loss)) <= 1e-5, fused
    want = params_from_jax(jax.device_get(params))
    for fused in port:
        for key_name, value in port[fused].params().items():
            np.testing.assert_allclose(value.detach().numpy(),
                                       want[key_name].numpy(), atol=1e-5,
                                       err_msg=f"{key_name} fused={fused}")


def test_scan_forward_takes_no_kernel_and_checks_its_inputs():
    """The training form runs the plain loop (no kernel, no plain-version
    call of ``gru_seq``), is differentiable, and refuses masks outside
    training."""
    from deepgrp_tpu_torch.models.model import forward_logits

    config = ModelConfig(vecsize=8, units=4, attention=True)
    model = DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(1)), "cpu")
    x = torch.eye(5)[torch.randint(0, 5, (3, 8))]
    masks = torch.ones(3, 6, 5)
    rnn.PLAIN_CALLS.reset()
    logits = model.apply_logits(x, masks=masks, train=True)
    assert logits.requires_grad and rnn.PLAIN_CALLS.snapshot() == {}
    logits.sum().backward()
    assert model.rnn.recurrent.grad is not None
    torch.testing.assert_close(
        logits.detach(), model.apply_logits(x), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="train=True"):
        forward_logits(model.params(), x, config, masks=masks)


def test_metrics_writer_events_equal_jax_bytes(tmp_path, monkeypatch):
    """``MetricsWriter(tensorboard=True)`` writes an events file whose
    bytes equal those the JAX package's ``EventFileWriter`` writes for the
    same tags, values, steps and wall times (the clock is fixed)."""
    import time as time_module

    from deepgrp_tpu.utils.tb_events import EventFileWriter as JaxWriter
    from deepgrp_tpu_torch.train.training import MetricsWriter

    monkeypatch.setattr(time_module, "time", lambda: 1700000000.25)
    records = [(1, {"loss": 0.5, "val_loss": 0.75}),
               (2, {"loss": 0.25, "val_loss": 0.5}), (0, {"hpo/MCC": -0.1})]
    writer = MetricsWriter(tmp_path / "port", tensorboard=True)
    for step, metrics in records:
        writer.write(step, metrics)
    writer.close()
    jax_writer = JaxWriter(tmp_path / "jax")
    for step, metrics in records:
        for tag, value in metrics.items():
            jax_writer.add_scalar(tag, value, step)
    jax_writer.close()

    def events(directory):
        (name,) = [p for p in directory.iterdir()
                   if p.name.startswith("events.out.tfevents")]
        return name.name, name.read_bytes()

    port_name, port_bytes = events(tmp_path / "port")
    jax_name, jax_bytes = events(tmp_path / "jax")
    assert port_name == jax_name and port_bytes == jax_bytes
    lines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2, 0]
    writer = MetricsWriter(tmp_path / "plain")
    writer.write(1, {"loss": 1.0})
    writer.close()
    assert os.listdir(tmp_path / "plain") == ["metrics.jsonl"]


def test_tb_events_crc32c_known_vectors():
    """The RFC 3720 vectors of ``tests/test_tb_events.py:14`` hold for the
    port's copy."""
    from deepgrp_tpu_torch.utils.tb_events import _crc32c

    assert _crc32c(b"") == 0x0
    assert _crc32c(b"123456789") == 0xE3069283
    assert _crc32c(bytes([0] * 32)) == 0x8A9136AA


def test_categorical_crossentropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 5)).astype(np.float32) * 3
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, 7))]
    want = float(jax_cce(jnp.asarray(logits),
                                                       jnp.asarray(labels)))
    got = categorical_crossentropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels)).item()
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_init_params_shapes_match_jax(rnn_type, attention):
    config = ModelConfig(vecsize=20, units=6, rnn=rnn_type,
                         attention=attention)
    got = init_params(config, torch.Generator().manual_seed(0))
    want = params_from_jax(jax_model.init_params(
        jax.random.PRNGKey(0), jax_model.ModelConfig(**config.todict())))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert torch.equal(got["dense.bias"], want["dense.bias"])


# -- Trainer ------------------------------------------------------------------


def test_trainer_learns_and_writes(tmp_path):
    options = small_options(attention=True, dropout=0.1)
    best, history = training((make_data(seed=0), make_data(seed=1)),
                             options, logdir=tmp_path, device="cpu")
    assert len(history["loss"]) == 4
    assert history["loss"][-1] < history["loss"][0]
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    for record in records:
        assert {"step", "time", "loss", "val_loss",
                "epoch_seconds"} <= set(record)
    latest = checkpoint.CheckpointManager(tmp_path).latest_path()
    assert latest is not None
    best_epoch = int(np.argmin(history["val_loss"])) + 1
    assert os.path.basename(latest) == f"{best_epoch:02d}.npz"
    saved = params_from_jax(checkpoint.load_params(latest))
    for key, value in best.items():
        assert torch.equal(saved[key], value), key


def test_trainer_runs_plain_versions_on_cpu(tmp_path):
    options = small_options(n_epochs=1, n_batches=2, dropout=0.2)
    rnn.PLAIN_CALLS.reset()
    launches = cuda_rnn.LAUNCHES.snapshot()
    training((make_data(seed=0), make_data(seed=1)), options,
             logdir=tmp_path, device="cpu")
    calls = rnn.PLAIN_CALLS.snapshot()
    assert calls["gru_train_fwd"] == calls["gru_train_bwd"] == 2
    assert calls["gru_avg"] == 1  # the validation batch
    assert cuda_rnn.LAUNCHES.snapshot() == launches


def test_trainer_nan_guard_restores_best(tmp_path):
    options = small_options(n_epochs=5, n_batches=2)
    config = ModelConfig.from_options(options)
    params = init_params(config, torch.Generator().manual_seed(0))
    params["dense.bias"][0] = float("nan")
    model = DeepGRPModel(config, "cpu")
    trainer = Trainer(model, options, tmp_path)
    try:
        best, history = trainer.fit(make_data(), make_data(seed=1),
                                    params=params, stop_on_nan=True)
    finally:
        trainer.writer.close()
    assert history == {"loss": [], "val_loss": []}
    assert torch.isnan(best["dense.bias"][0])
    assert checkpoint.CheckpointManager(tmp_path).latest_path() is None


def test_trainer_stops_early_on_divergence(tmp_path):
    """test_training.py:212-220: a diverging run stops long before
    n_epochs (early stopping or the NaN guard)."""
    options = small_options(units=4, batch_size=8, n_epochs=50,
                            n_batches=2, early_stopping_th=2,
                            learning_rate=10.0)
    _, history = training((make_data(), make_data()), options,
                          logdir=tmp_path, device="cpu")
    assert len(history["loss"]) < 50


def test_trainer_resume_from_checkpoint(tmp_path):
    options = small_options(units=4, batch_size=8, n_epochs=2, n_batches=2)
    data = make_data()
    best1, _ = training((data, data), options, logdir=tmp_path,
                        device="cpu")
    # n_epochs=0: the run returns the parameters it started from.
    trainer = Trainer(DeepGRPModel(ModelConfig.from_options(options), "cpu"),
                      small_options(units=4, batch_size=8, n_epochs=0),
                      tmp_path)
    try:
        start, history = trainer.fit(data, data, seed=1, resume=True)
    finally:
        trainer.writer.close()
    assert history["loss"] == []
    for key, value in best1.items():
        assert torch.equal(start[key], value), key
    _, history2 = training((data, data), options, logdir=tmp_path,
                           device="cpu")
    assert len(history2["loss"]) == 2


# -- checkpoints and model files ----------------------------------------------


def test_checkpoints_interoperate_with_jax(tmp_path):
    config = ModelConfig(vecsize=20, units=5, attention=True)
    params = init_params(config, torch.Generator().manual_seed(2))
    port_path = checkpoint.CheckpointManager(tmp_path / "a").save(
        3, params_to_jax(params))
    assert os.path.basename(port_path) == "03.npz"
    from_port = params_from_jax(jax_checkpoint.load_params(port_path))
    jax_params = jax_model.init_params(
        jax.random.PRNGKey(1), jax_model.ModelConfig(**config.todict()))
    jax_checkpoint.CheckpointManager(tmp_path / "b").save(7, jax_params)
    from_jax = params_from_jax(
        checkpoint.latest_checkpoint_params(tmp_path / "b"))
    for key in params:
        assert torch.equal(from_port[key], params[key]), key
        np.testing.assert_array_equal(
            from_jax[key].numpy(),
            np.asarray(params_from_jax(jax_params)[key]))


# -- label preprocessing ------------------------------------------------------


BED = """chrA 10 30 1 extra
chrA 25 40 2 more columns
chrB 0 50 1
chrA 60 70 3
chrA 75 80 2
chrAB 0 100 1
"""


@pytest.mark.parametrize("chrom", ["chrA", "chrB", "chrC"])
def test_preprocess_y_equals_jax(tmp_path, chrom):
    path = tmp_path / "rep.bed"
    path.write_text(BED)
    got = preprocess.preprocess_y(path, chrom, 90, [1, 2])
    want = jax_preprocess.preprocess_y(path, chrom, 90, [1, 2])
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_drop_start_end_n_equals_jax():
    data = make_data(300)
    fwd = data.fwd.copy()
    fwd[:, :7] = 0
    fwd[4, :7] = 1  # leading Ns
    fwd[:, -5:] = 0
    fwd[4, -5:] = 1  # trailing Ns
    got = preprocess.drop_start_end_n(fwd, data.truelbl)
    want = jax_preprocess.drop_start_end_n(fwd, data.truelbl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] == 300 - 7 - 5 - 1  # the reference off-by-one


# -- CLI ----------------------------------------------------------------------


def write_training_files(tmp_path):
    toml = tmp_path / "params.toml"
    with open(toml, "w") as fh:
        Options(vecsize=20, units=4, attention=True, n_epochs=2,
                n_batches=2, dropout=0.1, repeats_to_search=[1, 2],
                learning_rate=0.01).to_toml(fh)
    bed_rows = []
    for chrom, seed in (("chrT", 0), ("chrV", 1)):
        data = make_data(800, seed)
        np.savez(tmp_path / f"{chrom}.fa.npz", fwd=data.fwd)
        for c in (1, 2):
            edges = np.flatnonzero(np.diff(np.r_[0, data.truelbl[c], 0]))
            for begin, end in zip(edges[::2], edges[1::2]):
                bed_rows.append(f"{chrom}\t{begin}\t{end}\t{c}\tx\n")
    bed_rows.append("chrOther\t0\t100\t1\n")
    (tmp_path / "rep.bed").write_text("".join(bed_rows))
    return [str(toml), str(tmp_path / "chrT.fa.npz"),
            str(tmp_path / "chrV.fa.npz"), str(tmp_path / "rep.bed")]


def test_cli_train_then_predict_on_cpu(tmp_path):
    model_path = tmp_path / "model.npz"
    cli.main(["--device", "cpu", "-b", "8", "train",
              *write_training_files(tmp_path), "--honor-toml",
              "--logdir", str(tmp_path / "log"),
              "--modelfile", str(model_path)])
    config, _ = load_model(str(model_path))
    assert (config.vecsize, config.units, config.attention) == (20, 4, True)
    assert (tmp_path / "log" / "metrics.jsonl").exists()
    seq = "".join(np.random.default_rng(0).choice(list("ACGT"), 400))
    fasta = tmp_path / "in.fa"
    fasta.write_text(">r1\n" + seq + "\n")
    out = tmp_path / "out.bed"
    cli.main(["--device", "cpu", "predict", str(model_path), str(fasta),
              "--output", str(out)])
    for line in out.read_text().splitlines():
        fields = line.split("\t")
        assert fields[:2] == [str(fasta), "r1"]
        assert int(fields[4]) > 0


@pytest.mark.parametrize("route,tensorboard", [("scan", True),
                                               ("fused", False)])
def test_cli_train_routes_and_tensorboard(tmp_path, route, tensorboard):
    """``train --rnn-kernel scan`` trains through the scan route (no
    kernel's plain version runs in its steps; the validation takes the
    inference kernel's); ``--tensorboard`` (the default) writes an events
    file and ``--no-tensorboard`` none."""
    model_path = tmp_path / "model.npz"
    rnn.PLAIN_CALLS.reset()
    cli.main(["--device", "cpu", "-b", "8", "--rnn-kernel", route, "train",
              *write_training_files(tmp_path), "--honor-toml",
              "--logdir", str(tmp_path / "log"),
              "--modelfile", str(model_path),
              "--tensorboard" if tensorboard else "--no-tensorboard"])
    calls = rnn.PLAIN_CALLS.snapshot()
    if route == "scan":
        assert set(calls) == {"gru_avg"}
    else:
        assert calls["gru_train_fwd"] == calls["gru_train_bwd"] > 0
    events = [p for p in os.listdir(tmp_path / "log")
              if p.startswith("events.out.tfevents")]
    assert len(events) == (1 if tensorboard else 0)
    records = (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()
    assert all(math.isfinite(json.loads(r)["loss"]) for r in records)
    assert load_model(str(model_path))[0].vecsize == 20


def test_cli_train_without_honor_toml_takes_defaults(tmp_path):
    """The reference precedence quirk: the CLI defaults overwrite the
    TOML (vecsize and units fall back to 150 and 32)."""
    files = write_training_files(tmp_path)
    with open(files[0]) as fh:
        parameter = Options.from_toml(fh)
    parameter.fromdict(Options(batch_size=8).todict())
    assert (parameter.vecsize, parameter.units) == (150, 32)


def test_cli_train_refuses_h5_output(tmp_path, monkeypatch):
    """Without ``h5py`` an ``.h5`` model cannot be written: ``train``
    raises ``ImportError`` naming it before it loads any data (nothing is
    trained, no log directory made, no ``.npz`` written instead)."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        cli.main(["--device", "cpu", "train",
                  *write_training_files(tmp_path), "--logdir",
                  str(tmp_path / "log"), "--modelfile",
                  str(tmp_path / "m.h5")])
    assert not (tmp_path / "log").exists()
    assert not list(tmp_path.glob("m.*"))


def test_cli_train_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train", *write_training_files(tmp_path),
                  "--logdir", str(tmp_path / "log")])
