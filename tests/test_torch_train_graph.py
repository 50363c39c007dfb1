"""The training step as a captured CUDA graph, on the CPU.

On the card ``Trainer.fit``, ``run_parallel_trials`` and the HPO sweeps
built on them capture the optimization step once and replay it
(``deepgrp_tpu_torch/train/step_graph.py``); ``tests/test_torch_cuda.py``
holds the captured runs against the eager ones bit for bit there.  On the
CPU nothing is captured: the same step functions run eagerly.  Here:

* the restructured eager epoch (:class:`EpochLoop`, the step function the
  card captures, with its static loss buffer) and ``Trainer.fit`` equal
  bit for bit a copy of the per-step loop they replaced, on the same
  sampler and generator seed: losses, history, parameters, optimizer state
  and the generator's state;
* a 3-step epoch on given windows and masks equals the JAX package's
  ``_train_step`` chain at atol 1e-5 (``test_train_step_matches_jax``'s
  tolerance);
* the fleet with a trial frozen mid-run equals the loop it replaced bit
  for bit;
* asking to capture on the CPU raises; the launch counters' recording.
"""

import importlib
import math
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.models import rnn as jax_rnn  # noqa: E402
from deepgrp_tpu.train import optimizers as jax_optimizers  # noqa: E402
from deepgrp_tpu.train import sampler as jax_sampler  # noqa: E402
from deepgrp_tpu_torch import _build  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.preprocess import Data  # noqa: E402
from deepgrp_tpu_torch.hpo import vmapped  # noqa: E402
from deepgrp_tpu_torch.models import rnn  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import (  # noqa: E402
    COMPLEMENT_PERM, DeepGRPModel, ModelConfig, forward_logits_from_codes,
    init_params, reverse_complement)
from deepgrp_tpu_torch.train.optimizers import (  # noqa: E402
    fleet_optimizer, get_optimizer)
from deepgrp_tpu_torch.train.sampler import BatchSampler  # noqa: E402
from deepgrp_tpu_torch.train.step_graph import StepGraph  # noqa: E402
from deepgrp_tpu_torch.train.training import (  # noqa: E402
    EpochLoop, Trainer, categorical_crossentropy, host_params, train_step)

# The package's __init__ exports a function of the module's name.
jax_training = importlib.import_module("deepgrp_tpu.train.training")

CASES = [(rnn_type, attention, dropout, fused)
         for rnn_type, attention in (("GRU", True), ("LSTM", False))
         for dropout in (0.0, 0.0928) for fused in (True, False)]


def make_data(length=2000, seed=0):
    """Class-1 regions poly-A, class-2 regions poly-C, background random
    (``tests/test_training.py:15-29``)."""
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
    return Data(fwd=fwd, truelbl=truelbl)


def small_options(**kwargs):
    base = dict(vecsize=20, units=8, batch_size=16, n_epochs=3, n_batches=4,
                early_stopping_th=10, repeats_to_search=[1, 2],
                learning_rate=0.01)
    base.update(kwargs)
    return Options(**base)


def assert_tensors_equal(got, want):
    """Bit for bit, through nested dicts, lists and tuples."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            assert_tensors_equal(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_tensors_equal(a, b)
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        assert got == want


def optimizer_state(optimizer):
    return [optimizer.state[p] for group in optimizer.param_groups
            for p in group["params"]]


# -- the single-device epoch --------------------------------------------------


def pre_loop_epoch(model, optimizer, sampler, generator, n_batches, rate,
                   fused):
    """The per-step loop ``Trainer.fit`` ran before the step was captured:
    its step losses and their mean."""
    config = model.config
    losses = []
    for _ in range(n_batches):
        codes, labels = sampler.batch(generator)
        masks = (rnn.input_dropout_masks(generator, 2 * sampler.batch_size,
                                         rate, config.gates)
                 if rate > 0.0 else None)
        losses.append(train_step(model, optimizer, codes, labels, masks,
                                 fused))
    return torch.stack(losses), torch.stack(losses).mean()


def run_setup(options, seed=0):
    config = ModelConfig.from_options(options)
    model = DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(seed)),
        "cpu")
    return (model, get_optimizer(options, model.parameters()),
            BatchSampler(options, make_data(seed=0), "cpu"),
            torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("rnn_type,attention,dropout,fused", CASES)
def test_eager_epoch_equals_the_pre_loop(rnn_type, attention, dropout,
                                         fused):
    """Two epochs of :class:`EpochLoop` (the step the card captures,
    eager here) against two epochs of the loop it replaced, from the same
    parameters, sampler and generator seed: step losses, epoch means,
    parameters, optimizer state and generator state bit for bit."""
    options = small_options(rnn=rnn_type, attention=attention,
                            dropout=dropout)
    model, optimizer, sampler, generator = run_setup(options)
    ref = run_setup(options)
    rows, gates = 2 * sampler.batch_size, model.config.gates

    def step():
        codes, labels = sampler.batch(generator)
        masks = (rnn.input_dropout_masks(generator, rows, dropout, gates)
                 if dropout > 0.0 else None)
        return train_step(model, optimizer, codes, labels, masks, fused)

    loop = EpochLoop(step, options.n_batches, "cpu")
    for _ in range(2):
        mean = loop.epoch()
        want_losses, want_mean = pre_loop_epoch(*ref, options.n_batches,
                                                dropout, fused)
        assert torch.equal(loop.losses, want_losses)
        assert torch.equal(mean, want_mean)
        assert_tensors_equal(model.params(), ref[0].params())
        assert_tensors_equal(optimizer_state(optimizer),
                             optimizer_state(ref[1]))
        assert torch.equal(generator.get_state(), ref[3].get_state())


def pre_loop_fit(options, train_data, val_data, seed, fused):
    """``Trainer.fit``'s single-device loop before the step was captured
    (no checkpoints; ``early_stopping_th`` above ``n_epochs``):
    ``(best parameters, history, generator)``."""
    config = ModelConfig.from_options(options)
    model = DeepGRPModel(config, "cpu")
    model.load_state_dict(init_params(config,
                                      torch.Generator().manual_seed(seed)))
    optimizer = get_optimizer(options, model.parameters())
    generator = torch.Generator().manual_seed(seed)
    train_sampler = BatchSampler(options, train_data, "cpu")
    val_sampler = BatchSampler(options, val_data, "cpu")
    history = {"loss": [], "val_loss": []}
    best_val, best_params = math.inf, host_params(model)
    for _ in range(options.n_epochs):
        _, mean = pre_loop_epoch(model, optimizer, train_sampler, generator,
                                 options.n_batches, float(config.dropout),
                                 fused)
        with torch.no_grad():
            codes, labels = val_sampler.gather(
                val_sampler.sample_starts(generator))
            val_loss = categorical_crossentropy(forward_logits_from_codes(
                model.params(), codes, config), labels).item()
        history["loss"].append(mean.item())
        history["val_loss"].append(val_loss)
        if val_loss < best_val:
            best_val, best_params = val_loss, host_params(model)
    return best_params, history, generator


@pytest.mark.parametrize("rnn_type,attention,dropout,fused", CASES)
def test_trainer_fit_equals_the_pre_loop(tmp_path, rnn_type, attention,
                                         dropout, fused):
    """``Trainer.fit`` on the CPU (eager: nothing is captured there)
    against the loop it replaced: history, best parameters and the
    generator's state bit for bit."""
    options = small_options(rnn=rnn_type, attention=attention,
                            dropout=dropout)
    train_data, val_data = make_data(seed=0), make_data(seed=1)
    model = DeepGRPModel(ModelConfig.from_options(options), "cpu")
    trainer = Trainer(model, options, tmp_path, tensorboard=False,
                      rnn_kernel="fused" if fused else "scan")
    assert trainer.capture is False
    try:
        best, history = trainer.fit(train_data, val_data, seed=4)
    finally:
        trainer.writer.close()
    want_best, want_history, want_gen = pre_loop_fit(options, train_data,
                                                     val_data, 4, fused)
    assert history == want_history
    assert_tensors_equal(best, want_best)
    assert torch.equal(trainer.generator.get_state(), want_gen.get_state())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_epoch_matches_jax_train_step_chain(rnn_type, attention, fused):
    """A 3-step :class:`EpochLoop` on given windows and masks (the windows
    at the starts the JAX step samples, the masks of its
    ``_input_dropout_masks`` for the step's key) against three JAX
    ``_train_step`` calls (the scan route) from the same parameters: each
    step's loss, the epoch's mean and the parameters at atol 1e-5."""
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
    port = DeepGRPModel.from_params(config, params_from_jax(params), "cpu")
    port_sampler = BatchSampler(options, data, "cpu")
    key = jax.random.PRNGKey(12)
    windows, jax_losses = [], []
    for _ in range(3):
        key, step_key = jax.random.split(key)
        jax_params = jax.tree.map(jnp.array, params)
        params, state, jax_loss = jax_training._train_step(
            jax_params, state, step_key, sampler_j._fwd, sampler_j._lbl,
            sampler_j._candidates, sampler_j._lengths, static, model,
            jax_opt, options.vecsize, fused=False)
        jax_losses.append(float(jax_loss))
        key_sample, key_dropout = jax.random.split(step_key)
        starts = jax_sampler._sample_starts(
            key_sample, sampler_j._candidates, sampler_j._lengths, *static,
            options.vecsize)
        masks = torch.from_numpy(np.array(jax_rnn._input_dropout_masks(
            key_dropout, (2 * options.batch_size, 5), options.dropout,
            config.gates, jnp.float32)))
        codes, labels = port_sampler.gather(
            torch.from_numpy(np.asarray(starts, dtype=np.int64)))
        windows.append((codes, labels, masks))

    optimizer = get_optimizer(options, port.parameters())
    given = iter(windows)
    loop = EpochLoop(lambda: train_step(port, optimizer, *next(given),
                                        fused=fused), 3, "cpu")
    mean = loop.epoch()
    np.testing.assert_allclose(loop.losses.numpy(), jax_losses, atol=1e-5)
    assert abs(mean.item() - float(np.mean(jax_losses))) <= 1e-5
    want = params_from_jax(jax.device_get(params))
    for name, value in port.params().items():
        np.testing.assert_allclose(value.detach().numpy(),
                                   want[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_reverse_complement_equals_the_index_form():
    """The slice form (no index tensor from the host) equals indexing by
    ``COMPLEMENT_PERM`` bit for bit."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 11, 5)).astype(np.float32))
    assert torch.equal(reverse_complement(x),
                       x.flip(-2)[..., list(COMPLEMENT_PERM)])


# -- the fleet ----------------------------------------------------------------


def fleet_options(tmp_path, **kwargs):
    base = dict(vecsize=20, units=4, batch_size=8, n_epochs=50, n_batches=2,
                early_stopping_th=2, dropout=0.0, repeats_to_search=[1, 2],
                project_root_dir=str(tmp_path))
    base.update(kwargs)
    return Options(**base)


def pre_loop_parallel_trials(options, trial_dicts, train_data, val_data,
                             seed):
    """``run_parallel_trials`` before its steps were captured: the same
    fleet, one ``fleet_step`` a step from a list comprehension."""
    n_trials = len(trial_dicts)
    config = ModelConfig.from_options(options)
    hp = vmapped.stack_trial_hyperparams(options, trial_dicts)
    trial_hp = [vmapped.trial_hyperparams(hp, i) for i in range(n_trials)]
    models = [DeepGRPModel.from_params(config, init_params(
        config, torch.Generator().manual_seed(
            vmapped._trial_seed(seed, 0, i))), "cpu")
        for i in range(n_trials)]
    optimizer = fleet_optimizer(
        str(options.optimizer),
        [(model.parameters(), trial_hp[i]) for i, model in enumerate(models)])
    generators = [torch.Generator().manual_seed(vmapped._trial_seed(
        seed, 0, i)) for i in range(n_trials)]
    val_generator = torch.Generator().manual_seed(vmapped._trial_seed(seed,
                                                                      1))
    train_sampler = BatchSampler(options, train_data, "cpu")
    val_sampler = BatchSampler(options, val_data, "cpu")
    rows = 2 * train_sampler.batch_size

    def batch(i):
        codes, labels = train_sampler.batch(generators[i])
        rate = trial_hp[i]["dropout"]
        masks = (rnn.input_dropout_masks(generators[i], rows, rate,
                                         config.gates)
                 if rate > 0.0 else None)
        return codes, labels, masks

    best_val = np.full(n_trials, np.inf)
    best_params = [host_params(model) for model in models]
    history = []
    patience = max(int(options.early_stopping_th), 1)
    since_best = np.zeros(n_trials, np.int64)
    stopped_epoch = np.zeros(n_trials, np.int64)
    for epoch in range(1, options.n_epochs + 1):
        active = since_best < patience
        for _ in range(options.n_batches):
            vmapped.fleet_step(models, optimizer,
                               [batch(i) if active[i] else None
                                for i in range(n_trials)], active)
        val_codes, val_labels = val_sampler.batch(val_generator)
        with torch.no_grad():
            val_losses = torch.stack([
                categorical_crossentropy(forward_logits_from_codes(
                    model.params(), val_codes, config), val_labels)
                for model in models]).cpu().numpy().astype(np.float64)
        history.append(val_losses)
        improved = (val_losses < best_val) & active
        since_best = np.where(improved, 0, since_best + active)
        stopped_epoch = np.where(active, epoch, stopped_epoch)
        for i in np.flatnonzero(improved):
            best_params[i] = host_params(models[i])
        best_val = np.where(improved, val_losses, best_val)
        if not (since_best < patience).any():
            break
    stacked = np.stack(history)
    return ([{"val_loss": float(best_val[i]),
              "val_history": stacked[:, i].tolist(),
              "params": best_params[i],
              "stopped_epoch": int(stopped_epoch[i])}
             for i in range(n_trials)], models, optimizer, generators)


@pytest.mark.parametrize("optimizer", ["RMSprop", "Adam"])
def test_fleet_with_a_freeze_equals_the_pre_loop(tmp_path, optimizer):
    """``run_parallel_trials`` (its fleet steps through ``fleet_steps``,
    eager on the CPU) against the loop it replaced, on a fleet whose
    trials freeze at different epochs: every result bit for bit."""
    options = fleet_options(tmp_path, optimizer=optimizer)
    trials = [{"learning_rate": 0.01, "dropout": 0.0928},
              {"learning_rate": 0.0},
              {"learning_rate": 0.003, "momentum": 0.5, "dropout": 0.2}]
    data = make_data(1500, seed=0), make_data(1500, seed=1)
    got = vmapped.run_parallel_trials(options, trials, *data, seed=0,
                                      device="cpu")
    want = pre_loop_parallel_trials(options, trials, *data, seed=0)[0]
    stops = [result["stopped_epoch"] for result in want]
    assert len(set(stops)) > 1 and max(stops) < options.n_epochs, stops
    for result, expected in zip(got, want):
        assert result.keys() == expected.keys()
        assert result["val_history"] == expected["val_history"]
        assert result["val_loss"] == expected["val_loss"]
        assert result["stopped_epoch"] == expected["stopped_epoch"]
        assert_tensors_equal(result["params"], expected["params"])


def test_fleet_steps_equal_fleet_step_calls():
    """:func:`fleet_steps` over two active sets (trial 1 frozen in the
    second) against the same ``fleet_step`` calls: losses, parameters,
    optimizer state and generator states bit for bit; the frozen trial's
    parameters do not move."""
    options = small_options(attention=True, dropout=0.0928)
    config = ModelConfig.from_options(options)
    hps = [{"learning_rate": lr, "momentum": m, "rho": 0.9, "epsilon": 1e-7}
           for lr, m in ((1e-3, 0.9), (5e-3, 0.5), (2e-3, 0.0))]
    sampler = BatchSampler(options, make_data(seed=0), "cpu")
    runs = []
    for through_fleet_steps in (True, False):
        models = [DeepGRPModel.from_params(config, init_params(
            config, torch.Generator().manual_seed(i)), "cpu")
            for i in range(3)]
        optimizer = fleet_optimizer("RMSprop", [
            (m.parameters(), hp) for m, hp in zip(models, hps)])
        gens = [torch.Generator().manual_seed(40 + i) for i in range(3)]

        def batch(i, gens=gens):
            codes, labels = sampler.batch(gens[i])
            return codes, labels, rnn.input_dropout_masks(
                gens[i], 2 * sampler.batch_size, 0.0928, config.gates)

        losses, record = torch.zeros(3), []
        for active in ([True] * 3, [True, False, True]):
            step = vmapped.fleet_steps(models, optimizer, batch, active,
                                       losses)
            for _ in range(3):
                if through_fleet_steps:
                    step()
                else:
                    out = vmapped.fleet_step(
                        models, optimizer,
                        [batch(i) if on else None
                         for i, on in enumerate(active)], active)
                    for i, loss in enumerate(out):
                        if loss is not None:
                            losses[i] = loss
                record.append(losses.clone())
            if all(active):
                frozen = host_params(models[1])
        runs.append((record, [m.params() for m in models],
                     optimizer_state(optimizer),
                     [g.get_state() for g in gens], frozen))
    assert_tensors_equal(runs[0][:4], runs[1][:4])
    assert_tensors_equal(host_params(DeepGRPModel.from_params(
        config, runs[0][1][1], "cpu")), runs[0][4])


# -- refusal and launch counts ------------------------------------------------


def test_capture_on_the_cpu_raises(tmp_path):
    options = small_options()
    model = DeepGRPModel(ModelConfig.from_options(options), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        Trainer(model, options, tmp_path, tensorboard=False, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda: None, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        vmapped.run_parallel_trials(
            fleet_options(tmp_path), [{"learning_rate": 0.01}],
            make_data(seed=0), make_data(seed=1), device="cpu", capture=True)


def test_trainer_captures_only_on_cuda_by_default(tmp_path):
    options = small_options()
    model = DeepGRPModel(ModelConfig.from_options(options), "cpu")
    assert Trainer(model, options, tmp_path, tensorboard=False).capture \
        is False
    assert Trainer(model, options, tmp_path, tensorboard=False,
                   capture=False).capture is False


def test_recorded_launches_are_counted_at_each_replay():
    """Adds made while recording (from any thread) go into the record and
    not the counts; each replay of the record adds them once."""
    counter, other = _build.LaunchCounter(), _build.LaunchCounter()
    counter.add("k")
    with _build.recording_launches() as record:
        counter.add("k")
        counter.add("k", 2)
        worker = threading.Thread(target=other.add, args=("b",))
        worker.start()
        worker.join()
    assert counter.snapshot() == {"k": 1}
    assert other.snapshot() == {}
    for _ in range(2):
        record.replay()
    assert counter.snapshot() == {"k": 7}
    assert other.snapshot() == {"b": 2}


def test_one_recording_at_a_time():
    with _build.recording_launches():
        with pytest.raises(RuntimeError, match="already"):
            with _build.recording_launches():
                pass
    with _build.recording_launches():  # closed again
        pass
