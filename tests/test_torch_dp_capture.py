"""The data-parallel epoch (``deepgrp_tpu_torch/parallel/train.py:
make_dp_train_epoch``) and ``Trainer``'s capture rule, on the CPU.

On the card the data-parallel step is captured as a CUDA graph with its
``all_reduce`` inside when the group's CUDA collectives run over NCCL;
``tests/test_torch_cuda.py -k dp_capture`` holds the captured runs against
the eager ones bit for bit there.  Here:

* the capture rule, with the group's backend and size monkeypatched and a
  stand-in model on ``cuda``: NCCL (also the default
  ``cpu:gloo,cuda:nccl``) captures, gloo with several ranks stays eager,
  ``capture=True`` raises on gloo and on the CPU before any collective;
* under torch's fake process group at world size 2 (rank 0; its
  collectives leave their tensors as they are), the eager epoch of
  ``make_dp_train_epoch`` equals a hand-written loop of
  ``sample_starts_dp`` + masks + ``dp_train_step`` bit for bit (losses,
  parameters, optimizer and generator state), and the data-parallel
  ``Trainer.fit`` equals the hand-written fit it runs;
* at world size 1 (gloo, in this process), the epoch on the windows and
  masks the JAX package's ``make_dp_train_epoch`` draws equals that
  program at atol 1e-5.
"""

import math
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.models import rnn as jax_rnn  # noqa: E402
from deepgrp_tpu.parallel import train as jax_dp  # noqa: E402
from deepgrp_tpu.parallel.mesh import make_mesh  # noqa: E402
from deepgrp_tpu.train import optimizers as jax_optimizers  # noqa: E402
from deepgrp_tpu.train import sampler as jax_sampler  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.preprocess import Data  # noqa: E402
from deepgrp_tpu_torch.models import rnn  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import (  # noqa: E402
    DeepGRPModel, ModelConfig, forward_logits_from_codes, init_params)
from deepgrp_tpu_torch.parallel.mesh import cuda_backend  # noqa: E402
from deepgrp_tpu_torch.parallel.train import (  # noqa: E402
    broadcast_params, dp_train_step, make_dp_train_epoch)
from deepgrp_tpu_torch.train.optimizers import get_optimizer  # noqa: E402
from deepgrp_tpu_torch.train.sampler import BatchSampler  # noqa: E402
from deepgrp_tpu_torch.train.training import (  # noqa: E402
    Trainer, categorical_crossentropy, host_params)

#: (rnn, attention, dropout, fused) of the epoch tests.
CASES = [("GRU", True, 0.0928, True), ("GRU", True, 0.0, True),
         ("LSTM", False, 0.0928, True), ("GRU", True, 0.0928, False)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fake_group():
    """Torch's fake process group as the default group: rank 0 of 2."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture
def one_rank():
    """A gloo group of one rank in this process."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


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
    base = dict(vecsize=20, units=8, batch_size=16, n_epochs=3, n_batches=3,
                early_stopping_th=10, repeats_to_search=[1, 2],
                learning_rate=0.01)
    base.update(kwargs)
    return Options(**base)


def optimizer_state(optimizer):
    return [optimizer.state[p] for group in optimizer.param_groups
            for p in group["params"]]


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


# -- the capture rule ---------------------------------------------------------


@pytest.fixture
def collectives(monkeypatch):
    """Every collective ``torch.distributed`` is asked for, recorded (none
    is run)."""
    calls = []
    for name in ("all_reduce", "broadcast", "barrier", "all_gather"):
        monkeypatch.setattr(dist, name,
                            lambda *a, name=name, **k: calls.append(name))
    return calls


def trainer_with(monkeypatch, tmp_path, backend, world, capture,
                 device="cuda"):
    """A ``Trainer`` over a group of ``world`` ranks whose backend reads
    ``backend``, for a stand-in model on ``device`` (the rule reads only
    the model's device)."""
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    model = types.SimpleNamespace(device=torch.device(device))
    trainer = Trainer(model, small_options(), tmp_path, tensorboard=False,
                      group=object(), capture=capture)
    trainer.writer.close()
    return trainer


@pytest.mark.parametrize("backend,world,capture,want", [
    ("nccl", 2, None, True),
    ("cpu:gloo,cuda:nccl", 2, None, True),
    ("cuda:nccl,cpu:gloo", 8, None, True),
    ("gloo", 2, None, False),
    ("cpu:gloo,cuda:gloo", 3, None, False),
    ("fake", 2, None, False),
    ("fake", 2, True, True),
    ("nccl", 2, False, False),
    ("nccl", 2, True, True),
    ("gloo", 1, None, True),
    ("gloo", 1, True, True),
])
def test_capture_rule(monkeypatch, tmp_path, collectives, backend, world,
                      capture, want):
    """``capture=None`` captures on a CUDA device with one rank or with
    NCCL for CUDA tensors, and keeps gloo of several ranks eager;
    ``capture=True`` is taken with any backend but gloo; no collective
    runs."""
    trainer = trainer_with(monkeypatch, tmp_path, backend, world, capture)
    assert trainer.capture is want
    assert collectives == []


@pytest.mark.parametrize("backend,world,device,match", [
    ("gloo", 2, "cuda", "gloo"),
    ("cpu:gloo,cuda:gloo", 4, "cuda", "gloo"),
    ("nccl", 2, "cpu", "CUDA"),
    ("gloo", 2, "cpu", "CUDA"),
    ("nccl", 1, "cpu", "CUDA"),
])
def test_capture_true_refused_before_any_collective(
        monkeypatch, tmp_path, collectives, backend, world, device, match):
    """``capture=True`` raises ``ValueError`` on the CPU and over gloo
    (the host) with several ranks, when the ``Trainer`` is made: before
    any step or collective."""
    with pytest.raises(ValueError, match=match):
        trainer_with(monkeypatch, tmp_path, backend, world, True, device)
    assert collectives == []


def test_default_on_the_cpu_stays_eager(monkeypatch, tmp_path):
    for backend in ("nccl", "cpu:gloo,cuda:nccl", "gloo"):
        assert trainer_with(monkeypatch, tmp_path, backend, 2, None,
                            "cpu").capture is False


@pytest.mark.parametrize("backend,want", [
    ("nccl", "nccl"), ("cpu:gloo,cuda:nccl", "nccl"), ("gloo", "gloo"),
    ("cpu:gloo,cuda:gloo", "gloo"), ("fake", "fake")])
def test_cuda_backend_names_the_cuda_collectives(monkeypatch, backend,
                                                 want):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    assert cuda_backend() == want


def test_cuda_backend_of_real_groups(fake_group):
    assert cuda_backend(fake_group) == "fake"


# -- the epoch at world size 2 (fake group) -----------------------------------


def run_setup(options, seed=0):
    config = ModelConfig.from_options(options)
    model = DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(seed)),
        "cpu")
    return (model, get_optimizer(options, model.parameters()),
            BatchSampler(options, make_data(seed=0), "cpu"),
            torch.Generator().manual_seed(seed + 11))


def hand_epoch(model, optimizer, sampler, generator, options, group,
               fused):
    """A rank's epoch written out: its starts, its masks and
    ``dp_train_step``, ``n_batches`` times; the step losses."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    rate, gates = float(model.config.dropout), model.config.gates
    rows = 2 * options.batch_size // world
    losses = []
    for _ in range(options.n_batches):
        codes, labels = sampler.gather(sampler.sample_starts_dp(
            generator, rank, world))
        masks = (rnn.input_dropout_masks(generator, rows, rate, gates)
                 if rate > 0.0 else None)
        losses.append(dp_train_step(model, optimizer, codes, labels, masks,
                                    group, fused))
    return torch.stack(losses)


@pytest.mark.parametrize("rnn_type,attention,dropout,fused", CASES)
def test_dp_epoch_equals_the_hand_loop(fake_group, rnn_type, attention,
                                       dropout, fused):
    """Two eager epochs of ``make_dp_train_epoch`` at world size 2 against
    the hand-written loop from the same parameters, sampler and generator
    seed: step losses, epoch means, parameters, optimizer state and
    generator state bit for bit."""
    options = small_options(rnn=rnn_type, attention=attention,
                            dropout=dropout)
    model, optimizer, sampler, generator = run_setup(options)
    ref = run_setup(options)
    loop = make_dp_train_epoch(model, optimizer, options, sampler, generator,
                               options.n_batches, fake_group, fused)
    for _ in range(2):
        mean = loop.epoch()
        want = hand_epoch(*ref, options, fake_group, fused)
        assert torch.equal(loop.losses, want)
        assert torch.equal(mean, want.mean())
        assert_tensors_equal(model.params(), ref[0].params())
        assert_tensors_equal(optimizer_state(optimizer),
                             optimizer_state(ref[1]))
        assert torch.equal(generator.get_state(), ref[3].get_state())


def test_dp_epoch_refuses_an_uneven_batch(fake_group):
    options = small_options(batch_size=15)
    model, optimizer, sampler, generator = run_setup(small_options())
    with pytest.raises(ValueError, match="not divisible"):
        make_dp_train_epoch(model, optimizer, options, sampler, generator,
                            3, fake_group)


def hand_dp_fit(options, train_data, val_data, seed, group, fused):
    """``Trainer.fit``'s data-parallel loop written out (no checkpoints;
    ``early_stopping_th`` above ``n_epochs``): ``(best parameters,
    history, generator)``."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    local = options.batch_size // world
    config = ModelConfig.from_options(options)
    model = DeepGRPModel(config, "cpu")
    model.load_state_dict(init_params(config,
                                      torch.Generator().manual_seed(seed)))
    broadcast_params(model, group)
    optimizer = get_optimizer(options, model.parameters())
    generator = torch.Generator().manual_seed(seed * 65537 + rank)
    val_generator = torch.Generator().manual_seed(seed)
    train_sampler = BatchSampler(options, train_data, "cpu")
    val_sampler = BatchSampler(options, val_data, "cpu")
    history = {"loss": [], "val_loss": []}
    best_val, best_params = math.inf, host_params(model)
    for _ in range(options.n_epochs):
        mean = hand_epoch(model, optimizer, train_sampler, generator,
                          options, group, fused).mean()
        with torch.no_grad():
            starts = val_sampler.sample_starts(val_generator)
            codes, labels = val_sampler.gather(
                starts[rank * local:(rank + 1) * local])
            val_loss = categorical_crossentropy(forward_logits_from_codes(
                model.params(), codes, config), labels)
            dist.all_reduce(val_loss, group=group)
            val_loss = (val_loss / world).item()
        history["loss"].append(mean.item())
        history["val_loss"].append(val_loss)
        if val_loss < best_val:
            best_val, best_params = val_loss, host_params(model)
    return best_params, history, generator


@pytest.mark.parametrize("rnn_type,attention,dropout,fused", CASES[::2])
def test_dp_trainer_fit_equals_the_hand_loop(fake_group, tmp_path, rnn_type,
                                             attention, dropout, fused):
    """``Trainer.fit(group=...)`` at world size 2 on the CPU (eager: the
    fake backend is not NCCL) against the hand-written DP fit: history,
    best parameters and the generator's state bit for bit."""
    options = small_options(rnn=rnn_type, attention=attention,
                            dropout=dropout)
    train_data, val_data = make_data(seed=0), make_data(seed=1)
    model = DeepGRPModel(ModelConfig.from_options(options), "cpu")
    trainer = Trainer(model, options, tmp_path, tensorboard=False,
                      rnn_kernel="fused" if fused else "scan",
                      group=fake_group)
    assert trainer.world == 2 and trainer.capture is False
    try:
        best, history = trainer.fit(train_data, val_data, seed=4)
    finally:
        trainer.writer.close()
    want_best, want_history, want_gen = hand_dp_fit(
        options, train_data, val_data, 4, fake_group, fused)
    assert history == want_history
    assert_tensors_equal(best, want_best)
    assert torch.equal(trainer.generator.get_state(), want_gen.get_state())


def test_cli_train_under_a_group_takes_the_rule(fake_group, tmp_path,
                                                monkeypatch):
    """``train --mesh auto`` (the default) in a process of a group of two
    hands the group to ``Trainer`` with ``capture`` left to its rule (no
    flag): on the CPU that is eager; on the card over NCCL, captured."""
    import torch_dist_worker as worker

    from deepgrp_tpu_torch import cli
    from deepgrp_tpu_torch.train import training as training_module

    made = []

    class Spy(training_module.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append((kwargs.get("group"), kwargs.get("capture"),
                         self.world, self.capture))

    monkeypatch.setattr(training_module, "Trainer", Spy)
    toml, train_npz, val_npz, bed = worker.write_cli_train_inputs(tmp_path)
    cli.main(["--device", "cpu", "-b", str(worker.CLI_TRAIN_BATCH), "train",
              toml, train_npz, val_npz, bed, "--honor-toml", "--logdir",
              str(tmp_path / "log"), "--modelfile", str(tmp_path / "m.npz"),
              "--no-tensorboard"])
    assert len(made) == 1
    group, capture, world, captured = made[0]
    assert group is fake_group and capture is None
    assert world == 2 and captured is False
    assert (tmp_path / "m.npz").exists()


# -- against the JAX package's make_dp_train_epoch ----------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_dp_epoch_matches_jax_dp_epoch(monkeypatch, one_rank, rnn_type,
                                       attention, fused):
    """At world size 1, three steps of ``make_dp_train_epoch`` on the
    windows and masks the JAX package's ``make_dp_train_epoch`` (a 1-device
    mesh, its scan route) draws from its key chain (a ``split`` a step,
    ``fold_in`` of the device index, then ``split`` into sampling and
    dropout keys) against that program from the same parameters: each
    step's loss, the epoch's mean and the parameters at atol 1e-5
    (``test_train_step_matches_jax``'s tolerance)."""
    options = small_options(units=6, batch_size=6, rnn=rnn_type,
                            attention=attention, dropout=0.0928)
    jax_options = JaxOptions(**options.todict())
    data = make_data(seed=3)
    model = jax_model.create_model(jax_options)
    params = model.init(jax.random.PRNGKey(5))
    port_params = params_from_jax(jax.device_get(params))
    jax_opt = jax_optimizers.get_optimizer(jax_options)
    sampler_j = jax_sampler.BatchSampler(jax_options, data)
    epoch = jax_dp.make_dp_train_epoch(model, jax_opt,
                                       make_mesh(jax.devices()[:1]),
                                       jax_options, sampler_j, 3)
    key = jax.random.PRNGKey(12)
    new_params, _, _, jax_losses = epoch(
        jax.tree.map(jnp.array, params), jax_opt.init(params), key,
        *jax_dp.dp_train_arrays(sampler_j))

    config = ModelConfig.from_options(options)
    starts, masks = [], []
    for _ in range(3):
        key, step_key = jax.random.split(key)
        key_sample, key_dropout = jax.random.split(
            jax.random.fold_in(step_key, 0))
        starts.append(torch.from_numpy(np.asarray(
            jax_sampler._sample_starts_dp(
                key_sample, sampler_j._candidates, sampler_j._lengths,
                sampler_j.n_sampled_classes, sampler_j.one_class_size, 1, 0,
                options.batch_size, sampler_j.seq_len, options.vecsize),
            dtype=np.int64)))
        masks.append(torch.from_numpy(np.array(jax_rnn._input_dropout_masks(
            key_dropout, (2 * options.batch_size, 5), options.dropout,
            config.gates, jnp.float32))))
    given_starts, given_masks = iter(starts), iter(masks)
    monkeypatch.setattr(rnn, "input_dropout_masks",
                        lambda *args, **kwargs: next(given_masks))
    port = DeepGRPModel.from_params(config, port_params, "cpu")
    sampler = BatchSampler(options, data, "cpu")
    sampler.sample_starts_dp = lambda *args: next(given_starts)
    loop = make_dp_train_epoch(port, get_optimizer(options,
                                                   port.parameters()),
                               options, sampler, torch.Generator(), 3,
                               one_rank, fused)
    mean = loop.epoch()
    np.testing.assert_allclose(loop.losses.numpy(), np.asarray(jax_losses),
                               atol=1e-5)
    assert abs(mean.item() - float(np.mean(jax_losses))) <= 1e-5
    want = params_from_jax(jax.device_get(new_params))
    for name, value in port.params().items():
        np.testing.assert_allclose(value.detach().numpy(),
                                   want[name].numpy(), atol=1e-5,
                                   err_msg=name)
