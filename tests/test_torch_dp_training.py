"""The port's data-parallel training (``deepgrp_tpu_torch/parallel/
train.py``, ``BatchSampler.sample_starts_dp``, ``Trainer(group=...)``)
on the CPU: gloo ranks are separate processes
(``tests/torch_dist_worker.py``), each on its slice of the batch, held
against one process on the whole batch; the sampler's per-rank class
quotas against the JAX package's ``_sample_starts_dp``."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.train import sampler as jax_sampler  # noqa: E402
from deepgrp_tpu_torch.train import checkpoint  # noqa: E402
from deepgrp_tpu_torch.train.optimizers import get_optimizer  # noqa: E402
from deepgrp_tpu_torch.train.sampler import (BatchSampler,  # noqa: E402
                                             local_batch_size)
from deepgrp_tpu_torch.train.training import (Trainer,  # noqa: E402
                                              train_step)
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402

import torch_dist_worker as worker  # noqa: E402

#: The tasks of each world size's one spawn.
TASKS = {2: "step,trainer", 3: "step"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size's ranks spawned once (:data:`TASKS`); their
    directory."""
    done = {}

    def run(world: int):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"world{world}")
            worker.spawn(TASKS[world], world, tmp)
            done[world] = tmp
        return done[world]

    return run


def load(path):
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


# -- the sampler --------------------------------------------------------------


def sentinel_sampler(n_sampled: int, ocs: int, batch: int) -> BatchSampler:
    """A sampler whose class-c candidates are all ``1000 + c`` and whose
    uniform starts fall in ``[0, 90)``, so each start names its source."""
    sampler = BatchSampler.__new__(BatchSampler)
    sampler.device = torch.device("cpu")
    sampler.vecsize, sampler.seq_len, sampler.batch_size = 10, 100, batch
    sampler.n_sampled_classes, sampler.one_class_size = n_sampled, ocs
    sampler.candidates = (1000 + torch.arange(n_sampled))[:, None].repeat(
        1, 7)
    sampler.lengths = torch.full((n_sampled,), 7)
    return sampler


def quota_cases():
    """(world, n_sampled, one_class_size) with quotas from the world size:
    dividing and not dividing by it, and nearly saturating the batch of 4
    windows a rank."""
    cases = []
    for world in (1, 2, 3, 8):
        for n_sampled, ocs in ((2, world), (2, world + 1),
                               (3, (4 * world - 1) // 3)):
            cases.append((world, n_sampled, ocs))
    return cases


@pytest.mark.parametrize("world,n_sampled,ocs", quota_cases())
def test_sample_starts_dp_class_counts_match_jax(world, n_sampled, ocs):
    """Each rank's count of starts of every class equals the JAX
    function's at the same (n_dev, dev_idx); summed over the ranks every
    class gets exactly one_class_size and the rest are uniform starts."""
    local = 4
    sampler = sentinel_sampler(n_sampled, ocs, local * world)
    cand = jnp.asarray(sampler.candidates.numpy(), jnp.int32)
    lengths = jnp.asarray(sampler.lengths.numpy(), jnp.int32)
    totals = np.zeros(n_sampled, np.int64)
    for rank in range(world):
        gen = torch.Generator().manual_seed(rank)
        got = sampler.sample_starts_dp(gen, rank, world).numpy()
        want = np.asarray(jax_sampler._sample_starts_dp(
            jax.random.PRNGKey(rank), cand, lengths, n_sampled, ocs, world,
            rank, local, 100, 10))
        assert got.shape == want.shape == (local,)
        for cls in range(n_sampled):
            count = int((got == 1000 + cls).sum())
            assert count == int((want == 1000 + cls).sum()), (rank, cls)
            totals[cls] += count
        assert ((got < 90) | (got >= 1000)).all()
    np.testing.assert_array_equal(totals, ocs)


def test_sample_starts_dp_raises_where_jax_raises():
    """Too many class slots for a rank's batch, and a batch that does not
    divide by the world size, raise ValueError."""
    with pytest.raises(ValueError, match="class-balanced slots"):
        jax_sampler._sample_starts_dp(
            jax.random.PRNGKey(0), jnp.zeros((3, 7), jnp.int32),
            jnp.full((3,), 7, jnp.int32), 3, 3, 2, 0, 4, 100, 10)
    with pytest.raises(ValueError, match="class-balanced slots"):
        sentinel_sampler(3, 3, 8).sample_starts_dp(torch.Generator(), 0, 2)
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(13, 2)
    with pytest.raises(ValueError, match="not divisible"):
        sentinel_sampler(1, 1, 13).sample_starts_dp(torch.Generator(), 0, 2)


# -- the step -----------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
def test_dp_step_equals_single_process_step(runs, world):
    """After one step, every rank's loss and updated parameters equal one
    process's step on the concatenated windows and masks (to 1e-5 of each
    tensor's largest magnitude), and the ranks' parameters are bitwise
    equal."""
    tmp = runs(world)
    options = worker.step_options(world)
    model = worker.initial_model(options)
    loss = train_step(model, get_optimizer(options, model.parameters()),
                      *worker.global_batch(options))
    want = {k: v.detach().numpy() for k, v in model.params().items()}
    ranks = [load(tmp / f"step-{rank}.npz") for rank in range(world)]
    for got in ranks:
        assert abs(float(got["loss"]) - loss.item()) <= 1e-5 * abs(
            loss.item())
        for key, value in want.items():
            err = np.abs(got[key] - value).max()
            assert err <= 1e-5 * np.abs(value).max(), (key, err)
    for got in ranks[1:]:
        for key in want:
            np.testing.assert_array_equal(got[key], ranks[0][key])


def test_dp_trainer_batch_not_dividing_raises(runs):
    """A batch size that does not divide by the world size raises
    ValueError on every rank before any collective."""
    tmp = runs(2)
    for rank in range(2):
        with open(tmp / f"trainer-{rank}.json") as fh:
            assert "not divisible by 2 ranks" in json.load(fh)["raised"]


def test_dp_trainer_matches_single_process_contract(runs, tmp_path):
    """DP training on 2 ranks: the history of single-process training
    (keys and length), finite losses, the same history and best
    parameters on every rank, a checkpoint that restores them, and files
    written by rank 0 only."""
    tmp = runs(2)
    options = worker.trainer_options()
    single = Trainer(worker.initial_model(options), options, tmp_path,
                     tensorboard=False)
    _, want = single.fit(worker.train_data(), worker.train_data(seed=1))
    single.writer.close()
    histories = []
    for rank in range(2):
        with open(tmp / f"trainer-{rank}.json") as fh:
            histories.append(json.load(fh)["history"])
    assert sorted(histories[0]) == sorted(want)
    assert len(histories[0]["loss"]) == len(want["loss"]) == 2
    assert all(np.isfinite(histories[0]["loss"] + histories[0]["val_loss"]))
    assert histories[1] == histories[0]
    best = [load(tmp / f"trainer-{rank}.npz") for rank in range(2)]
    for key in best[0]:
        np.testing.assert_array_equal(best[1][key], best[0][key])
    latest = checkpoint.CheckpointManager(tmp / "log-0").latest_path()
    restored = params_from_jax(checkpoint.load_params(latest))
    for key, value in restored.items():
        np.testing.assert_array_equal(value.numpy(), best[0][key])
    assert os.path.exists(tmp / "log-0" / "metrics.jsonl")
    assert not os.path.exists(tmp / "log-1")
