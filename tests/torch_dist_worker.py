"""One rank of the port's multi-process CPU tests (gloo), and the inputs
they share with the single-process reference.

:func:`spawn` runs ``python tests/torch_dist_worker.py TASKS RANK WORLD
DIR`` for each rank and waits: the rank joins a gloo group through
``file://DIR/rdzv``, runs the comma-separated tasks in turn and writes
what each computed to ``DIR/TASK-RANK.npz`` (and ``.json``).  Tasks:

* ``step``: one data-parallel step of the tiny model on this rank's slice
  of :func:`global_batch` (loss and updated parameters);
* ``sharded``: the sharded engine over ``rank + 1`` CPU shards a rank
  (uneven local counts), both tracks of :func:`shard_codes` in float32
  and bfloat16 at an odd batch and step;
* ``trainer``: a batch size that does not divide raises ``ValueError``
  before any collective; then ``Trainer(..., group=WORLD).fit`` on
  :func:`train_data`, logging into ``DIR/log-RANK`` (history, best
  parameters).

No JAX here: the workers start fast, and the port needs none.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.preprocess import Data  # noqa: E402
from deepgrp_tpu_torch.models import rnn  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig, init_params)

#: Windows a rank in the ``step`` task.
LOCAL_BATCH = 4


def step_options(world: int) -> Options:
    return Options(vecsize=50, units=8, attention=True, dropout=0.1,
                   batch_size=LOCAL_BATCH * world, repeats_to_search=[1, 2],
                   learning_rate=0.01)


def initial_model(options: Options) -> DeepGRPModel:
    config = ModelConfig.from_options(options)
    return DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(0)), "cpu")


def global_batch(options: Options):
    """The step's global windows, labels and dropout masks ``[g, 2B, 5]``
    (rows ``0..B-1`` forward, ``B..2B-1`` reverse complement)."""
    rng = np.random.default_rng(5)
    batch, steps = options.batch_size, options.vecsize
    n_classes = len(options.repeats_to_search) + 1
    codes = torch.from_numpy(rng.integers(0, 6, (batch, steps))
                             .astype(np.int8))
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, n_classes, (batch, steps))),
        n_classes).to(torch.float32)
    masks = rnn.input_dropout_masks(torch.Generator().manual_seed(6),
                                    2 * batch, options.dropout, 3)
    return codes, labels, masks


def rank_slice(batch, rank: int, world: int):
    """Rank ``rank``'s share of :func:`global_batch`."""
    codes, labels, masks = batch
    local = codes.shape[0] // world
    rows = slice(rank * local, (rank + 1) * local)
    rev = slice(codes.shape[0] + rank * local,
                codes.shape[0] + (rank + 1) * local)
    return (codes[rows], labels[rows],
            torch.cat([masks[:, rows], masks[:, rev]], dim=1))


def trainer_options(**kwargs) -> Options:
    base = dict(vecsize=60, units=8, attention=True, batch_size=16,
                n_epochs=2, n_batches=3, early_stopping_th=5, dropout=0.1,
                repeats_to_search=[1, 2], learning_rate=0.01)
    base.update(kwargs)
    return Options(**base)


def train_data(length: int = 3000, seed: int = 0) -> Data:
    """Learnable data: class-1 regions poly-A, class-2 poly-C."""
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


def params_npz(path: str, params, **extra) -> None:
    np.savez(path, **{k: v.detach().numpy() for k, v in params.items()},
             **extra)


def run_step(rank: int, world: int, out: str) -> None:
    from deepgrp_tpu_torch.parallel.train import dp_train_step
    from deepgrp_tpu_torch.train.optimizers import get_optimizer

    options = step_options(world)
    model = initial_model(options)
    optimizer = get_optimizer(options, model.parameters())
    loss = dp_train_step(model, optimizer,
                         *rank_slice(global_batch(options), rank, world))
    params_npz(f"{out}.npz", model.params(), loss=loss.numpy())


def shard_codes() -> np.ndarray:
    return np.random.default_rng(11).integers(0, 6, 1234).astype(np.int8)


#: (batch, step) of the ``sharded`` task: rows that do not align to 4 B.
SHARD_BATCH, SHARD_STEP = 3, 7


def run_sharded(rank: int, out: str) -> None:
    from deepgrp_tpu_torch.parallel.predict import ShardedPredictionEngine

    model = initial_model(step_options(1))
    tracks = {}
    for dtype in (torch.float32, torch.bfloat16):
        engine = ShardedPredictionEngine(model, ["cpu"] * (rank + 1),
                                         SHARD_BATCH, SHARD_STEP, dtype)
        name = str(dtype).split(".")[-1]
        tracks[f"{name}/classes"], tracks[f"{name}/maxp"] = \
            engine.predict_scored(shard_codes())
        tracks[f"{name}/rows"] = engine.predict(shard_codes())
    np.savez(f"{out}.npz", n_shards=engine.n_shards, **tracks)


def run_trainer(rank: int, world: int, out: str, tmp: str) -> None:
    import torch.distributed as dist

    from deepgrp_tpu_torch.train.training import Trainer

    logdir = os.path.join(tmp, f"log-{rank}")
    options = trainer_options()
    bad = Trainer(initial_model(options), trainer_options(batch_size=15),
                  logdir, tensorboard=False, group=dist.group.WORLD)
    raised = ""
    try:
        bad.fit(train_data(), train_data(seed=1))
    except ValueError as err:
        raised = str(err)
    finally:
        if bad.writer is not None:
            bad.writer.close()
    trainer = Trainer(initial_model(options), options, logdir,
                      tensorboard=False, group=dist.group.WORLD)
    best, history = trainer.fit(train_data(), train_data(seed=1))
    if trainer.writer is not None:
        trainer.writer.close()
    params_npz(f"{out}.npz", best)
    with open(f"{out}.json", "w") as fh:
        json.dump({"history": history, "raised": raised}, fh)


def run_ranks(commands) -> None:
    """Run one process a command (a rank each) and wait for all; raises
    with the first failing rank's errors."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(command, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for command in commands]
    errors = []
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=240)
            if proc.returncode:
                errors.append(err)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    if errors:
        raise RuntimeError(errors[0])


def spawn(tasks: str, world: int, tmp) -> None:
    """Run ``tasks`` on ``world`` gloo ranks of this script and wait."""
    run_ranks([sys.executable, os.path.abspath(__file__), tasks, str(rank),
               str(world), str(tmp)] for rank in range(world))


def main(argv) -> None:
    import torch.distributed as dist

    tasks, rank, world, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            world_size=world, rank=rank)
    try:
        for task in tasks.split(","):
            out = os.path.join(tmp, f"{task}-{rank}")
            if task == "step":
                run_step(rank, world, out)
            elif task == "sharded":
                run_sharded(rank, out)
            else:
                run_trainer(rank, world, out, tmp)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
