"""The port's local launcher (``deepgrp_tpu_torch/parallel/launch.py``)
behind ``train --mesh auto`` and ``training(..., mesh=...)`` on the CPU:
the ranks it spawns share the CPU (``["cpu"] * 2``, gloo).

A launched run must equal, bit for bit, the same ranks started by hand
(``tests/torch_dist_worker.py``'s ``trainer`` and ``cli_train`` tasks,
which ``tests/test_torch_parallel.py`` holds against the CLI's launch
flags); ``plan_train_ranks`` must take the JAX package's decision
(``deepgrp_tpu/cli.py``'s ``--mesh auto`` on the conftest's 8-device CPU
mesh, ``jax.devices()`` cut to the case's count); a rank that raises or
dies must end the launch with an error that names it, within the test's
deadline, leaving no child process.
"""

import contextlib
import functools
import importlib
import json
import logging
import multiprocessing
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig, init_params)
from deepgrp_tpu_torch.parallel import launch, mesh  # noqa: E402
from deepgrp_tpu_torch.train.training import training  # noqa: E402

import torch_dist_worker as worker  # noqa: E402

#: Seconds a test that starts ranks may take: spawning two ranks and
#: training the tiny model takes about 10 s here.
LAUNCH_DEADLINE = 180

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in every rank (the spawned ranks read
    ``OMP_NUM_THREADS``), as the hand-started references run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def deadline(seconds):
    """Fail the test if its body takes longer than ``seconds``; past it,
    every child process is killed, so the launcher returns."""
    fired = threading.Event()

    def kill():
        fired.set()
        for child in multiprocessing.active_children():
            child.kill()

    timer = threading.Timer(seconds, kill)
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
        assert not fired.is_set(), f"the launch took over {seconds} s"


def assert_same_bytes(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def metrics(logdir):
    with open(logdir / "metrics.jsonl") as fh:
        return [(rec["loss"], rec["val_loss"]) for rec in map(json.loads, fh)]


# -- devices and the backend --------------------------------------------------


def test_make_mesh_is_local_devices():
    assert mesh.make_mesh is mesh.local_devices
    assert mesh.make_mesh(["cpu"] * 2) == [torch.device("cpu")] * 2
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device list is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.make_mesh()


@pytest.mark.parametrize("devices,backend", [
    (["cuda:0", "cuda:1"], None), (["cuda:0"], None),
    (["cuda:0", "cuda:0"], "gloo"), (["cpu", "cpu"], "gloo"),
    (["cpu"], "gloo")])
def test_launch_backend(devices, backend):
    """NCCL (the default backend) for distinct GPUs; gloo when a GPU
    repeats (NCCL refuses two ranks on one device) and on the CPU."""
    assert launch.launch_backend([torch.device(d) for d in devices]) \
        == backend


@pytest.mark.parametrize("started", ["group", "env"])
def test_no_launch_inside_a_started_group(monkeypatch, started):
    if started == "group":
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
    else:
        monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="started process group"):
        launch.launch_local(worker.failing_rank, ["cpu"] * 2,
                            args=("x", "raise"))
    assert not multiprocessing.active_children()


# -- training(mesh=...) -------------------------------------------------------


def test_training_mesh_equals_hand_started_ranks(tmp_path):
    """``training(..., mesh=["cpu", "cpu"])`` returns rank 0's
    ``(best_params, history)`` of two launched ranks, bit for bit those
    of two ranks started by hand running ``Trainer(..., group=WORLD)``;
    only rank 0 logs (one record an epoch)."""
    worker.spawn("trainer", 2, tmp_path)
    options = worker.trainer_options()
    with deadline(LAUNCH_DEADLINE):
        best, history = training(
            (worker.train_data(), worker.train_data(seed=1)), options,
            logdir=tmp_path / "mesh-log", tensorboard=False,
            mesh=["cpu", "cpu"], device="cpu")
    with open(tmp_path / "trainer-0.json") as fh:
        assert history == json.load(fh)["history"]
    with np.load(tmp_path / "trainer-0.npz") as ref:
        assert sorted(best) == sorted(ref.files)
        for key in ref.files:
            assert best[key].device.type == "cpu"
            assert_same_bytes(best[key].numpy(), ref[key])
    assert metrics(tmp_path / "mesh-log") == list(
        zip(history["loss"], history["val_loss"]))
    assert len(history["loss"]) == options.n_epochs
    assert not multiprocessing.active_children()


def test_training_mesh_carries_model_and_params(tmp_path):
    """A given model lends its config (units 6 where the options say 8)
    and params start every rank: at learning rate 0 the best parameters
    are the given ones, bit for bit, and the model ends holding them."""
    options = worker.trainer_options(learning_rate=0.0, n_epochs=1)
    config = ModelConfig.from_options(worker.trainer_options(units=6))
    params = init_params(config, torch.Generator().manual_seed(9))
    model = DeepGRPModel(config, "cpu")
    with deadline(LAUNCH_DEADLINE):
        best, _ = training(
            (worker.train_data(), worker.train_data(seed=1)), options,
            model, tmp_path / "log", params=params, tensorboard=False,
            mesh=["cpu", "cpu"])
    for key, value in params.items():
        assert_same_bytes(best[key].numpy(), value.numpy())
        assert_same_bytes(model.params()[key].detach().numpy(),
                          value.numpy())


def test_training_mesh_of_one_trains_here(tmp_path):
    """A mesh of one device is the run of this process on it."""
    options = worker.trainer_options(n_epochs=1)
    data = (worker.train_data(), worker.train_data(seed=1))
    best, history = training(data, options, logdir=tmp_path / "a",
                             tensorboard=False, mesh=["cpu"])
    want, want_history = training(data, options, logdir=tmp_path / "b",
                                  tensorboard=False, device="cpu")
    assert history == want_history
    for key, value in want.items():
        assert_same_bytes(best[key].numpy(), value.numpy())


class Traced:
    """A ``trace`` that records when its context is entered and left."""

    def __init__(self, events):
        self.events = events

    @contextlib.contextmanager
    def __call__(self):
        self.events.append("enter")
        yield
        self.events.append("exit")


def test_training_runs_under_trace(tmp_path):
    """``trace``'s context wraps the training in this process, and only
    once (its epochs log inside it)."""
    events = []

    def record(epoch, logs):
        events.append(epoch)

    training((worker.train_data(), worker.train_data(seed=1)),
             worker.trainer_options(n_epochs=2), logdir=tmp_path / "log",
             extra_callbacks=[record], tensorboard=False, device="cpu",
             trace=Traced(events))
    assert events == ["enter", 1, 2, "exit"]


def test_training_mesh_refusals(monkeypatch, tmp_path):
    """``mesh`` with ``group`` raises; a callback that does not pickle
    raises before any rank starts, with the reason."""
    data = (worker.train_data(), worker.train_data(seed=1))
    options = worker.trainer_options()
    with pytest.raises(ValueError, match="not both"):
        training(data, options, mesh=["cpu", "cpu"], group=object())

    def started(*args, **kwargs):
        raise AssertionError("a rank started")

    monkeypatch.setattr(launch.mp, "start_processes", started)
    with pytest.raises(ValueError, match="must pickle.*lock"):
        training(data, options, logdir=tmp_path / "log",
                 extra_callbacks=[functools.partial(print, threading.Lock())],
                 tensorboard=False, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="must pickle"):
        training(data, options, logdir=tmp_path / "log",
                 extra_callbacks=[lambda epoch, logs: None],
                 tensorboard=False, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="must pickle"):
        training(data, options, logdir=tmp_path / "log", tensorboard=False,
                 mesh=["cpu", "cpu"], trace=lambda: contextlib.nullcontext())


# -- train --mesh auto --------------------------------------------------------


@pytest.fixture(scope="module")
def cli_reference(tmp_path_factory):
    """The ``train`` inputs and two ranks of the ``cli_train`` task started
    by hand on them (the reference ``test_cli_two_process_train`` holds
    the CLI's rank 0 to): ``api-model.npz`` and ``api-log-0``."""
    tmp = tmp_path_factory.mktemp("cli_reference")
    files = worker.write_cli_train_inputs(tmp)
    worker.spawn("cli_train", 2, tmp)
    return tmp, files


def cli_train_args(tmp_path, files, *flags):
    return [*flags, "--device", "cpu", "-b", str(worker.CLI_TRAIN_BATCH),
            "train", *files, "--honor-toml", "--logdir",
            str(tmp_path / "cli-log"), "--modelfile",
            str(tmp_path / "cli-model.npz"), "--no-tensorboard", "--mesh",
            "auto"]


def assert_cli_run_equals_reference(tmp_path, cli_reference):
    """The command's model file and epoch losses equal, bit for bit, those
    of the two ranks started by hand; rank 0 alone wrote the log."""
    ref = cli_reference[0]
    want = metrics(ref / "api-log-0")
    assert len(want) == worker.trainer_options().n_epochs
    assert metrics(tmp_path / "cli-log") == want
    with np.load(tmp_path / "cli-model.npz") as got, \
            np.load(ref / "api-model.npz") as ref_model:
        assert sorted(got.files) == sorted(ref_model.files)
        for key in ref_model.files:
            assert_same_bytes(got[key], ref_model[key])


def test_cli_train_mesh_auto_launches_ranks(monkeypatch, tmp_path,
                                            cli_reference):
    """``train --mesh auto`` with the plan patched to 2 ranks and the mesh
    to two CPUs, in this process only: the command loads the data, starts
    two ranks through ``training(..., mesh=...)`` and saves rank 0's
    model, equal to the ranks started by hand."""
    plans = []

    def plan(*args):
        plans.append(args)
        return 2, None

    monkeypatch.setattr(cli, "plan_train_ranks", plan)
    monkeypatch.setattr(mesh, "make_mesh",
                        lambda: mesh.local_devices(["cpu"] * 2))
    with deadline(LAUNCH_DEADLINE):
        cli.main(cli_train_args(tmp_path, cli_reference[1]))
    assert plans == [("auto", "cpu", 0, None, worker.CLI_TRAIN_BATCH)]
    assert_cli_run_equals_reference(tmp_path, cli_reference)
    assert not multiprocessing.active_children()


#: ``python -m deepgrp_tpu_torch`` with the rank plan and the mesh patched
#: as above, in the launching process only; the spawned ranks import the
#: ``-m`` module by name, as under ``python -m`` itself.
PYTHON_M = ("import runpy; from deepgrp_tpu_torch import cli; "
            "from deepgrp_tpu_torch.parallel import mesh; "
            "cli.plan_train_ranks = lambda *args: (2, None); "
            "mesh.make_mesh = lambda: mesh.local_devices(['cpu'] * 2); "
            "runpy.run_module('deepgrp_tpu_torch', run_name='__main__', "
            "alter_sys=True)")


def test_python_m_train_mesh_auto_launches_ranks(tmp_path, cli_reference):
    """The launch through ``python -m deepgrp_tpu_torch -t 1 --profile
    DIR``: each spawned rank imports the ``-m`` module without running
    the command again; the model and losses equal the ranks started by
    hand; each rank, and not the launching process, writes a trace."""
    trace_dir = tmp_path / "trace"
    proc = subprocess.Popen(
        [sys.executable, "-c", PYTHON_M, *cli_train_args(
            tmp_path, cli_reference[1], "-v", "-t", "1", "--profile",
            str(trace_dir))],
        cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        _, stderr = proc.communicate(timeout=LAUNCH_DEADLINE)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr
    assert "launching 2 ranks" in stderr
    assert_cli_run_equals_reference(tmp_path, cli_reference)
    traces = sorted(trace_dir.glob("train.*.pt.trace.json"))
    assert len(traces) == 2, traces
    assert not any(f".{proc.pid}." in path.name for path in traces)


# Cases of (mesh, device, visible GPUs, world or None, batch size).
PLAN_CASES = [
    ("auto", "cuda", 0, None, 32), ("auto", "cuda", 1, None, 32),
    ("auto", "cuda", 2, None, 32), ("auto", "cuda", 8, None, 32),
    ("auto", "cuda", 1, None, 30), ("auto", "cuda", 2, None, 30),
    ("auto", "cuda", 8, None, 30), ("off", "cuda", 2, None, 32),
    ("off", "cuda", 8, None, 32), ("auto", "cpu", 8, None, 32),
    ("auto", "cuda", 1, 2, 32), ("auto", "cpu", 0, 8, 30),
    ("off", "cuda", 1, 2, 32)]


@pytest.fixture(scope="module")
def jax_train_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_plan")
    files = worker.write_cli_train_inputs(tmp)
    with open(files[0], "w") as fh:
        fh.write("vecsize = 60\nunits = 8\nattention = true\n"
                 "repeats_to_search = [1, 2]\nn_epochs = 1\n"
                 "n_batches = 1\n")
    return tmp, files


class Recorded(Exception):
    """Raised by the patched JAX ``training`` after it records its mesh."""


@pytest.mark.parametrize("mesh_flag,device,n_gpus,world,batch", PLAN_CASES)
def test_plan_train_ranks_matches_jax(monkeypatch, caplog, jax_train_files,
                                      mesh_flag, device, n_gpus, world,
                                      batch):
    """The port's rank plan against the JAX package's ``train --mesh``
    decision on the same count of devices: the port's devices are its
    GPUs (``--device cuda``), the CPU (one device), or a started group's
    ranks; the JAX package sees them all as ``jax.devices()``."""
    from deepgrp_tpu import cli as jax_cli

    jax_training = importlib.import_module("deepgrp_tpu.train.training")

    n_ranks, warning = cli.plan_train_ranks(mesh_flag, device, n_gpus,
                                            world, batch)
    count = world if world is not None else (n_gpus if device == "cuda"
                                             else 1)
    devices = jax.devices()[:count]
    meshes = []

    def record(*args, mesh=None, **kwargs):
        meshes.append(mesh)
        raise Recorded

    monkeypatch.setattr(jax, "devices", lambda *args: devices)
    monkeypatch.setattr(jax_training, "training", record)
    tmp, files = jax_train_files
    with caplog.at_level(logging.WARNING, logger="deepgrp_tpu"), \
            pytest.raises(Recorded):
        jax_cli.main(["-b", str(batch), "train", *files, "--honor-toml",
                      "--logdir", str(tmp / "logs"), "--modelfile",
                      str(tmp / "model.npz"), "--mesh", mesh_flag])
    jax_mesh = meshes[0]
    assert (jax_mesh is None) == (n_ranks == 1)
    assert n_ranks == (1 if jax_mesh is None else jax_mesh.devices.size)
    jax_warnings = [r.getMessage() for r in caplog.records
                    if r.name == "deepgrp_tpu" and r.levelno
                    == logging.WARNING]
    assert jax_warnings == ([warning] if warning else [])


# -- failures -----------------------------------------------------------------


@pytest.mark.parametrize("mode,named", [
    ("raise", "rank 1 raised:"), ("exit", "rank 1 exited with code 3")])
def test_failing_rank_ends_the_launch(tmp_path, mode, named):
    """A rank that raises, or one that leaves with ``os._exit(3)`` while
    the other waits in an ``all_reduce``: the launch raises, naming the
    rank (with its traceback), and ends the other rank, which never
    writes its model file; no child process is left."""
    with deadline(LAUNCH_DEADLINE), pytest.raises(RuntimeError) as info:
        launch.launch_local(worker.failing_rank, ["cpu"] * 2,
                            args=(str(tmp_path), mode))
    message = str(info.value)
    assert named in message, message
    if mode == "raise":
        assert "ValueError: rank 1 fails on purpose" in message
    assert not (tmp_path / "model.npz").exists()
    assert not multiprocessing.active_children()


def test_failures_reads_a_cut_off_error_file(tmp_path):
    """Rank 1 exits with code 3 and rank 0, ended while torch's spawn
    wrapper wrote its error file, leaves that file empty: the message
    names rank 1's exit code and reports rank 0 as ended, and reading the
    empty file raises no ``EOFError`` (the race a failing launch could
    hit)."""
    from types import SimpleNamespace

    from torch.multiprocessing.spawn import ProcessExitedException

    error_files = [str(tmp_path / "rank0.err"), str(tmp_path / "rank1.err")]
    open(error_files[0], "wb").close()
    context = SimpleNamespace(
        processes=[SimpleNamespace(exitcode=-9), SimpleNamespace(exitcode=3)],
        error_files=error_files)
    first = ProcessExitedException("process 1 terminated with exit code 3",
                                   error_index=1, error_pid=0, exit_code=3)
    lines = launch._failures(context, first)
    assert lines[0] == "rank 1 exited with code 3"
    assert lines[1:] == ["rank 0 was ended while it wrote its error"]
    assert not os.path.exists(error_files[0])


def test_launch_returns_rank_zero_result(tmp_path):
    """Rank 0's value comes back by value (its tensors' bytes, not a
    handle into a process that has exited), read while rank 0 waits to
    write more than a pipe holds; each rank's environment names it, and
    it runs with this process's torch thread count (not the one that
    ``OMP_NUM_THREADS`` gives a new process)."""
    torch.set_num_threads(2)
    with deadline(LAUNCH_DEADLINE):
        got = launch.launch_local(worker.rank_result, ["cpu"] * 3)
    assert got["world"] == 3 and got["rank"] == 0
    assert got["env"] == {"RANK": "0", "WORLD_SIZE": "3", "LOCAL_RANK": "0"}
    assert got["threads"] == 2
    assert_same_bytes(got["sum"].numpy(), np.full(4, 3.0, np.float32))
    assert_same_bytes(got["big"].numpy(),
                      np.arange(1 << 18, dtype=np.float32))
    assert not multiprocessing.active_children()


def test_launch_passes_tensors_in_shared_memory():
    """A CPU tensor in ``args`` reaches every rank in shared memory, not as
    a copy: what the ranks write, the caller reads (``training(mesh=...)``
    hands the chromosomes over so)."""
    shared = torch.zeros(4).share_memory_()
    with deadline(LAUNCH_DEADLINE):
        launch.launch_local(worker.write_shared, ["cpu"] * 2,
                            args=(shared,))
    assert shared.tolist() == [1.0, 2.0, 0.0, 0.0]
