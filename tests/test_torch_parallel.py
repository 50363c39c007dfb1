"""The port's sharded predictor and multi-process launch
(``deepgrp_tpu_torch/parallel/``, ``cli.py``'s ``--mesh`` and launch
flags) on the CPU: shards share the CPU (``["cpu"] * n``), and a
multi-process run is two gloo ranks.

The sharded engine must give the single engine's bytes exactly, on both
tracks, in float32 and bfloat16, with the boundary combined on the
shards' devices or on the host; against the JAX package's
``ShardedPredictionEngine`` on the conftest's 8-device CPU mesh, classes
are equal and max probabilities within 1e-5 (the tolerance of
``tests/test_torch_predict.py``).
"""

import os
import socket
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.parallel import (ShardedPredictionEngine as  # noqa: E402
                                  JaxShardedEngine, make_mesh)
from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.fasta import read_multi_fasta  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.keras_io import load_model  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig)
from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed  # noqa: E402
from deepgrp_tpu_torch.ops.segments import yield_segments  # noqa: E402
from deepgrp_tpu_torch.parallel import mesh  # noqa: E402
from deepgrp_tpu_torch.parallel.predict import \
    ShardedPredictionEngine  # noqa: E402
from deepgrp_tpu_torch.predict.engine import PredictionEngine  # noqa: E402
from deepgrp_tpu_torch.predict.postprocess import \
    predict_sequence  # noqa: E402

import torch_dist_worker as worker  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "fixtures", "torch")
REF_ARGS = ["-b", "64", "-s", "50", "-x", "50", "-l", "50"]
VECSIZE = 60


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """The tiny GRU with attention: (port model, JAX model, JAX params)."""
    config = ModelConfig(vecsize=VECSIZE, units=8, attention=True,
                         dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(3), jax_cfg)
    port = DeepGRPModel.from_params(config, params_from_jax(params), "cpu")
    return port, jax_model.DeepGRPModel(jax_cfg), params


def random_codes(seed, length):
    return np.random.default_rng(seed).integers(0, 6, length).astype(np.int8)


def assert_same_bytes(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def check_against_single(model, codes, n_shards, batch, step, dtype):
    """Both tracks of the sharded engine (boundary on the devices and on
    the host) equal the single engine's bytes."""
    single = PredictionEngine(model, batch, step, dtype)
    want_c, want_p = single.predict_scored(codes)
    want_rows = single.predict(codes)
    for collective in (True, False):
        sharded = ShardedPredictionEngine(model, ["cpu"] * n_shards, batch,
                                          step, dtype, collective=collective)
        got_c, got_p = sharded.predict_scored(codes)
        assert_same_bytes(got_c, want_c)
        assert_same_bytes(got_p, want_p)
        assert_same_bytes(sharded.predict(codes), want_rows)
        assert_same_bytes(sharded.predict(codes, out_len=codes.size + 7),
                          single.predict(codes, out_len=codes.size + 7))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("seq_len", [45, 180, 433],
                         ids=["below_vecsize", "one_chunk", "ragged"])
@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_equals_single_engine(models, n_shards, seq_len, dtype):
    """Lengths below vecsize (no window), one chunk (fewer windows than
    shards: most shards empty) and several chunks with a ragged end."""
    check_against_single(models[0], random_codes(seq_len, seq_len),
                         n_shards, 4, 10, dtype)


@pytest.mark.parametrize("seq_len,batch,step", [
    (700, 4, 60),   # step == vecsize: no overlap, no boundary
    (900, 3, 75),   # step > vecsize
    (350, 4, 7),    # the spill reaches past a whole block
    (1203, 5, 10),  # chunks that do not divide by the shards
])
def test_sharded_equals_single_engine_strides(models, seq_len, batch, step):
    check_against_single(models[0], random_codes(seq_len + 1, seq_len), 3,
                         batch, step, torch.float32)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_sharded_matches_jax_sharded_engine(models, n_shards):
    """Against the JAX sharded engine on a mesh of as many CPU devices:
    classes equal, max probability within 1e-5."""
    port, jax_mdl, params = models
    codes = random_codes(n_shards, 1500)
    devices = jax.devices()[:n_shards]
    assert len(devices) == n_shards  # the conftest's 8-device CPU mesh
    want_c, want_p = JaxShardedEngine(
        jax_mdl, make_mesh(devices), batch_size=8,
        step_size=10).predict_scored(params, codes)
    got_c, got_p = ShardedPredictionEngine(
        port, ["cpu"] * n_shards, 8, 10).predict_scored(codes)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)


def fasta_rows(engine, name):
    """BED rows (without the file column) of a fixture through
    ``predict_sequence`` with ``engine``, as the CLI writes them."""
    options = Options(vecsize=engine.model.config.vecsize, batch_size=64,
                      min_mss_len=50, xdrop_len=50)
    rows = []
    with open(os.path.join(FIXDIR, f"{name}.fa")) as fh:
        for header, seq in read_multi_fasta(fh):
            startpos, codes = encode_codes_trimmed(seq)
            classes = predict_sequence(engine, codes, options, threads=1)
            rows += ["{}\t{}\t{}\t{}".format(header, *segment)
                     for segment in yield_segments(classes, startpos)
                     if segment[2] > 0]
    return rows


def expected_rows(name):
    with open(os.path.join(FIXDIR, f"{name}.bed")) as fh:
        return fh.read().splitlines()


def test_predict_sequence_sharded_reproduces_reference_bed():
    """The gru_att fixture through predict_sequence with a 3-shard engine
    equals the reference BED."""
    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    model = DeepGRPModel.from_params(config, params, "cpu")
    engine = ShardedPredictionEngine(model, ["cpu"] * 3, batch_size=64,
                                     step_size=50)
    assert fasta_rows(engine, "gru_att") == expected_rows("gru_att")


# -- devices and the process group ----------------------------------------------


def test_local_devices_repeat_and_refuse_without_gpu():
    assert mesh.local_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device list is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.local_devices()
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.local_devices(["cuda:0"])


def test_initialize_distributed_noop_when_initialized(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)

    def called(*args, **kwargs):
        raise AssertionError("called")

    monkeypatch.setattr(dist, "init_process_group", called)
    mesh.initialize_distributed("tcp://127.0.0.1:1", 2, 0)


def test_cli_mesh_and_launch_flags_parse():
    parser = cli.build_parser()
    args = parser.parse_args(["--coordinator", "10.0.0.1:1234",
                              "--num-processes", "4", "--process-id", "3",
                              "predict", "m.npz", "a.fa", "--mesh", "off"])
    assert (args.coordinator, args.num_processes, args.process_id,
            args.mesh) == ("10.0.0.1:1234", 4, 3, "off")
    args = parser.parse_args(["train", "p.toml", "a.npz", "b.npz", "r.bed"])
    assert args.mesh == "auto" and args.coordinator is None
    with pytest.raises(SystemExit):
        parser.parse_args(["predict", "m.npz", "a.fa", "--mesh", "all"])


@pytest.mark.parametrize("coordinator,error", [
    ("127.0.0.1", ValueError), ("127.0.0.1:port", ValueError),
    ("127.0.0.1:1", RuntimeError)])
def test_cli_bad_coordinator_raises(monkeypatch, tmp_path, coordinator,
                                    error):
    """A malformed address raises ValueError; a failure to join the group
    propagates (mirrors test_multihost.py's
    test_initialize_distributed_raises)."""
    def boom(*args, **kwargs):
        raise RuntimeError("bad coordinator")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(error):
        cli.main(["--device", "cpu", "--coordinator", coordinator,
                  "--num-processes", "2", "--process-id", "1", "predict",
                  os.path.join(TORCH_FIXDIR, "gru.npz"),
                  os.path.join(FIXDIR, "gru.fa"),
                  "--output", str(tmp_path / "x.bed")])
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        cli.main(["--device", "cpu", "--num-processes", "2", "predict",
                  "m.npz", "a.fa"])


def test_sharded_across_processes_equals_single_engine(tmp_path):
    """Two gloo ranks holding 1 and 2 CPU shards (3 global shards, rows
    of odd byte widths) give every rank the single engine's bytes on both
    tracks, in float32 and bfloat16."""
    worker.spawn("sharded", 2, tmp_path)
    model = worker.initial_model(worker.step_options(1))
    codes = worker.shard_codes()
    for rank in range(2):
        with np.load(tmp_path / f"sharded-{rank}.npz") as got:
            assert int(got["n_shards"]) == 3
            for dtype in (torch.float32, torch.bfloat16):
                single = PredictionEngine(model, worker.SHARD_BATCH,
                                          worker.SHARD_STEP, dtype)
                name = str(dtype).split(".")[-1]
                classes, maxp = single.predict_scored(codes)
                assert_same_bytes(got[f"{name}/classes"], classes)
                assert_same_bytes(got[f"{name}/maxp"], maxp)
                assert_same_bytes(got[f"{name}/rows"], single.predict(codes))


_CLI = ("import sys; sys.path.insert(0, sys.argv[1]); "
        "from deepgrp_tpu_torch import cli; cli.main(sys.argv[2:])")


def test_cli_two_process_predict(tmp_path):
    """Two gloo ranks through the CLI's launch flags shard the gru_att
    fixture over the global 2-shard list: rank 0's BED equals the
    reference BED, rank 1 writes none."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outs = [tmp_path / f"rank{rank}.bed" for rank in range(2)]
    worker.run_ranks(
        [sys.executable, "-c", _CLI, os.path.dirname(HERE), *REF_ARGS,
         "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(rank), "predict",
         os.path.join(TORCH_FIXDIR, "gru_att.npz"),
         os.path.join(FIXDIR, "gru_att.fa"), "--output", str(outs[rank])]
        for rank in range(2))
    rows = [line.split("\t", 1)[1]
            for line in outs[0].read_text().splitlines()]
    assert rows == expected_rows("gru_att")
    assert not outs[1].exists()
