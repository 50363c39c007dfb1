"""The port's one-hot scan route against the JAX package, on the CPU.

The one-hot recurrences (``rnn.gru_apply``, ``rnn.lstm_apply``), the
CPU path of the ``dg_gru_seq`` kernel's wrapper (``cuda_rnn.gru_apply``,
against ``pallas_gru_apply`` in interpret mode), the one-hot model route
(``forward`` / ``DeepGRPModel.apply``) and the engine's scan route.  Inputs
come from numpy seeds; weights reach the port through ``params_from_jax``.
Tolerances: atol 1e-5 for the recurrences and the engine's max
probability (both sides run float32 at "highest" precision and sum in
other orders); the reference probabilities at atol 5e-4 / rtol 1e-3, as
the JAX package's own parity test (tests/test_reference_parity.py).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.models import keras_io as jax_keras_io  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.models import rnn as jax_rnn  # noqa: E402
from deepgrp_tpu.models.pallas_rnn import pallas_gru_apply  # noqa: E402
from deepgrp_tpu.predict import engine as jax_engine  # noqa: E402
from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.data.fasta import read_multi_fasta  # noqa: E402
from deepgrp_tpu_torch.models import cuda_rnn, rnn  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import (COMPLEMENT_PERM,  # noqa: E402
                                            DeepGRPModel, ModelConfig,
                                            forward, reverse_complement)
from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed  # noqa: E402
from deepgrp_tpu_torch.predict.engine import (PredictionEngine,  # noqa: E402
                                              one_hot, resolve_rnn_kernel)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "fixtures", "reference")
REF_ARGS = ["-b", "64", "-s", "50", "-x", "50", "-l", "50"]
NAMES = ["gru_att", "gru", "lstm"]
ATOL = 1e-5
# The shapes of tests/test_pallas_rnn.py:13-17 (batch, steps, units).
SHAPES = [(7, 23, 60), (8, 16, 12), (3, 5, 8)]


def random_rnn(seed, cell, batch, steps, units, channels=5):
    """Keras-layout parameters (random biases) and uniform ``x``, numpy."""
    rng = np.random.default_rng(seed)
    gates = 4 if cell == "lstm" else 3
    width = gates * units
    params = {
        "kernel": rng.normal(0.0, 0.5, (channels, width)),
        "recurrent": rng.normal(0.0, units ** -0.5, (units, width)),
        "bias": rng.normal(0.0, 0.3, (2, width) if gates == 3
                           else (width,)),
    }
    x = rng.random((batch, steps, channels))
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def port_rnn(params):
    """Numpy cell parameters through ``params_from_jax``."""
    flat = params_from_jax({"rnn": params})
    return {key.split(".")[1]: value for key, value in flat.items()}


def jnp_tree(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("batch,steps,units", SHAPES)
def test_apply_matches_jax_scan(cell, batch, steps, units):
    params, x = random_rnn(batch * steps + units, cell, batch, steps, units)
    apply_j = jax_rnn.lstm_apply if cell == "lstm" else jax_rnn.gru_apply
    with jax.default_matmul_precision("highest"):
        want_seq, want_last = apply_j(jnp_tree(params), jnp.asarray(x))
    apply_p = rnn.lstm_apply if cell == "lstm" else rnn.gru_apply
    seq, last = apply_p(port_rnn(params), torch.from_numpy(x))
    assert seq.shape == (batch, steps, units) and seq.dtype == torch.float32
    assert last.shape == (batch, units)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               atol=ATOL)


@pytest.mark.parametrize("batch,steps,units",
                         SHAPES + [(2, 4, 520), (1, 2, 2048)])
def test_gru_seq_wrapper_matches_pallas(batch, steps, units):
    """The kernel's wrapper on the CPU runs its plain version, which equals
    ``pallas_gru_apply`` in interpret mode (also at u=520, a width the
    kernel splits over a cluster of 16 CTAs, the last owning fewer
    units, and at u=2048, two units a lane)."""
    params, x = random_rnn(batch + steps + units, "gru", batch, steps, units)
    with jax.default_matmul_precision("highest"):
        want_seq, want_last = pallas_gru_apply(
            jnp_tree(params), jnp.asarray(x), interpret=True, block_b=8)
    launches = cuda_rnn.LAUNCHES.get("gru_seq")
    calls = rnn.PLAIN_CALLS.get("gru_seq")
    seq, last = cuda_rnn.gru_apply(port_rnn(params), torch.from_numpy(x))
    assert cuda_rnn.LAUNCHES.get("gru_seq") == launches
    assert rnn.PLAIN_CALLS.get("gru_seq") == calls + 1
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               atol=ATOL)


def test_gru_seq_wrapper_rejects_dropout():
    params, x = random_rnn(0, "gru", 2, 8, 8)
    with pytest.raises(ValueError, match="inference-only"):
        cuda_rnn.gru_apply(port_rnn(params), torch.from_numpy(x),
                           dropout_rate=0.5, dropout_key=object())
    # A key at rate 0 is no dropout (pallas_rnn.py:137).
    cuda_rnn.gru_apply(port_rnn(params), torch.from_numpy(x),
                       dropout_rate=0.0, dropout_key=object())


def test_gru_seq_launcher_refuses_cpu_tensors():
    params, x = random_rnn(1, "gru", 2, 5, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rnn._launch_seq(port_rnn(params), torch.from_numpy(x))


def test_reverse_complement_matches_jax():
    assert COMPLEMENT_PERM == jax_model.COMPLEMENT_PERM
    x = np.random.default_rng(2).random((3, 11, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        reverse_complement(torch.from_numpy(x)).numpy(),
        np.asarray(jax_model.reverse_complement(jnp.asarray(x))))


def test_one_hot_pads_with_zero_rows():
    codes = torch.tensor([[0, 1, 2, 3, 4, 5]], dtype=torch.int8)
    got = one_hot(codes, torch.float32)
    want = np.zeros((1, 6, 5), np.float32)
    want[0, np.arange(5), np.arange(5)] = 1.0
    np.testing.assert_array_equal(got.numpy(), want)


def test_resolve_rnn_kernel():
    assert resolve_rnn_kernel("auto") and resolve_rnn_kernel("fused")
    assert not resolve_rnn_kernel("scan")
    with pytest.raises(ValueError, match="auto"):
        resolve_rnn_kernel("pallas")


def manifest():
    with open(os.path.join(FIXDIR, "manifest.json")) as fh:
        return json.load(fh)


def fixture_windows(name, config):
    """The first ``n_prob_windows`` one-hot windows of a fixture FASTA,
    float32 ``[n, vecsize, 5]`` (as tests/test_reference_parity.py)."""
    man = manifest()
    with open(os.path.join(FIXDIR, f"{name}.fa")) as fh:
        _, seq = next(read_multi_fasta(fh))
    _, codes = encode_codes_trimmed(seq)
    data = np.eye(5, dtype=np.float32)[codes]
    step = man["step_size"]
    return np.stack([data[s:s + config.vecsize]
                     for s in range(0, man["n_prob_windows"] * step, step)])


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_and_reference(name):
    """``DeepGRPModel.apply`` and ``forward`` on the fixture weights equal
    the JAX package's one-hot ``model.apply`` (atol 1e-5) and the recorded
    reference probabilities (atol 5e-4, rtol 1e-3)."""
    jax_cfg, jax_params = jax_keras_io.load_keras_h5(
        os.path.join(FIXDIR, f"{name}.h5"))
    config = ModelConfig(**{k: getattr(jax_cfg, k) for k in
                            ModelConfig().todict()})
    wins = fixture_windows(name, config)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_model.DeepGRPModel(jax_cfg).apply(
            jax_params, jnp.asarray(wins)))
    params = params_from_jax(jax_params)
    model = DeepGRPModel.from_params(config, params, "cpu")
    calls = rnn.PLAIN_CALLS.get("gru_seq")
    got = model.apply(torch.from_numpy(wins))
    expected_calls = 0 if config.rnn == "LSTM" else 1
    assert rnn.PLAIN_CALLS.get("gru_seq") == calls + expected_calls
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(
        forward(params, torch.from_numpy(wins), config).numpy(),
        got.numpy())
    ref = np.load(os.path.join(FIXDIR, f"{name}_probs.npy"))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=1e-3)


def test_apply_logits_softmax_is_apply():
    config = ModelConfig(vecsize=12, units=5, attention=True)
    params = params_from_jax(jax_model.init_params(
        jax.random.PRNGKey(3), jax_model.ModelConfig(**config.todict())))
    model = DeepGRPModel.from_params(config, params, "cpu")
    x = torch.from_numpy(np.random.default_rng(4).random(
        (3, 12, 5)).astype(np.float32))
    torch.testing.assert_close(torch.softmax(model.apply_logits(x), -1),
                               model.apply(x), atol=0, rtol=0)


@pytest.fixture(scope="module", params=["GRU", "LSTM"])
def small_models(request):
    config = ModelConfig(vecsize=30, units=8, rnn=request.param,
                         attention=request.param == "GRU", dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(5), jax_cfg)
    port = DeepGRPModel.from_params(config, params_from_jax(params),
                                    device="cpu")
    return port, jax_model.DeepGRPModel(jax_cfg), params


@pytest.mark.parametrize("seq_len,batch,step", [
    (233, 7, 10), (29, 7, 10), (95, 4, 10), (301, 3, 13), (120, 5, 45)])
def test_engine_scan_matches_jax_scan(small_models, seq_len, batch, step):
    """The port's scan route against the JAX engine's (its route off the
    TPU): classes exactly, max probability to 1e-5."""
    port, jax_mdl, params = small_models
    codes = np.random.default_rng(seq_len).integers(
        0, 5, size=seq_len).astype(np.int8)
    want_c, want_p = jax_engine.PredictionEngine(
        jax_mdl, batch_size=batch, step_size=step,
        rnn_kernel="scan").predict_scored(params, codes)
    engine = PredictionEngine(port, batch_size=batch, step_size=step,
                              rnn_kernel="scan")
    assert not engine.fused
    got_c, got_p = engine.predict_scored(codes)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_cli_scan_reproduces_reference_bed(name, tmp_path):
    """``--rnn-kernel scan --device cpu`` gives the reference BED byte for
    byte."""
    out = tmp_path / f"{name}.bed"
    cli.main(REF_ARGS + ["--rnn-kernel", "scan", "--device", "cpu",
                         "predict",
                         os.path.join(HERE, "fixtures", "torch",
                                      f"{name}.npz"),
                         os.path.join(FIXDIR, f"{name}.fa"),
                         "--output", str(out)])
    rows = [line.split("\t", 1)[1] for line in out.read_text().splitlines()]
    with open(os.path.join(FIXDIR, f"{name}.bed")) as fh:
        assert "\n".join(rows) + "\n" == fh.read()


def test_cli_train_scan_not_ported(tmp_path):
    """``train --rnn-kernel scan`` is ported now: the CLI no longer refuses
    it, and fails here only on the absent input files (training through
    the scan route is checked in tests/test_torch_training.py)."""
    with pytest.raises(FileNotFoundError, match="p.toml"):
        cli.main(["--rnn-kernel", "scan", "--device", "cpu", "train",
                  str(tmp_path / "p.toml"), "a.npz", "b.npz", "r.bed",
                  "--modelfile", str(tmp_path / "m.npz")])

