"""The port's model (head, forward, weights IO) against the JAX package.

Random parameters come from the JAX package's initializer and reach the
port through ``params_from_jax``; code windows come from a numpy seed.
Tolerances are stated per test.
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
from deepgrp_tpu_torch.data.fasta import read_multi_fasta  # noqa: E402
from deepgrp_tpu_torch.models import keras_io  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig,
                                            forward_probs_from_codes)
from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "fixtures", "torch")
NAMES = ["gru_att", "gru", "lstm"]


def jax_config(config: ModelConfig):
    return jax_model.ModelConfig(**config.todict())


@pytest.mark.parametrize("rnn,attention,units", [("GRU", True, 6),
                                                 ("GRU", False, 8),
                                                 ("LSTM", False, 5)])
def test_forward_probs_matches_jax(rnn, attention, units):
    """Port forward == JAX fused forward (Pallas in interpret mode) on the
    same random parameters; atol 1e-5 (float32 recurrence rounding)."""
    config = ModelConfig(vecsize=30, units=units, rnn=rnn,
                         attention=attention, dropout=0.0)
    params = jax_model.init_params(jax.random.PRNGKey(units),
                                   jax_config(config))
    codes = np.random.default_rng(units).integers(
        0, 6, size=(4, config.vecsize)).astype(np.int8)
    want = np.asarray(jax_model.forward_probs_from_codes(
        params, jnp.asarray(codes.astype(np.int32)), jax_config(config)))
    got = forward_probs_from_codes(params_from_jax(params),
                                   torch.from_numpy(codes), config)
    assert got.shape == want.shape == (4, config.vecsize, config.n_classes)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_model_module_matches_function():
    config = ModelConfig(vecsize=20, units=4, attention=True)
    params = params_from_jax(jax_model.init_params(
        jax.random.PRNGKey(1), jax_config(config)))
    model = DeepGRPModel.from_params(config, params, device="cpu")
    assert set(model.state_dict()) == set(config.param_shapes())
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, 5, size=(3, 20)).astype(np.int8))
    assert torch.equal(model.forward_probs_from_codes(codes),
                       forward_probs_from_codes(params, codes, config))


def test_model_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepGRPModel(ModelConfig())


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference_probs(name):
    """Reference-trained weights: the port's forward matches the recorded
    reference probabilities at the tolerance of
    tests/test_reference_parity.py (atol 5e-4, rtol 1e-3)."""
    man = json.load(open(os.path.join(FIXDIR, "manifest.json")))
    config, params = keras_io.load_model(
        os.path.join(TORCH_FIXDIR, f"{name}.npz"))
    with open(os.path.join(FIXDIR, f"{name}.fa")) as fh:
        _, seq = next(read_multi_fasta(fh))
    _, codes = encode_codes_trimmed(seq)
    step = man["step_size"]
    wins = np.stack([codes[s:s + config.vecsize]
                     for s in range(0, man["n_prob_windows"] * step, step)])
    got = forward_probs_from_codes(params, torch.from_numpy(wins), config)
    ref = np.load(os.path.join(FIXDIR, f"{name}_probs.npy"))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("name", NAMES)
def test_npz_fixture_equals_h5(name):
    """The committed .npz copies equal their .h5 source array for array
    (exactly), so the two cannot drift."""
    config_h5, params_h5 = keras_io.load_keras_h5(
        os.path.join(FIXDIR, f"{name}.h5"))
    config_npz, params_npz = keras_io.load_model(
        os.path.join(TORCH_FIXDIR, f"{name}.npz"))
    assert config_npz == config_h5
    assert set(params_npz) == set(params_h5)
    for key in params_h5:
        assert torch.equal(params_npz[key], params_h5[key]), key


@pytest.mark.parametrize("name", NAMES)
def test_h5_import_matches_jax(name):
    """The port's Keras import equals the JAX package's, mapped through
    params_from_jax (exactly)."""
    path = os.path.join(FIXDIR, f"{name}.h5")
    config, params = keras_io.load_keras_h5(path)
    jax_cfg, jax_params = jax_keras_io.load_keras_h5(path)
    assert config.todict() == jax_cfg.__dict__
    want = params_from_jax(jax_params)
    assert set(params) == set(want)
    for key in want:
        assert torch.equal(params[key], want[key]), key


def test_npz_round_trip(tmp_path):
    config = ModelConfig(vecsize=12, units=3, rnn="LSTM")
    params = params_from_jax(jax_model.init_params(
        jax.random.PRNGKey(0), jax_config(config)))
    path = str(tmp_path / "m.npz")
    keras_io.save_model_npz(path, config, params)
    got_config, got = keras_io.load_model(path)
    assert got_config == config
    for key in params:
        assert torch.equal(got[key], params[key])


def test_load_rejects_mismatched_params(tmp_path):
    config = ModelConfig(vecsize=12, units=3)
    params = params_from_jax(jax_model.init_params(
        jax.random.PRNGKey(0), jax_config(config)))
    params["rnn.recurrent"] = params["rnn.recurrent"][:, :-1]
    path = str(tmp_path / "bad.npz")
    keras_io.save_model_npz(path, config, params)
    with pytest.raises(ValueError, match="rnn.recurrent"):
        keras_io.load_model(path)


@pytest.mark.parametrize("rnn,attention", [("GRU", True), ("LSTM", False)])
def test_loads_jax_package_model_files(tmp_path, rnn, attention):
    """A model file written by the JAX package (``/``-keyed arrays) loads
    in the port and gives the same probabilities (exactly) as the port's
    own ``.npz`` of the same weights."""
    config = ModelConfig(vecsize=16, units=5, rnn=rnn, attention=attention)
    jax_params = jax_model.init_params(jax.random.PRNGKey(4),
                                       jax_config(config))
    jax_path = str(tmp_path / "jax.npz")
    jax_keras_io.save_model_npz(jax_path, jax_config(config), jax_params)
    port_path = str(tmp_path / "port.npz")
    keras_io.save_model_npz(port_path, config, params_from_jax(jax_params))
    got_config, got = keras_io.load_model(jax_path)
    want_config, want = keras_io.load_model(port_path)
    assert got_config == want_config == config
    assert set(got) == set(want)
    codes = torch.from_numpy(np.random.default_rng(1).integers(
        0, 6, size=(3, 16)).astype(np.int8))
    assert torch.equal(forward_probs_from_codes(got, codes, config),
                       forward_probs_from_codes(want, codes, config))
