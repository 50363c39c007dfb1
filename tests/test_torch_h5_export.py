"""The port's Keras HDF5 writer (``save_model_h5``) against the JAX
package: the file it writes loads in the port and in the JAX package with
the same config and the same parameters bit for bit, and in ``tf_keras``
(as the reference loads its models) with the JAX forward's probabilities;
``train --modelfile x.h5`` writes a model that ``predict`` reads."""

import json
import re
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import h5py  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.models import keras_io as jax_keras_io  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.models import keras_io  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import ModelConfig  # noqa: E402

ARCHS = [("GRU", True), ("GRU", False), ("LSTM", False)]


def make(rnn_type, attention, seed=0):
    """A small model of each architecture: (port config, port params, JAX
    config, JAX params)."""
    jax_cfg = jax_model.ModelConfig(vecsize=24, units=6, rnn=rnn_type,
                                    attention=attention, dropout=0.0928)
    params = jax.device_get(jax_model.init_params(jax.random.PRNGKey(seed),
                                                  jax_cfg))
    return (ModelConfig(**jax_cfg.__dict__), params_from_jax(params),
            jax_cfg, params)


@pytest.mark.parametrize("rnn_type,attention", ARCHS)
def test_port_h5_loads_bitwise_in_both_packages(tmp_path, rnn_type,
                                                attention):
    config, params, jax_cfg, jax_params = make(rnn_type, attention)
    path = str(tmp_path / "model.h5")
    keras_io.save_model_h5(path, config, params)
    got_cfg, got = keras_io.load_keras_h5(path)
    assert got_cfg == config
    assert sorted(got) == sorted(params)
    for key in params:
        assert torch.equal(got[key], params[key]), key
    jax_got_cfg, jax_got = jax_keras_io.load_keras_h5(path)
    assert jax_got_cfg == jax_cfg
    jax.tree.map(np.testing.assert_array_equal, jax_got, jax_params)
    assert keras_io.load_model(path)[0] == config


@pytest.mark.parametrize("rnn_type,attention", ARCHS)
def test_port_h5_layout_matches_jax_writer(tmp_path, rnn_type, attention):
    """The layer classes, the named layers, the wiring and the weight
    datasets equal those of the JAX package's ``tf_keras`` file, but for
    the layer-name suffixes ``tf_keras`` numbers from a session counter."""
    config, params, jax_cfg, jax_params = make(rnn_type, attention)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    keras_io.save_model_h5(ours, config, params)
    jax_keras_io.save_model_h5(theirs, jax_cfg, jax_params)

    def layout(path):
        """(model class, backend, the layers' JSON, {dataset: array}) with
        the numbered layer names unnumbered."""
        datasets = {}
        with h5py.File(path) as f:
            model = json.loads(f.attrs["model_config"])
            f["model_weights"].visititems(
                lambda name, obj: datasets.__setitem__(name, obj[()])
                if isinstance(obj, h5py.Dataset) else None)
            backend = f.attrs["backend"]
        layers = re.sub(r'"(input|reverse_complement|average|softmax)_\d+"',
                        r'"\1"', json.dumps(model["config"]["layers"],
                                             sort_keys=True))
        return model["class_name"], backend, layers, datasets

    got, want = layout(ours), layout(theirs)
    assert got[:3] == want[:3]
    assert sorted(got[3]) == sorted(want[3])
    for key in want[3]:
        np.testing.assert_array_equal(got[3][key], want[3][key])


@pytest.fixture(scope="module")
def tf_keras_loader():
    """``tf_keras.models.load_model`` with a stand-in of the reference's
    ``ReverseComplement`` (``model.py:240-290``), as a reference user
    loads a model."""
    tf_keras = pytest.importorskip("tf_keras")
    import tensorflow as tf

    class ReverseComplement(tf_keras.layers.Layer):
        def __init__(self, complements, **kwargs):
            super().__init__(**kwargs)
            self._indices = complements

        def call(self, inputs):
            return tf.gather(tf.reverse(inputs, axis=[1]), self._indices,
                             axis=2)

        def get_config(self):
            return {**super().get_config(), "complements": self._indices}

    def load(path):
        return tf_keras.models.load_model(
            path, compile=False,
            custom_objects={"ReverseComplement": ReverseComplement})

    return load


@pytest.mark.parametrize("rnn_type,attention", ARCHS)
def test_tf_keras_predicts_jax_probabilities(tmp_path, tf_keras_loader,
                                             rnn_type, attention):
    config, params, jax_cfg, jax_params = make(rnn_type, attention)
    path = str(tmp_path / "model.h5")
    keras_io.save_model_h5(path, config, params)
    loaded = tf_keras_loader(path)
    assert loaded.input_shape[1] == config.vecsize
    rng = np.random.default_rng(1)
    x = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=(8, 24))]
    theirs = loaded.predict_on_batch(x)
    want = np.asarray(jax_model.DeepGRPModel(jax_cfg).apply(jax_params, x))
    np.testing.assert_allclose(theirs, want, atol=1e-5)


def write_training_files(tmp_path):
    """A tiny chromosome pair (one-hot ``.npz``), its BED and a TOML."""
    from deepgrp_tpu_torch.config import Options

    toml = tmp_path / "params.toml"
    with open(toml, "w") as fh:
        Options(vecsize=20, units=4, attention=True, n_epochs=1,
                n_batches=2, repeats_to_search=[1, 2]).to_toml(fh)
    rng = np.random.default_rng(0)
    rows = []
    for chrom in ("chrT", "chrV"):
        codes = rng.integers(0, 4, 600)
        np.savez(tmp_path / f"{chrom}.fa.npz",
                 fwd=np.eye(5, dtype=np.int8)[codes].T)
        rows += [f"{chrom}\t100\t180\t1\n", f"{chrom}\t300\t420\t2\n"]
    (tmp_path / "rep.bed").write_text("".join(rows))
    return [str(toml), str(tmp_path / "chrT.fa.npz"),
            str(tmp_path / "chrV.fa.npz"), str(tmp_path / "rep.bed")]


@pytest.mark.parametrize("suffix", [".h5", ".hdf5"])
def test_cli_train_writes_h5_that_predict_reads(tmp_path, suffix):
    model_path = str(tmp_path / f"model{suffix}")
    cli.main(["--device", "cpu", "-b", "8", "train",
              *write_training_files(tmp_path), "--honor-toml", "--logdir",
              str(tmp_path / "log"), "--modelfile", model_path,
              "--no-tensorboard"])
    with open(model_path, "rb") as fh:
        assert fh.read(8).startswith(b"\x89HDF")
    config, params = keras_io.load_model(model_path)
    assert (config.vecsize, config.units, config.attention) == (20, 4, True)
    assert all(torch.isfinite(v).all() for v in params.values())
    fasta = tmp_path / "in.fa"
    fasta.write_text(">r1\n" + "ACGT" * 100 + "\n")
    out = tmp_path / "out.bed"
    cli.main(["--device", "cpu", "predict", model_path, str(fasta),
              "--output", str(out)])
    assert out.exists()


def test_save_model_h5_without_h5py_names_it(tmp_path, monkeypatch):
    config, params, _, _ = make("GRU", True)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        keras_io.save_model_h5(str(tmp_path / "m.h5"), config, params)
    assert not (tmp_path / "m.h5").exists()
