"""The port's prediction engine and CLI against the JAX package and the
reference BEDs (on the CPU, through the kernels' plain versions)."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.predict import engine as jax_engine  # noqa: E402
from deepgrp_tpu.predict import postprocess as jax_post  # noqa: E402
from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig)
from deepgrp_tpu_torch.predict.engine import PredictionEngine  # noqa: E402
from deepgrp_tpu_torch.predict.postprocess import \
    predict_sequence  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "fixtures", "torch")
REF_ARGS = ["-b", "64", "-s", "50", "-x", "50", "-l", "50"]


@pytest.fixture(scope="module", params=[
    ("GRU", 8), ("LSTM", 8),
    # A width the kernels serve on a cluster of 16 CTAs (ragged: 19 units
    # a CTA).
    ("GRU", 300), ("LSTM", 300)],
    ids=["GRU", "LSTM", "GRU-u300", "LSTM-u300"])
def small_models(request):
    rnn_type, units = request.param
    config = ModelConfig(vecsize=30, units=units, rnn=rnn_type,
                         attention=rnn_type == "GRU", dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(0), jax_cfg)
    port = DeepGRPModel.from_params(config, params_from_jax(params),
                                    device="cpu")
    return port, jax_model.DeepGRPModel(jax_cfg), params


def random_codes(seed, length):
    codes = np.random.default_rng(seed).integers(0, 5, size=length)
    return codes.astype(np.int8)


@pytest.mark.parametrize("seq_len,batch,step", [
    (200, 7, 10), (233, 7, 10), (30, 7, 10), (29, 7, 10), (95, 4, 10),
    (140, 7, 10), (301, 3, 13), (120, 5, 45)])
def test_engine_scored_matches_jax(small_models, seq_len, batch, step):
    """Per-position (classes, maxp) equal the JAX engine's: classes
    exactly, maxp to 1e-5 (float32 recurrence rounding).  Covers the
    partial last chunk, zero windows, a spill longer than the block
    (batch < K) and step > vecsize."""
    port, jax_mdl, params = small_models
    codes = random_codes(seq_len, seq_len)
    want_c, want_p = jax_engine.PredictionEngine(
        jax_mdl, batch_size=batch, step_size=step).predict_scored(
            params, codes)
    got_c, got_p = PredictionEngine(port, batch_size=batch,
                                    step_size=step).predict_scored(codes)
    assert got_c.dtype == np.int8 and got_p.dtype == np.float32
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)


def test_engine_past_cluster_ceiling_matches_jax():
    """The whole slice past the cluster tiles' ceilings (u=1024 in
    float32, 2048 in bf16, where a CUDA tensor runs the grid tile): a
    ``gru_att``-shaped model at u=4160
    (vecsize 16, step 8) on a 200 bp record, the port's CPU engine against
    the JAX package's engine on the same weights, made with numpy from a
    seed in the JAX package's layout and carried across by the port's
    converter: classes equal, max probability to 1e-5."""
    config = ModelConfig(vecsize=16, units=4160, rnn="GRU", attention=True,
                         dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), jax_cfg))
    rng = np.random.default_rng(4160)
    scales = {("rnn", "kernel"): 0.5,
              ("rnn", "recurrent"): config.units ** -0.5,
              ("rnn", "bias"): 0.3, ("attention", "scale"): 0.05,
              ("dense", "kernel"): (2 * config.units) ** -0.5,
              ("dense", "bias"): 0.3}
    params = {group: {name: rng.normal(0.0, scales[group, name],
                                       leaf.shape).astype(np.float32)
                      for name, leaf in leaves.items()}
              for group, leaves in shapes.items()}
    codes = random_codes(4160, 200)
    want_c, want_p = jax_engine.PredictionEngine(
        jax_model.DeepGRPModel(jax_cfg), batch_size=32,
        step_size=8).predict_scored(params, codes)
    port = DeepGRPModel.from_params(config, params_from_jax(params),
                                    device="cpu")
    got_c, got_p = PredictionEngine(port, batch_size=32,
                                    step_size=8).predict_scored(codes)
    assert got_c.shape == want_c.shape == (200,)
    assert len(np.unique(want_c)) > 1
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)


@pytest.mark.parametrize("seq_len", [400, 25])
def test_predict_sequence_matches_jax(small_models, seq_len):
    """MSS-labelled classes equal the JAX package's host-MSS route,
    including the zero-window quirk (a record shorter than vecsize is all
    class 1)."""
    port, jax_mdl, params = small_models
    codes = random_codes(seq_len + 1, seq_len)
    options = Options(vecsize=30, batch_size=6, min_mss_len=5, xdrop_len=5)
    got = predict_sequence(PredictionEngine(port, batch_size=6,
                                            step_size=10), codes, options)
    want = jax_post.predict_sequence(
        jax_mdl, params, codes, JaxOptions(vecsize=30, batch_size=6,
                                           min_mss_len=5, xdrop_len=5),
        10, True, device_mss="off")
    np.testing.assert_array_equal(got, want)
    if seq_len < 30:
        assert (got == 1).all()


def test_options_defaults_match_jax():
    jax_opts = JaxOptions()
    for field in ("vecsize", "batch_size", "min_mss_len", "xdrop_len"):
        assert getattr(Options(), field) == getattr(jax_opts, field)


@pytest.mark.parametrize("name,fmt", [("gru_att", "npz"), ("gru", "npz"),
                                      ("lstm", "npz"), ("gru_att", "h5")])
def test_cli_reproduces_reference_bed(name, fmt, tmp_path):
    """FASTA -> BED through the port's CLI on the CPU equals the reference
    BED byte for byte."""
    model = os.path.join(TORCH_FIXDIR if fmt == "npz" else FIXDIR,
                         f"{name}.{fmt}")
    out = tmp_path / f"{name}.bed"
    cli.main(REF_ARGS + ["--device", "cpu", "predict", model,
                         os.path.join(FIXDIR, f"{name}.fa"),
                         "--output", str(out)])
    rows = [line.split("\t", 1)[1] for line in out.read_text().splitlines()]
    with open(os.path.join(FIXDIR, f"{name}.bed")) as fh:
        assert "\n".join(rows) + "\n" == fh.read()


def test_cli_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["predict", os.path.join(TORCH_FIXDIR, "gru.npz"),
                  os.path.join(FIXDIR, "gru.fa"),
                  "--output", str(tmp_path / "x.bed")])


def test_cli_bfloat16_not_ported(tmp_path):
    """``--precision bfloat16 --device cpu predict`` writes a BED of the
    fixture's rows (the fast mode's quality contract is checked in
    tests/test_torch_bf16.py)."""
    out = tmp_path / "x.bed"
    cli.main(REF_ARGS + ["--precision", "bfloat16", "--device", "cpu",
                         "predict", os.path.join(TORCH_FIXDIR, "gru.npz"),
                         os.path.join(FIXDIR, "gru.fa"),
                         "--output", str(out)])
    rows = [line.split("\t") for line in out.read_text().splitlines()]
    assert rows and all(len(row) == 5 for row in rows)
    assert all(int(row[2]) < int(row[3]) and int(row[4]) > 0
               for row in rows)
