"""The port's evaluation slice against the JAX package: the merged-
probability track (``PredictionEngine.predict``), ``predict -m``,
``predict_complete``, ``apply_mss``, ``filter_segments`` and
``evaluate_trained``.

Inputs come from numpy seeds, weights from the JAX package's initialiser
through ``params_from_jax``; the port runs on the CPU (the kernels' plain
versions), the JAX package on its CPU routes.  Tolerances are stated per
test.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu import cli as jax_cli  # noqa: E402
from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.data.preprocess import Data as JaxData  # noqa: E402
from deepgrp_tpu.hpo import optimization as jax_opt  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.ops import segments as jax_segments  # noqa: E402
from deepgrp_tpu.predict import engine as jax_engine  # noqa: E402
from deepgrp_tpu.predict import postprocess as jax_post  # noqa: E402
from deepgrp_tpu_torch import cli  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.preprocess import Data  # noqa: E402
from deepgrp_tpu_torch.hpo.optimization import evaluate_trained  # noqa: E402
from deepgrp_tpu_torch.models.convert import (params_from_jax,  # noqa: E402
                                              params_to_jax)
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig)
from deepgrp_tpu_torch.ops.segments import filter_segments  # noqa: E402
from deepgrp_tpu_torch.predict import postprocess  # noqa: E402
from deepgrp_tpu_torch.predict.engine import PredictionEngine  # noqa: E402
from deepgrp_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "fixtures", "torch")
REF_ARGS = ["-b", "64", "-s", "50", "-x", "50", "-l", "50"]
ATOL = 1e-6


@pytest.fixture(scope="module", params=["GRU", "LSTM"])
def small_models(request):
    config = ModelConfig(vecsize=30, units=8, rnn=request.param,
                         attention=request.param == "GRU", dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(7), jax_cfg)
    port = DeepGRPModel.from_params(config, params_from_jax(params),
                                    device="cpu")
    return port, jax_model.DeepGRPModel(jax_cfg), params


def random_codes(seed, length):
    return np.random.default_rng(seed).integers(
        0, 5, size=length).astype(np.int8)


# -- the merged-probability track -------------------------------------------


@pytest.mark.parametrize("route", ["fused", "scan"])
@pytest.mark.parametrize("seq_len,batch,step,out_len", [
    (233, 7, 10, None), (29, 7, 10, None), (120, 5, 45, 150),
    (301, 3, 13, 280), (95, 4, 10, 140)])
def test_engine_predict_matches_jax(small_models, route, seq_len, batch,
                                    step, out_len):
    """``predict`` equals the JAX engine's ``predict`` (its scan route on
    the CPU) at atol 1e-6, on both of the port's routes: a partial last
    chunk, a sequence shorter than vecsize (all zeros), a spill longer than
    the block, ``out_len`` longer and shorter than L."""
    port, jax_mdl, params = small_models
    codes = random_codes(seq_len + 3, seq_len)
    want = jax_engine.PredictionEngine(
        jax_mdl, batch_size=batch, step_size=step,
        rnn_kernel="scan").predict(params, codes, out_len=out_len)
    got = PredictionEngine(port, batch_size=batch, step_size=step,
                           rnn_kernel=route).predict(codes, out_len=out_len)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if seq_len <= port.config.vecsize:
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["fused", "scan"])
def test_engine_predict_rows_give_the_scored_track(small_models, dtype,
                                                   route):
    """The track's row argmax and row max equal ``predict_scored``'s
    classes and max probability bit for bit, in both modes.  In bfloat16
    the track is float32 holding bfloat16 values, the dtype the JAX
    engine's ``predict`` gives it."""
    port, jax_mdl, params = small_models
    codes = random_codes(11, 260)
    engine = PredictionEngine(port, batch_size=6, step_size=10,
                              compute_dtype=dtype, rnn_kernel=route)
    track = engine.predict(codes)
    classes, maxp = engine.predict_scored(codes)
    np.testing.assert_array_equal(track.argmax(axis=1), classes)
    np.testing.assert_array_equal(track.max(axis=1), maxp)
    want = jax_engine.PredictionEngine(
        jax_mdl, batch_size=6, step_size=10,
        compute_dtype=(jnp.bfloat16 if dtype == torch.bfloat16
                       else jnp.float32),
        rnn_kernel="scan").predict(params, codes)
    assert track.dtype == want.dtype == np.float32
    if dtype == torch.bfloat16:
        as_bf16 = torch.from_numpy(track).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(track, as_bf16)


def test_softmax_and_apply_mss_match_jax():
    """``softmax`` and ``apply_mss`` equal the JAX package's exactly on the
    same probabilities."""
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(3) * 0.3, size=800).astype(np.float32)
    probs[:40] = 0.0
    options = Options(min_mss_len=5, xdrop_len=5)
    jax_options = JaxOptions(min_mss_len=5, xdrop_len=5)
    np.testing.assert_array_equal(postprocess.softmax(probs),
                                  jax_post.softmax(probs))
    got = postprocess.apply_mss(probs, options)
    want = jax_post.apply_mss(probs, jax_options)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- predict_complete and predict -m ----------------------------------------


def make_tiny_data(seed=0, length=1500):
    """``tests/test_hpo.py``'s tiny data: random codes with class-1 poly-A
    runs; one-hot ``fwd [5, L]`` and labels ``[3, L]``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length)
    truelbl = np.zeros((3, length), dtype=np.int8)
    for start in range(100, length - 100, 400):
        codes[start:start + 80] = 0
        truelbl[1, start:start + 80] = 1
    truelbl[0] = truelbl[1:].sum(axis=0) == 0
    fwd = np.zeros((5, length), dtype=np.int8)
    fwd[codes, np.arange(length)] = 1
    return fwd, truelbl


def tiny_options(**kwargs):
    base = dict(vecsize=20, units=4, batch_size=8, n_epochs=2, n_batches=2,
                early_stopping_th=3, dropout=0.0, repeats_to_search=[1, 2],
                min_mss_len=10, xdrop_len=10)
    base.update(kwargs)
    return base


def tiny_params(rnn_type, seed=13):
    options = tiny_options(rnn=rnn_type, attention=rnn_type == "GRU")
    jax_cfg = jax_model.ModelConfig.from_options(JaxOptions(**options))
    return options, jax_model.init_params(jax.random.PRNGKey(seed), jax_cfg)


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
@pytest.mark.parametrize("use_mss", [False, True])
@pytest.mark.parametrize("from_checkpoint", [False, True])
def test_predict_complete_matches_jax(tmp_path, rnn_type, use_mss,
                                      from_checkpoint):
    """``predict_complete`` equals the JAX package's: the softmaxed track
    at atol 1e-6, the MSS labels exactly; with the weights given or read
    from the latest checkpoint in the logdir (written by the port's
    checkpoint manager).  The labels are one position longer than the
    sequence, so ``out_len`` exceeds L."""
    options, params = tiny_params(rnn_type)
    fwd, truelbl = make_tiny_data(6)
    truelbl = np.concatenate([truelbl, truelbl[:, :1]], axis=1)
    if from_checkpoint:
        CheckpointManager(tmp_path).save(1, params_to_jax(
            params_from_jax(params)))
    got = postprocess.predict_complete(
        10, Options(**options), tmp_path, Data(fwd, truelbl),
        use_mss=use_mss,
        params=None if from_checkpoint else params_from_jax(params),
        device="cpu")
    want = jax_post.predict_complete(
        10, JaxOptions(**options), tmp_path, JaxData(fwd, truelbl),
        use_mss=use_mss, params=None if from_checkpoint else params)
    assert got.shape == want.shape == (truelbl.shape[1], 3)
    if use_mss:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gru_att", "gru", "lstm"])
def test_cli_no_use_mss_matches_jax(name, tmp_path):
    """``predict -m --device cpu`` writes the BED rows of the JAX package's
    ``predict -m`` (``predict_sequence(use_mss=False)``) on each
    fixture."""
    fasta = os.path.join(FIXDIR, f"{name}.fa")
    got_path, want_path = tmp_path / "port.bed", tmp_path / "jax.bed"
    cli.main(REF_ARGS + ["--device", "cpu", "predict",
                         os.path.join(TORCH_FIXDIR, f"{name}.npz"), fasta,
                         "-m", "--output", str(got_path)])
    jax_cli.main(REF_ARGS + ["predict", os.path.join(FIXDIR, f"{name}.h5"),
                             fasta, "-m", "--mesh", "off",
                             "--output", str(want_path)])
    got = got_path.read_text().splitlines()
    want = want_path.read_text().splitlines()
    assert want, "the JAX package wrote no rows"
    assert got == want
    with open(os.path.join(FIXDIR, f"{name}.bed")) as fh:
        assert got != fh.read().splitlines()  # -m is not the MSS route


# -- filter_segments and evaluate_trained ------------------------------------


@pytest.mark.parametrize("seed,length,min_len", [
    (0, 500, 50), (1, 1000, 10), (2, 1, 5), (3, 0, 5), (4, 300, 1),
    (5, 2000, 120)])
def test_filter_segments_matches_jax(seed, length, min_len):
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 60, size=length)
    labels = rng.integers(0, 4, size=length)
    track = np.repeat(labels, runs)[:length].astype(np.int64)
    got, want = track.copy(), track.copy()
    filter_segments(got, min_len)
    jax_segments.filter_segments(want, min_len)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
@pytest.mark.parametrize("mismatch", [False, True])
def test_evaluate_trained_matches_jax(tmp_path, rnn_type, mismatch):
    """The metrics dict of ``evaluate_trained`` equals the JAX package's
    on the same converted weights, every key exactly (NaN entries too):
    the scored route, and the full-matrix route that a length mismatch
    between ``fwd`` and ``truelbl`` takes."""
    options, params = tiny_params(rnn_type, seed=11)
    fwd, truelbl = make_tiny_data(6)
    if mismatch:
        fwd = fwd[:, :-7]
    got = evaluate_trained(Options(**options), 10, tmp_path,
                           Data(fwd, truelbl), params_from_jax(params),
                           device="cpu")
    want = jax_opt.evaluate_trained(JaxOptions(**options), 10, tmp_path,
                                    JaxData(fwd, truelbl), params)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
