"""The port's streaming host MSS (``ops/mss.py:SplitScanner``,
``predict/engine.py:ScoredTrack.host_mss_classes``) against the JAX
package and against the whole-array search, on the CPU.

The scanner must report the JAX scanner's split points on the same tracks
for any feed boundaries and ``min_gap``, and labelling the blocks it closes
must give the whole-array labels exactly; the streaming route must give
the whole-array route's classes at any thread count, and ``predict_sequence``
on every route the JAX package's ``device_mss=False`` classes (float32:
exact), including the zero-window quirk and an uncovered tail.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.ops import mss as jax_mss  # noqa: E402
from deepgrp_tpu.predict import engine as jax_engine  # noqa: E402
from deepgrp_tpu.predict import postprocess as jax_post  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig)
from deepgrp_tpu_torch.ops import mss  # noqa: E402
from deepgrp_tpu_torch.predict import engine as engine_lib  # noqa: E402
from deepgrp_tpu_torch.predict.engine import PredictionEngine  # noqa: E402
from deepgrp_tpu_torch.predict.postprocess import \
    predict_sequence  # noqa: E402

S0 = math.log(0.99 / (1.0 - 0.99))
ROUTES = ["auto", "on", "off"]


def random_scores(rng, n):
    """Scores shaped like the transform's: +t on repeats, -10 t else, with
    planted non-positive stretches so that X-drop resets occur."""
    t = rng.uniform(0.1, S0, size=n)
    scores = np.where(rng.random(n) < 0.3, t, -10 * t)
    for _ in range(6):
        start = int(rng.integers(0, n - 300))
        scores[start:start + 300] = -np.abs(scores[start:start + 300])
    return scores


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("min_gap", [1, 700, 5000])
def test_split_scanner_matches_jax(seed, min_gap):
    """The same split points as the JAX scanner across random feed
    boundaries, and the blocks' labels equal the whole-array labels."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3000, 20000))
    scores = random_scores(rng, n)
    labels = rng.integers(0, 5, size=n)
    min_len, xdrop_len = 25, 10
    xdrop = S0 * xdrop_len * 10.0
    assert mss.mss_thresholds(min_len, xdrop_len)[1] == xdrop
    port = mss.SplitScanner(xdrop, min_gap=min_gap)
    ref = jax_mss.SplitScanner(xdrop, min_gap=min_gap)
    track = scores.astype(np.float32)
    splits = []
    for upto in sorted(set(rng.integers(1, n, size=12).tolist() + [n])):
        got = port.feed(track, upto)
        assert got == ref.feed(track, upto)
        splits += got
    assert splits == sorted(splits)
    if min_gap == 1:
        assert splits, "the planted stretches must give splits"
    out = np.empty(n, np.int32)
    edges = [0] + splits + [n]
    for lo, hi in zip(edges[:-1], edges[1:]):
        mss.streaming_mss_block_classes(scores, labels, out, lo, hi, 5,
                                        min_len, xdrop_len)
    np.testing.assert_array_equal(
        out, mss.find_mss_classes(scores, labels, 5, min_len, xdrop_len))


def test_split_scanner_needs_xdrop():
    scanner = mss.SplitScanner(-1.0, min_gap=1)
    assert scanner.feed(-np.ones(100, np.float32), 100) == []


@pytest.fixture(scope="module", params=["GRU", "LSTM"])
def small_models(request):
    config = ModelConfig(vecsize=30, units=8, rnn=request.param,
                         attention=request.param == "GRU", dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(0), jax_cfg)
    port = DeepGRPModel.from_params(config, params_from_jax(params),
                                    device="cpu")
    return port, jax_model.DeepGRPModel(jax_cfg), params


def random_codes(seed, length):
    codes = np.random.default_rng(seed).integers(0, 5, size=length)
    return codes.astype(np.int8)


class RecordingScanner(mss.SplitScanner):
    """The scanner at a small ``min_gap``, recording its splits and feeds."""

    splits: list = []
    feeds: list = []

    def __init__(self, xdrop):
        super().__init__(xdrop, min_gap=100)

    def feed(self, scores, upto):
        out = super().feed(scores, upto)
        RecordingScanner.feeds.append(upto)
        RecordingScanner.splits += out
        return out


@pytest.fixture(scope="module")
def noisy_gru():
    """The small GRU with attention and random weights: its track has
    positive runs between long non-positive stretches (the LSTM's is all
    non-positive but for the uncovered tail, so it has no split)."""
    config = ModelConfig(vecsize=30, units=8, rnn="GRU", attention=True,
                         dropout=0.0)
    params = jax_model.init_params(jax.random.PRNGKey(0),
                                   jax_model.ModelConfig(**config.todict()))
    return DeepGRPModel.from_params(config, params_from_jax(params), "cpu")


@pytest.mark.parametrize("threads", [1, 0])
def test_streaming_route_equals_off(noisy_gru, monkeypatch, threads):
    """A noisy multi-slice track through the streaming route, with
    mid-track splits (``min_gap`` 100), equals the whole-array route."""
    port = noisy_gru
    monkeypatch.setattr(mss, "SplitScanner", RecordingScanner)
    RecordingScanner.splits, RecordingScanner.feeds = [], []
    codes = random_codes(42, 6000)
    options = Options(vecsize=30, batch_size=6, min_mss_len=5, xdrop_len=2)
    engine = PredictionEngine(port, batch_size=6, step_size=10)
    want = predict_sequence(engine, codes, options, threads=threads,
                            device_mss="off")
    got = predict_sequence(engine, codes, options, threads=threads,
                           device_mss="auto")
    np.testing.assert_array_equal(got, want)
    # 597 windows in 100 chunks: 25 slices, each fed as it landed.
    assert len(RecordingScanner.feeds) == 25
    assert len(RecordingScanner.splits) > 3


def test_streaming_route_without_xdrop(small_models):
    """``xdrop_len <= 0`` (no split exists) takes the whole array."""
    port, _, _ = small_models
    codes = random_codes(5, 900)
    options = Options(vecsize=30, batch_size=6, min_mss_len=5, xdrop_len=0)
    engine = PredictionEngine(port, batch_size=6, step_size=10)
    np.testing.assert_array_equal(
        predict_sequence(engine, codes, options, device_mss="auto"),
        predict_sequence(engine, codes, options, device_mss="off"))


def test_track_slices_cover_the_rows(small_models):
    """The slices tile the track in order, ``SLICE_CHUNKS`` chunks each
    and the last one ending with the final spill; ``predict_scored`` is the
    track's host reading."""
    port, _, _ = small_models
    codes = random_codes(8, 2000)
    engine = PredictionEngine(port, batch_size=6, step_size=10)
    track = engine.scored_tracks(codes)
    queued = list(track.enqueue())
    assert queued == list(range(len(track.slices)))
    edges = [lo for lo, _ in track.slices] + [track.slices[-1][1]]
    assert edges[0] == 0 and edges[-1] == track.rows.rows
    assert all(hi - lo == engine_lib.SLICE_CHUNKS * 60
               for lo, hi in track.slices[:-1])
    assert all(a[1] == b[0] for a, b in zip(track.slices, track.slices[1:]))
    classes, maxp = track.host_scored()
    want_c, want_p = engine.predict_scored(codes)
    np.testing.assert_array_equal(classes, want_c)
    np.testing.assert_array_equal(maxp, want_p)


# Lengths: a multi-slice track; one whose track stops 3 rows short of the
# sequence (233: 21 windows fill 3 chunks of 7, the uncovered tail lies past
# the track); one that ends inside the last chunk; zero windows (25, 30).
@pytest.mark.parametrize("seq_len", [1200, 233, 400, 30, 25])
@pytest.mark.parametrize("route", ROUTES)
def test_predict_sequence_routes_match_jax(small_models, seq_len, route):
    """Every route equals the JAX package's host route, with the
    zero-window quirk (all class 1) and the uncovered tail."""
    port, jax_mdl, params = small_models
    codes = random_codes(seq_len + 3, seq_len)
    options = Options(vecsize=30, batch_size=7, min_mss_len=5, xdrop_len=3)
    engine = PredictionEngine(port, batch_size=7, step_size=10)
    got = predict_sequence(engine, codes, options, device_mss=route)
    want = jax_post.predict_sequence(
        jax_mdl, params, codes, JaxOptions(vecsize=30, batch_size=7,
                                           min_mss_len=5, xdrop_len=3),
        10, True, device_mss="off")
    np.testing.assert_array_equal(np.asarray(got, np.int64),
                                  np.asarray(want, np.int64))
    if seq_len <= 30:
        assert (np.asarray(got) == 1).all()
    if seq_len == 233:
        track = engine.scored_tracks(codes)
        assert track.rows.rows == 230 < seq_len


def test_predict_sequence_accepts_bools_and_refuses_unknown(small_models):
    port, _, _ = small_models
    codes = random_codes(1, 300)
    options = Options(vecsize=30, batch_size=7, min_mss_len=5, xdrop_len=3)
    engine = PredictionEngine(port, batch_size=7, step_size=10)
    want = predict_sequence(engine, codes, options, device_mss="off")
    for flag in (True, False):
        np.testing.assert_array_equal(
            predict_sequence(engine, codes, options, device_mss=flag), want)
    with pytest.raises(ValueError, match="device_mss"):
        predict_sequence(engine, codes, options, device_mss="sometimes")


def test_streaming_pool_is_made_per_call(small_models, monkeypatch):
    """Each call makes its own pool, of ``threads`` workers (0: auto), and
    its own reader."""
    port, _, _ = small_models
    sizes = []
    real = engine_lib.ThreadPoolExecutor

    def pool(workers):
        sizes.append(workers)
        return real(workers)

    monkeypatch.setattr(engine_lib, "ThreadPoolExecutor", pool)
    codes = random_codes(3, 700)
    options = Options(vecsize=30, batch_size=7, min_mss_len=5, xdrop_len=3)
    engine = PredictionEngine(port, batch_size=7, step_size=10)
    for threads in (1, 3, 0):
        predict_sequence(engine, codes, options, threads=threads)
    assert sizes == [1, 1, 3, 1, mss.default_threads(700), 1]


def test_cli_device_mss_flag_parses():
    from deepgrp_tpu_torch import cli

    parser = cli.build_parser()
    base = ["predict", "m.npz", "x.fa"]
    assert parser.parse_args(base).device_mss == "auto"
    assert parser.parse_args(base + ["--device-mss"]).device_mss == "on"
    assert parser.parse_args(base + ["--device-mss", "off"]).device_mss \
        == "off"
    with pytest.raises(SystemExit):
        parser.parse_args(base + ["--device-mss", "maybe"])



@pytest.mark.parametrize("seed", range(3))
def test_score_transform_matches_jax_bitwise(seed):
    """The transform, in place or into ``out``, gives the JAX package's
    float32 bits, across the clamp at 0.99 and at zero probability."""
    rng = np.random.default_rng(seed)
    n = 50000
    classes = rng.integers(0, 5, n).astype(np.int8)
    maxp = rng.uniform(0.0, 1.0, n).astype(np.float32)
    maxp[::7] = np.float32(0.99) - np.float32(1e-6)
    maxp[::11] = 0.0
    maxp[::13] = 1.0
    want = jax_engine.mss_score_transform(classes, maxp)
    got = engine_lib.mss_score_transform(classes, maxp)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    out = np.full(n + 4, np.nan, np.float32)
    engine_lib.mss_score_transform(classes, maxp, out=out[2:-2])
    np.testing.assert_array_equal(out[2:-2].view(np.int32),
                                  want.view(np.int32))
    assert np.isnan(out[:2]).all() and np.isnan(out[-2:]).all()
