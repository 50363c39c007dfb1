"""The port's on-device MSS (``ops/mss_device.py``) and the routes of
``predict_sequence`` that use it, on the CPU (the stack scan's plain
version), against the JAX package and the host library.

Scores on a dyadic grid (multiples of 0.25) make every prefix sum exact in
float32 and float64 alike, so there the segments must equal the JAX
module's and the host library's bit for bit; on float tracks of the
transform's shape the float64 device search must equal the host library
(its sums differ from the host's only in the last bits).  The collapsed
runs carry the prefixes in float64 where the JAX module's packed buffer
carries float32: their count, overflow, starts and ends are equal, their
prefixes equal to float32 rounding.  Every route of ``predict_sequence`` gives the
JAX package's host-route classes in float32, and the same classes as each
other in bfloat16.
"""

import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.ops import mss_device as jax_md  # noqa: E402
from deepgrp_tpu.predict import postprocess as jax_post  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.fasta import read_multi_fasta  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.keras_io import load_model  # noqa: E402
from deepgrp_tpu_torch.models.model import (DeepGRPModel,  # noqa: E402
                                            ModelConfig)
from deepgrp_tpu_torch.ops import mss, mss_device  # noqa: E402
from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed  # noqa: E402
from deepgrp_tpu_torch.parallel.predict import \
    ShardedPredictionEngine  # noqa: E402
from deepgrp_tpu_torch.predict import postprocess  # noqa: E402
from deepgrp_tpu_torch.predict.engine import PredictionEngine  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "fixtures", "torch")
S0 = math.log(0.99 / (1.0 - 0.99))


def dyadic_scores(rng, n, pos_frac=0.35, scale=8.0):
    """Mixed-sign scores on the 0.25 grid (runs and gaps)."""
    raw = rng.normal(0.0, scale, size=n)
    raw += scale * (rng.random(n) < pos_frac)
    return np.round(raw * 4.0) / 4.0


def port_segments(scores, min_score, xdrop, max_runs):
    out = mss_device.mss_find_all_device(
        torch.as_tensor(scores, dtype=torch.float64), min_score, xdrop,
        max_runs=max_runs)
    assert not bool(out.overflow)
    count = int(out.count)
    return [(int(out.starts[i]), int(out.ends[i]), float(out.scores[i]))
            for i in range(count)]


def jax_segments(scores, min_score, xdrop, max_runs):
    out = jax_md.mss_find_all_device(jnp.asarray(scores, jnp.float32),
                                     min_score, xdrop, max_runs=max_runs)
    assert not bool(out.overflow)
    return [(int(out.starts[i]), int(out.ends[i]), float(out.scores[i]))
            for i in range(int(out.count))]


def spec_segments(scores, min_score, xdrop):
    return [(s, e, v) for s, e, v in
            mss._mss_find_all_py(np.asarray(scores, np.float64), min_score,
                                 xdrop)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("xdrop", [-1.0, 30.0, 200.0])
def test_find_all_matches_jax_and_host(seed, xdrop):
    scores = dyadic_scores(np.random.default_rng(seed), 4000)
    cap = mss_device.count_positive_runs(torch.as_tensor(scores)) + 8
    got = port_segments(scores, 10.0, xdrop, cap)
    assert got == jax_segments(scores, 10.0, xdrop, cap)
    assert got == spec_segments(scores, 10.0, xdrop)
    assert got == sorted(got)  # ascending emission order


def test_find_all_min_score_truncation():
    # mss.c:35 truncates the threshold: a segment of 10.5 passes 10.9.
    scores = np.array([10.5, -50.0, 3.0])
    got = port_segments(scores, 10.9, -1.0, 8)
    assert got == jax_segments(scores, 10.9, -1.0, 8) == [(0, 1, 10.5)]


@pytest.mark.parametrize("scores", [
    np.zeros(16), -np.ones(16), np.ones(16), np.array([5.0]),
    np.array([-1.0]), np.array([], dtype=np.float64)],
    ids=["zeros", "negative", "one-run", "single", "single-neg", "empty"])
def test_find_all_edge_cases(scores):
    got = port_segments(scores, 1.0, 10.0, 16)
    assert got == jax_segments(scores, 1.0, 10.0, 16)
    assert got == spec_segments(scores, 1.0, 10.0)


@pytest.mark.parametrize("xdrop", [-1.0, 50.0])
def test_find_all_nested_candidates(xdrop):
    # A staircase: a deep stack, merges and back-pointer chains.
    parts = []
    for k in range(20):
        parts += [100.0 - 4 * k, -1.0]
    scores = np.array(parts + [500.0])
    got = port_segments(scores, 2.0, xdrop, 64)
    assert got == jax_segments(scores, 2.0, xdrop, 64)
    assert got == spec_segments(scores, 2.0, xdrop)


def numpy_candidates(scores):
    """Collapsed runs of exact (dyadic) scores, summed on the host."""
    pos = scores > 0
    starts = np.flatnonzero(pos & ~np.concatenate([[False], pos[:-1]]))
    ends = np.flatnonzero(pos & ~np.concatenate([pos[1:], [False]])) + 1
    prefix = np.cumsum(scores)
    return starts, ends, prefix[starts] - scores[starts], prefix[ends - 1]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("xdrop", [-1.0, 40.0])
def test_plain_stack_scan_matches_jax_replica(seed, xdrop):
    """The plain scan (float64) equals the JAX module's host replica
    (float32) on exact candidates."""
    starts, ends, left, right = numpy_candidates(
        dyadic_scores(np.random.default_rng(seed), 5000))
    args = (starts, ends, left, right, starts.size, 12.0, xdrop)
    got = mss_device.mss_stack_from_candidates(*args)
    want = jax_md.mss_stack_from_candidates(
        starts, ends, left.astype(np.float32), right.astype(np.float32),
        *args[4:])
    assert got == tuple(list(map(int, w)) for w in want)


def test_overflow_flag():
    scores = torch.as_tensor(np.tile([1.0, -1.0], 50))
    out = mss_device.mss_find_all_device(scores, 0.5, -1.0, max_runs=4)
    assert bool(out.overflow)
    assert not bool(mss_device.mss_find_all_device(scores, 0.5, -1.0,
                                                   max_runs=64).overflow)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("min_len,xdrop_len", [(5, 0), (5, 10), (20, 4)])
def test_labels_match_host_and_jax(seed, min_len, xdrop_len):
    rng = np.random.default_rng(seed)
    n, nof_labels = 3000, 5
    labels = rng.integers(0, nof_labels, size=n)
    t = np.round(rng.uniform(0.5, 4.5, size=n) * 4.0) / 4.0
    scores = np.where(labels > 0, t, -10.0 * t)
    got = mss_device.find_mss_labels_auto(scores, labels, nof_labels,
                                          min_len, xdrop_len)
    np.testing.assert_array_equal(
        got, mss.find_mss_labels(scores, labels, nof_labels, min_len,
                                 xdrop_len))
    np.testing.assert_array_equal(
        got, jax_md.find_mss_labels_auto(scores, labels, nof_labels,
                                         min_len, xdrop_len))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("min_len,xdrop_len", [(50, 50), (5, 2), (20, 0)])
def test_classes_match_host_on_float_tracks(seed, min_len, xdrop_len):
    """Float tracks of the transform's shape (+t on repeats, -10 t on
    background): the float64 device search equals the host library."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(5000, 30000))
    labels = rng.integers(0, 5, size=n) * (rng.random(n) < 0.3)
    t = rng.uniform(0.05, S0, size=n)
    scores = np.where(labels > 0, t, -10 * t)
    cap = mss_device.run_capacity(
        mss_device.count_positive_runs(torch.as_tensor(scores)))
    got, overflow = mss_device.mss_classes_device(
        torch.as_tensor(scores), torch.as_tensor(labels), 5, min_len,
        xdrop_len, max_runs=cap)
    assert not bool(overflow)
    np.testing.assert_array_equal(
        got.numpy(), mss.find_mss_classes(scores, labels, 5, min_len,
                                          xdrop_len))


def test_labels_majority_tie_prefers_lowest_class():
    labels = np.array([2, 0, 3, 2, 3])
    scores = np.full(5, 5.0)
    got = mss_device.find_mss_labels_auto(scores, labels, 5, 2, 0)
    np.testing.assert_array_equal(got, mss.find_mss_labels(scores, labels,
                                                           5, 2, 0))
    assert got[1, 2] == 1.0


def test_labels_capacity_padding():
    # A capacity larger than needed does not change the result.
    labels = torch.tensor([0, 1, 1, 0, 0, 2, 2, 0])
    scores = torch.tensor([-1.0, 4.0, 4.0, -30.0, -30.0, 4.0, 4.0, -1.0])
    out, overflow = mss_device.find_mss_labels_device(scores, labels, 3, 1,
                                                      1, max_runs=32)
    assert not bool(overflow)
    np.testing.assert_array_equal(
        out.numpy(), mss.find_mss_labels(scores.numpy(), labels.numpy(), 3,
                                         1, 1))


def sparse_scored(seed):
    """A scored track (classes, maxp) with few positive runs, and a length
    short of it (rows past ``out_len`` are the engine's padding)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 9000))
    classes = rng.integers(0, 5, size=n).astype(np.int8)
    maxp = rng.uniform(0.2, 1.0, size=n).astype(np.float32)
    mask = rng.random(n) < 0.9
    classes[mask] = 0
    maxp[mask] = rng.uniform(0.9, 1.0, size=int(mask.sum()))
    return classes, maxp, n - int(rng.integers(0, 400))


@pytest.mark.parametrize("seed", range(4))
def test_collapse_runs_matches_jax(seed):
    """The run collapse of the transformed track equals the JAX module's
    packed candidates: count, overflow, starts and ends exactly, the
    float64 prefixes to the JAX module's float32 rounding."""
    classes, maxp, out_len = sparse_scored(seed)
    cap = 1024
    scores, _ = mss_device.scored_to_scores(
        torch.from_numpy(classes), torch.from_numpy(maxp), out_len)
    port = mss_device.collapse_runs(scores, cap)
    want = np.asarray(jax_md.collapse_candidates_packed(
        jnp.asarray(classes), jnp.asarray(maxp), jnp.int32(out_len),
        capacity=cap))
    ref = jax_md.unpack_candidates(want, cap)
    n_runs = int(port.n_runs)
    assert (n_runs, bool(port.overflow)) == ref[:2] and 0 < n_runs <= cap
    np.testing.assert_array_equal(port.starts.numpy(), ref[2])
    np.testing.assert_array_equal(port.ends.numpy(), ref[3])
    for port_prefix, jax_prefix in zip((port.l_glob, port.r_glob), ref[4:]):
        port_prefix = port_prefix.numpy()[:n_runs]
        scale = np.abs(port_prefix).max()
        np.testing.assert_allclose(port_prefix, jax_prefix[:n_runs], rtol=0,
                                   atol=1e-5 * scale)


def host_classes(classes, maxp, out_len, options):
    """The whole-array host MSS of a scored track cut or padded to
    ``out_len`` (uncovered rows at zero probability)."""
    c = np.zeros(out_len, np.int8)
    p = np.zeros(out_len, np.float32)
    take = min(out_len, classes.size)
    c[:take], p[:take] = classes[:take], maxp[:take]
    from deepgrp_tpu_torch.predict.engine import mss_score_transform
    scores = mss_score_transform(c, p).astype(np.float64)
    return mss.find_mss_classes(scores, c.astype(np.int64), 5,
                                options.min_mss_len, options.xdrop_len)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("pad", [0, 37])
def test_device_route_matches_host(seed, pad):
    """The whole device route equals the host MSS, with the run count
    counted on the device and given exactly (as the sharded engine's sparse
    route gives it), also over an uncovered tail of ``pad`` rows past the
    track."""
    classes, maxp, out_len = sparse_scored(seed)
    out_len = classes.size + pad if pad else out_len
    options = Options(min_mss_len=20, xdrop_len=10)
    want = host_classes(classes, maxp, out_len, options)
    scored = (torch.from_numpy(classes), torch.from_numpy(maxp))
    runs = postprocess.scored_run_count(*scored, out_len)
    for given in (None, runs):
        got = postprocess.apply_mss_on_device(*scored, options, 5, out_len,
                                              runs=given)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_device_route_sized_from_counted_runs_runs_once(monkeypatch):
    """A run count from the track sizes the capacity so that every run
    fits: one search, no retry."""
    classes, maxp, out_len = sparse_scored(7)
    scored = (torch.from_numpy(classes), torch.from_numpy(maxp))
    runs = postprocess.scored_run_count(*scored, out_len)
    capacities = []
    real = mss_device.mss_classes_from_scored

    def spy(*args, max_runs):
        capacities.append(max_runs)
        return real(*args, max_runs=max_runs)

    monkeypatch.setattr(mss_device, "mss_classes_from_scored", spy)
    postprocess.apply_mss_on_device(*scored, Options(), 5, out_len, runs=runs)
    assert capacities == [mss_device.run_capacity(runs)]
    assert runs <= capacities[0]


def test_device_route_retries_after_overflow(monkeypatch):
    """A run count far too low overflows the capacity; the route doubles
    it until every run fits, and gives the host's classes."""
    rng = np.random.default_rng(1)
    classes = rng.integers(0, 5, size=6000).astype(np.int8)
    maxp = rng.uniform(0.2, 1.0, size=6000).astype(np.float32)
    options = Options(min_mss_len=5, xdrop_len=3)
    capacities = []
    real = mss_device.mss_classes_from_scored

    def spy(*args, max_runs):
        capacities.append(max_runs)
        return real(*args, max_runs=max_runs)

    monkeypatch.setattr(mss_device, "mss_classes_from_scored", spy)
    got = postprocess.apply_mss_on_device(
        torch.from_numpy(classes), torch.from_numpy(maxp), options, 5, 6000,
        runs=1)
    runs = postprocess.scored_run_count(torch.from_numpy(classes),
                                        torch.from_numpy(maxp), 6000)
    assert capacities[0] == 64 < runs <= capacities[-1]
    assert capacities == [64 << i for i in range(len(capacities))]
    np.testing.assert_array_equal(got, host_classes(classes, maxp, 6000,
                                                    options))


def test_stack_scan_on_cpu_counts_plain_calls():
    mss_device.LAUNCHES.reset()
    mss_device.find_mss_labels_auto(np.array([3.0, -9.0, 4.0]),
                                    np.array([1, 0, 2]), 3, 1, 1)
    assert mss_device.LAUNCHES.snapshot() == {"mss_stack_plain": 1}


# -- the routes of predict_sequence ---------------------------------------


@pytest.fixture(scope="module", params=["GRU", "LSTM"])
def small_models(request):
    config = ModelConfig(vecsize=30, units=8, rnn=request.param,
                         attention=request.param == "GRU", dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(0), jax_cfg)
    port = DeepGRPModel.from_params(config, params_from_jax(params),
                                    device="cpu")
    return port, jax_model.DeepGRPModel(jax_cfg), params


def port_routes(model, codes, options, dtype):
    """Every route's classes: the single engine's auto / on / off and the
    3-shard engine's auto, as int64."""
    args = dict(batch_size=7, step_size=10, compute_dtype=dtype)
    single = PredictionEngine(model, **args)
    sharded = ShardedPredictionEngine(model, ["cpu"] * 3, **args)
    runs = {route: postprocess.predict_sequence(single, codes, options,
                                                device_mss=route)
            for route in ("auto", "on", "off")}
    runs["sharded auto"] = postprocess.predict_sequence(sharded, codes,
                                                        options)
    return {k: np.asarray(v, np.int64) for k, v in runs.items()}


@pytest.mark.parametrize("max_runs", [0, 10 ** 6])
@pytest.mark.parametrize("seq_len", [900, 233])
def test_routes_agree_with_jax(small_models, monkeypatch, max_runs,
                               seq_len):
    """With the sharded engine's threshold at 0 (the host MSS) and at 10^6
    (the device route), every route equals the JAX package's host and
    device routes."""
    port, jax_mdl, params = small_models
    monkeypatch.setattr(postprocess, "DEVICE_MSS_AUTO_MAX_RUNS", max_runs)
    codes = np.random.default_rng(seq_len).integers(0, 5, seq_len).astype(
        np.int8)
    options = Options(vecsize=30, batch_size=7, min_mss_len=5, xdrop_len=3)
    jax_options = JaxOptions(vecsize=30, batch_size=7, min_mss_len=5,
                             xdrop_len=3)
    want = np.asarray(jax_post.predict_sequence(
        jax_mdl, params, codes, jax_options, 10, True, device_mss=False),
        np.int64)
    jax_dev = np.asarray(jax_post.predict_sequence(
        jax_mdl, params, codes, jax_options, 10, True, device_mss=True),
        np.int64)
    np.testing.assert_array_equal(jax_dev, want)
    for route, got in port_routes(port, codes, options,
                                  torch.float32).items():
        np.testing.assert_array_equal(got, want, err_msg=route)


@pytest.mark.parametrize("max_runs", [0, 10 ** 6])
def test_routes_agree_in_bf16(small_models, monkeypatch, max_runs):
    port, _, _ = small_models
    monkeypatch.setattr(postprocess, "DEVICE_MSS_AUTO_MAX_RUNS", max_runs)
    codes = np.random.default_rng(4).integers(0, 5, 1100).astype(np.int8)
    options = Options(vecsize=30, batch_size=7, min_mss_len=5, xdrop_len=3)
    runs = port_routes(port, codes, options, torch.bfloat16)
    for route, got in runs.items():
        np.testing.assert_array_equal(got, runs["off"], err_msg=route)


def test_sharded_auto_takes_device_route_on_sparse_track(monkeypatch):
    """The trained ``gru_att`` fixture's first record over 3 CPU shards:
    a sparse track, so ``auto`` takes the MSS on the track's device, sized
    from the counted runs, whose stack scan goes through the counted
    wrapper (its plain version on the CPU); its classes equal the single
    engine's host route."""
    config, params = load_model(os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    model = DeepGRPModel.from_params(config, params, "cpu")
    with open(os.path.join(FIXDIR, "gru_att.fa")) as fh:
        _, seq = next(read_multi_fasta(fh))
    _, codes = encode_codes_trimmed(seq)
    options = Options(vecsize=config.vecsize, batch_size=64, min_mss_len=50,
                      xdrop_len=50)
    sharded = ShardedPredictionEngine(model, ["cpu"] * 3, batch_size=64,
                                      step_size=50)
    assert sharded.routes_by_sparsity()
    runs = sharded.scored_tracks(codes).count_runs()
    assert 0 < runs <= postprocess.DEVICE_MSS_AUTO_MAX_RUNS
    taken = []
    real = postprocess.apply_mss_on_device

    def spy(*args, **kwargs):
        taken.append(kwargs.get("runs"))
        return real(*args, **kwargs)

    monkeypatch.setattr(postprocess, "apply_mss_on_device", spy)
    mss_device.LAUNCHES.reset()
    got = postprocess.predict_sequence(sharded, codes, options, threads=1)
    assert taken == [runs]
    assert mss_device.LAUNCHES.snapshot() == {"mss_stack_plain": 1}
    single = PredictionEngine(model, batch_size=64, step_size=50)
    assert not single.routes_by_sparsity()
    want = postprocess.predict_sequence(single, codes, options,
                                        device_mss="off")
    np.testing.assert_array_equal(np.asarray(got, np.int64),
                                  np.asarray(want, np.int64))


def test_sharded_scored_track_on_first_shard_device(small_models):
    """The sharded track is assembled on the first shard's device, equals
    the single engine's, and allows the device routes in one process."""
    port, _, _ = small_models
    codes = np.random.default_rng(9).integers(0, 5, 700).astype(np.int8)
    sharded = ShardedPredictionEngine(port, ["cpu"] * 3, batch_size=7,
                                      step_size=10)
    assert sharded.device_route_ok()
    classes, maxp, rows = sharded.predict_scored_device(codes)
    want_c, want_p, want_rows = PredictionEngine(
        port, batch_size=7, step_size=10).predict_scored_device(codes)
    assert rows == want_rows == 700
    np.testing.assert_array_equal(classes[:rows].numpy(),
                                  want_c[:rows].numpy())
    np.testing.assert_array_equal(maxp[:rows].numpy(), want_p[:rows].numpy())
    assert sharded.predict_scored_device(codes[:20]) == (None, None, 0)


def test_apply_mss_scored_matches_jax():
    """``apply_mss_scored`` (the host MSS from the scored track) gives the
    JAX package's one-hot labels, and :func:`apply_mss`'s on the full
    probabilities whose row maxima and argmax the track holds."""
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.full(5, 0.3), size=3000).astype(np.float32)
    classes = probs.argmax(axis=1).astype(np.int8)
    maxp = probs.max(axis=1)
    options = Options(min_mss_len=5, xdrop_len=3)
    got = postprocess.apply_mss_scored(classes, maxp, options, 5)
    np.testing.assert_array_equal(got, jax_post.apply_mss_scored(
        classes, maxp, JaxOptions(min_mss_len=5, xdrop_len=3), 5))
    np.testing.assert_array_equal(got, postprocess.apply_mss(probs, options))
