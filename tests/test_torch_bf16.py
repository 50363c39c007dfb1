"""The port's bfloat16 fast mode against the JAX package, on the CPU.

The bf16 plain versions of the fused kernels (``gru_avg_plain`` /
``lstm_avg_plain`` with ``out_dtype=bfloat16``) and of the GRU sequence
kernel (``gru_apply`` on bf16 input) against the JAX package's bf16 kernels
in interpret mode; the bf16 quality contract of ``predict`` on the
reference fixtures (tests/test_reference_parity.py:110-180); and the
port's copy of ``predict/metrics.py``.

Tolerance of the kernel comparisons: atol 2e-2 at T <= 32 (u up to 520,
where the kernels run their cluster tiles).  The port
rounds the operands of the recurrent dot to bfloat16 (``h`` and ``U``), as
the TPU's DEFAULT precision does; the JAX package's kernels in interpret
mode on the CPU sum that dot in float32 without rounding.  Both store
bfloat16 outputs (a step of 2^-8 near 1).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.models import keras_io as jax_keras_io  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.models import pallas_rnn  # noqa: E402
from deepgrp_tpu.predict import engine as jax_engine  # noqa: E402
from deepgrp_tpu.predict import metrics as jax_metrics  # noqa: E402
from deepgrp_tpu.predict import postprocess as jax_post  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.data.fasta import read_multi_fasta  # noqa: E402
from deepgrp_tpu_torch.models import cuda_rnn, rnn  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402
from deepgrp_tpu_torch.models.keras_io import load_model  # noqa: E402
from deepgrp_tpu_torch.models.model import DeepGRPModel  # noqa: E402
from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed  # noqa: E402
from deepgrp_tpu_torch.predict import metrics  # noqa: E402
from deepgrp_tpu_torch.predict.engine import PredictionEngine  # noqa: E402
from deepgrp_tpu_torch.predict.postprocess import \
    predict_sequence  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "fixtures", "reference")
TORCH_FIXDIR = os.path.join(HERE, "fixtures", "torch")
ATOL = 2e-2
BF16 = torch.bfloat16


def random_cell(seed, cell, units, channels=5):
    rng = np.random.default_rng(seed)
    gates = 4 if cell == "lstm" else 3
    width = gates * units
    params = {
        "kernel": rng.normal(0.0, 0.5, (channels, width)),
        "recurrent": rng.normal(0.0, units ** -0.5, (units, width)),
        "bias": rng.normal(0.0, 0.3, (2, width) if gates == 3
                           else (width,)),
    }
    return {k: v.astype(np.float32) for k, v in params.items()}, rng


def port_rnn(params):
    flat = params_from_jax({"rnn": params})
    return {key.split(".")[1]: value for key, value in flat.items()}


def as_f32(array):
    return np.asarray(jnp.asarray(array, jnp.float32))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("batch,steps,units", [
    (4, 17, 6), (11, 32, 12), (3, 9, 5),
    # Past u=128, where the kernels run the cluster tile (past u=256 on 4
    # to 16 CTAs, at u=1024 with U through L1/L2, at u=2048 with one
    # m-tile and only the CTA's rows of h).
    (3, 6, 136), (2, 5, 200), (2, 5, 300), (2, 4, 520), (1, 3, 1024),
    (1, 2, 2048)])
def test_avg_plain_bf16_matches_pallas(cell, batch, steps, units):
    params, rng = random_cell(batch * steps + units, cell, units)
    codes = rng.integers(0, 6, size=(batch, steps)).astype(np.int8)
    codes[0, :3] = 4
    fn = pallas_rnn.pallas_lstm_avg if cell == "lstm" \
        else pallas_rnn.pallas_gru_avg
    want_avg, want_hidden = fn({k: jnp.asarray(v) for k, v in
                                params.items()},
                               jnp.asarray(codes.astype(np.int32)),
                               block_b=8, time_block=8,
                               out_dtype=jnp.bfloat16, interpret=True)
    wrapper = cuda_rnn.lstm_avg if cell == "lstm" else cuda_rnn.gru_avg
    calls = rnn.PLAIN_CALLS.get(f"{cell}_avg_bf16")
    avg, hidden = wrapper(port_rnn(params), torch.from_numpy(codes), BF16)
    assert rnn.PLAIN_CALLS.get(f"{cell}_avg_bf16") == calls + 1
    assert avg.dtype == hidden.dtype == BF16
    assert avg.shape == (batch, steps, units)
    np.testing.assert_allclose(avg.float().numpy(), as_f32(want_avg),
                               atol=ATOL)
    np.testing.assert_allclose(hidden.float().numpy(), as_f32(want_hidden),
                               atol=ATOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_avg_plain_f32_unchanged_by_out_dtype(cell):
    """The float32 call is the float32 plain version; the bf16 call differs
    from it by bf16 rounding only."""
    params, rng = random_cell(3, cell, 7)
    codes = torch.from_numpy(rng.integers(0, 6, (5, 30)).astype(np.int8))
    plain = rnn.lstm_avg_plain if cell == "lstm" else rnn.gru_avg_plain
    f32 = plain(port_rnn(params), codes)
    again = plain(port_rnn(params), codes, torch.float32)
    low = plain(port_rnn(params), codes, BF16)
    for a, b, c in zip(f32, again, low):
        assert torch.equal(a, b)
        torch.testing.assert_close(c.float(), a, atol=ATOL, rtol=0)


def test_avg_plain_rejects_other_dtypes():
    params, _ = random_cell(0, "gru", 4)
    with pytest.raises(ValueError, match="bfloat16"):
        rnn.gru_avg_plain(port_rnn(params),
                          torch.zeros(1, 3, dtype=torch.int8), torch.float16)


@pytest.mark.parametrize("batch,steps,units", [
    (7, 23, 60), (8, 16, 12), (3, 5, 8),
    # Past u=128, where the kernel runs its cluster tile (u=520: 16 CTAs
    # of 33 units, the last with 25).
    (3, 6, 136), (2, 5, 200), (2, 4, 520)])
def test_gru_apply_bf16_matches_pallas(batch, steps, units):
    params, rng = random_cell(batch + units, "gru", units)
    x = rng.random((batch, steps, 5)).astype(np.float32)
    want_seq, want_last = pallas_rnn.pallas_gru_apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x, jnp.bfloat16), interpret=True, block_b=8)
    assert want_seq.dtype == jnp.bfloat16
    seq, last = cuda_rnn.gru_apply(port_rnn(params),
                                   torch.from_numpy(x).to(BF16))
    assert seq.dtype == last.dtype == BF16
    np.testing.assert_allclose(seq.float().numpy(), as_f32(want_seq),
                               atol=ATOL)
    np.testing.assert_allclose(last.float().numpy(), as_f32(want_last),
                               atol=ATOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_apply_bf16_rounds_only_the_dot_operands(cell):
    """bf16 ``x`` with float32 ``h`` and gates: the bf16 result is the
    float32 result on bf16-rounded weights to within output rounding."""
    params, rng = random_cell(9, cell, 10)
    x = torch.from_numpy(rng.random((4, 20, 5)).astype(np.float32)).to(BF16)
    apply = rnn.lstm_apply if cell == "lstm" else rnn.gru_apply
    rounded = {k: v.to(BF16).float() if k != "bias" else v
               for k, v in port_rnn(params).items()}
    seq, last = apply(port_rnn(params), x)
    ref_seq, ref_last = apply(rounded, x.float())
    assert seq.dtype == BF16
    torch.testing.assert_close(seq.float(), ref_seq, atol=ATOL, rtol=0)
    torch.testing.assert_close(last.float(), ref_last, atol=ATOL, rtol=0)


def manifest():
    with open(os.path.join(FIXDIR, "manifest.json")) as fh:
        return json.load(fh)


def fixture_codes(name):
    with open(os.path.join(FIXDIR, f"{name}.fa")) as fh:
        _, seq = next(read_multi_fasta(fh))
    return encode_codes_trimmed(seq)[1]


def mcc(truth, pred):
    return metrics.calculate_multiclass_matthews_cc(
        metrics.confusion_matrix(truth, pred))


@pytest.fixture(scope="module", params=["gru_att", "gru"])
def f32_run(request):
    """A fixture model and its float32 run: raw and post-MSS classes."""
    name = request.param
    man = manifest()
    config, params = load_model(os.path.join(TORCH_FIXDIR, f"{name}.npz"))
    model = DeepGRPModel.from_params(config, params, "cpu")
    options = Options(vecsize=config.vecsize,
                      min_mss_len=man["min_mss_len"],
                      xdrop_len=man["xdrop_len"])
    codes = fixture_codes(name)
    engine = PredictionEngine(model, batch_size=man["batch_size"],
                              step_size=man["step_size"])
    raw, maxp = engine.predict_scored(codes)
    post = predict_sequence(engine, codes, options)
    return name, model, options, codes, raw, maxp, post


@pytest.mark.parametrize("route", ["fused", "scan"])
def test_bf16_quality_contract(f32_run, route):
    """bf16 against float32 on reference-trained weights: raw per-position
    class agreement >= 0.95, post-MSS agreement >= 0.98, R_K MCC >= 0.95
    (the JAX package's contract, tests/test_reference_parity.py:110-180).
    The bf16 max-probability track is bf16-valued."""
    name, model, options, codes, raw32, maxp32, post32 = f32_run
    man = manifest()
    engine = PredictionEngine(model, batch_size=man["batch_size"],
                              step_size=man["step_size"],
                              compute_dtype=BF16, rnn_kernel=route)
    raw16, maxp16 = engine.predict_scored(codes)
    assert maxp16.dtype == np.float32
    assert not (maxp16.view(np.uint32) & 0xFFFF).any()
    np.testing.assert_allclose(maxp16, maxp32, atol=0.1)
    raw_agree = float((raw16 == raw32).mean())
    post16 = predict_sequence(engine, codes, options)
    post_agree = float((post16 == post32).mean())
    score = mcc(post32.astype(np.int64), post16.astype(np.int64))
    print(f"{name} {route}: raw agreement {raw_agree:.4f}, post-MSS "
          f"{post_agree:.4f}, R_K MCC {score:.4f}")
    assert raw_agree >= 0.95
    assert post_agree >= 0.98
    assert score >= 0.95


@pytest.mark.parametrize("route", ["fused", "scan"])
def test_bf16_classes_match_jax_bf16(f32_run, route):
    """The port's bf16 post-MSS classes against the JAX engine's bf16
    classes (its scan route on the CPU): agreement >= 0.98.  Prints both
    modes' MCC against their own float32 run."""
    name, model, options, codes, _, _, post32 = f32_run
    man = manifest()
    jax_cfg, jax_params = jax_keras_io.load_keras_h5(
        os.path.join(FIXDIR, f"{name}.h5"))
    jax_mdl = jax_model.DeepGRPModel(jax_cfg)
    jax_options = JaxOptions(vecsize=jax_cfg.vecsize,
                             min_mss_len=man["min_mss_len"],
                             xdrop_len=man["xdrop_len"])
    jax_runs = {}
    for label, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        engine = jax_engine.PredictionEngine(
            jax_mdl, batch_size=man["batch_size"],
            step_size=man["step_size"], compute_dtype=dtype)
        jax_runs[label] = np.asarray(jax_post.predict_sequence(
            jax_mdl, jax_params, codes, jax_options, man["step_size"], True,
            engine=engine, device_mss="off"), np.int64)
    engine = PredictionEngine(model, batch_size=man["batch_size"],
                              step_size=man["step_size"],
                              compute_dtype=BF16, rnn_kernel=route)
    port16 = predict_sequence(engine, codes, options).astype(np.int64)
    agree = float((port16 == jax_runs["bf16"]).mean())
    port_mcc = mcc(post32.astype(np.int64), port16)
    jax_mcc = mcc(jax_runs["f32"], jax_runs["bf16"])
    print(f"{name} {route}: port bf16 vs JAX bf16 agreement {agree:.4f}; "
          f"R_K MCC vs float32: port {port_mcc:.4f}, JAX {jax_mcc:.4f}")
    assert agree >= 0.98


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    truth = rng.integers(seed, 5, 400)
    pred = np.where(rng.random(400) < 0.7, truth, rng.integers(0, 5, 400))
    np.testing.assert_array_equal(metrics.confusion_matrix(truth, pred),
                                  jax_metrics.confusion_matrix(truth, pred))
    # A class absent from both arrays gives 0/0 rates (NaN) in both.
    with np.errstate(invalid="ignore", divide="ignore"):
        cnf, got = metrics.calculate_metrics(pred, truth)
        jax_cnf, want = jax_metrics.calculate_metrics(pred, truth)
    np.testing.assert_array_equal(cnf, jax_cnf)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert metrics.calculate_multiclass_matthews_cc(cnf) == \
        jax_metrics.calculate_multiclass_matthews_cc(jax_cnf)
