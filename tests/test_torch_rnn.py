"""The port's fused recurrence (plain versions and CPU path of the kernel
wrappers) against the JAX package's Pallas kernels.

Inputs come from a numpy seed and go to both sides.  The JAX kernels run in
interpret mode, as the JAX package's own tests run them on the CPU.
Tolerance: atol 1e-5 on both outputs, the JAX package's kernel tolerance
(tests/test_pallas_rnn.py); the two sides sum the recurrent dot in
different orders, so they agree to float32 rounding, not bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.models import pallas_rnn  # noqa: E402
from deepgrp_tpu_torch.models import cuda_rnn, rnn  # noqa: E402

ATOL = 1e-5


def random_case(seed, cell, batch, steps, units):
    rng = np.random.default_rng(seed)
    gates = 4 if cell == "lstm" else 3
    width = gates * units
    params = {
        "kernel": rng.normal(0.0, 0.5, (5, width)).astype(np.float32),
        "recurrent": rng.normal(0.0, units ** -0.5,
                                (units, width)).astype(np.float32),
        "bias": rng.normal(0.0, 0.3, (2, width) if gates == 3
                           else (width,)).astype(np.float32),
    }
    codes = rng.integers(0, 6, size=(batch, steps)).astype(np.int8)
    codes[0, :3] = 4  # N
    codes[-1, -4:] = 5  # pad
    return params, codes


def torch_params(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def jax_avg(cell, params, codes, out_dtype=jnp.float32):
    fn = pallas_rnn.pallas_lstm_avg if cell == "lstm" \
        else pallas_rnn.pallas_gru_avg
    avg, hidden = fn({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(codes.astype(np.int32)), block_b=8,
                     time_block=8, out_dtype=out_dtype, interpret=True)
    return (np.asarray(jnp.asarray(avg, jnp.float32)),
            np.asarray(jnp.asarray(hidden, jnp.float32)))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("batch,steps,units", [(4, 17, 6), (16, 40, 16),
                                               (3, 9, 5), (11, 33, 12)])
def test_plain_matches_pallas(cell, batch, steps, units):
    params, codes = random_case(batch * steps + units, cell, batch, steps,
                                units)
    want_avg, want_hidden = jax_avg(cell, params, codes)
    plain = rnn.lstm_avg_plain if cell == "lstm" else rnn.gru_avg_plain
    avg, hidden = plain(torch_params(params), torch.from_numpy(codes))
    assert avg.shape == (batch, steps, units)
    assert hidden.shape == (batch, units)
    np.testing.assert_allclose(avg.numpy(), want_avg, atol=ATOL)
    np.testing.assert_allclose(hidden.numpy(), want_hidden, atol=ATOL)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL),
                                        ("bfloat16", 2e-2)])
def test_lstm_plain_matches_pallas_u128(dtype, atol):
    """The LSTM at u=128, the training ceiling (the first CUDA kernel
    stopped at u=113): the plain version against the JAX kernel in float32
    and in the bf16 fast mode (atol 2e-2, as tests/test_torch_bf16.py: the
    port rounds the dot's operands to bfloat16, the JAX kernel in interpret
    mode does not)."""
    params, codes = random_case(128, "lstm", 2, 20, 128)
    want_avg, want_hidden = jax_avg("lstm", params, codes,
                                    getattr(jnp, dtype))
    avg, hidden = rnn.lstm_avg_plain(torch_params(params),
                                     torch.from_numpy(codes),
                                     getattr(torch, dtype))
    assert avg.dtype == hidden.dtype == getattr(torch, dtype)
    assert avg.shape == (2, 20, 128)
    np.testing.assert_allclose(avg.float().numpy(), want_avg, atol=atol)
    np.testing.assert_allclose(hidden.float().numpy(), want_hidden,
                               atol=atol)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cpu_wrapper_is_plain_version(cell):
    params, codes = random_case(5, cell, 6, 20, 8)
    params, codes = torch_params(params), torch.from_numpy(codes)
    wrapper = cuda_rnn.lstm_avg if cell == "lstm" else cuda_rnn.gru_avg
    plain = rnn.lstm_avg_plain if cell == "lstm" else rnn.gru_avg_plain
    launches = cuda_rnn.LAUNCHES.get(f"{cell}_avg")
    calls = rnn.PLAIN_CALLS.get(f"{cell}_avg")
    got = wrapper(params, codes)
    want = plain(params, codes)
    assert cuda_rnn.LAUNCHES.get(f"{cell}_avg") == launches
    assert rnn.PLAIN_CALLS.get(f"{cell}_avg") == calls + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_launcher_refuses_cpu_tensors():
    params, codes = random_case(1, "gru", 2, 5, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rnn._launch("gru_avg", 3, torch_params(params),
                         torch.from_numpy(codes))


def test_reverse_complement_table_matches_jax():
    assert rnn.COMPLEMENT_CODES == pallas_rnn._COMPLEMENT_CODES


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch", [1024, 64, 1000, 1])
def test_gru_avg_block_windows(batch, sms):
    """The GRU inference tile: the fewest windows a CTA that keep the grid
    within one wave, up to the kernel's cap of 8 (then the fewest waves:
    1024 windows need 9 a CTA on 114 SMs, so 8 and two waves)."""
    windows = cuda_rnn.block_windows(batch, sms, 8)
    n_cta = -(-batch // windows)
    assert 1 <= windows <= 8
    assert n_cta <= sms or windows == 8
    assert windows == 1 or -(-batch // (windows - 1)) > sms
    if sms == 132:
        assert windows == {1024: 8, 64: 1, 1000: 8, 1: 1}[batch]
    assert cuda_rnn.block_windows(batch, sms, 2) == min(windows, 2)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [2048, 256, 7, 1])
def test_gru_seq_tile(rows, sms):
    """The GRU sequence kernel's tile: the fewest rows a CTA that keep the
    grid within one wave, up to the kernel's cap (16 rows up to u=128, 4
    beyond; then the fewest waves: 2048 rows need 18 a CTA on 114 SMs, so
    16 and two waves).  The scan route's 2048 rows take 128 CTAs of 16 on
    a 132-SM card, the shape of the fused kernel's tile at 8 windows."""
    for units, most in ((60, 16), (128, 16), (129, 4), (1024, 4)):
        rows_a_cta, n_cta = cuda_rnn.seq_tile(rows, units, sms)
        assert 1 <= rows_a_cta <= most
        assert n_cta == -(-rows // rows_a_cta)
        assert n_cta <= sms or rows_a_cta == most
        assert rows_a_cta == 1 or -(-rows // (rows_a_cta - 1)) > sms
    if sms == 132:
        assert cuda_rnn.seq_tile(rows, 60, sms) == {
            2048: (16, 128), 256: (2, 128), 7: (1, 7), 1: (1, 1)}[rows]
