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
@pytest.mark.parametrize("batch,steps,units", [
    (4, 17, 6), (16, 40, 16), (3, 9, 5), (11, 33, 12),
    # Widths the kernels serve on a cluster of CTAs: ragged over 16 CTAs
    # (u=300, 520), the widest at one unit a lane, and past it with two
    # units a lane (u=1537: ragged, 97 units a CTA of 16; u=2048); past
    # the cluster tiles, on the grid tile (ragged: 4 and 8 units past a
    # whole block of 32).
    (2, 5, 300), (2, 4, 520), (1, 3, 1024), (1, 3, 1537), (1, 2, 2048),
    (1, 2, 4100), (1, 2, 5000)])
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
    """The LSTM at u=128, the widest layer of the training kernels' L1/L2
    layout (the first CUDA kernel stopped at u=113): the plain version against the JAX kernel in float32
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


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", [4100, 5000])
def test_cpu_wrapper_past_cluster_ceiling(cell, units):
    """Past the cluster tiles' ceiling (u=4096), where a CUDA tensor runs
    the grid tile, a CPU tensor still runs the plain version, in both
    dtypes: bit for bit its outputs, one plain call each, no launch."""
    params, codes = random_case(units, cell, 2, 3, units)
    params, codes = torch_params(params), torch.from_numpy(codes)
    wrapper = cuda_rnn.lstm_avg if cell == "lstm" else cuda_rnn.gru_avg
    plain = rnn.lstm_avg_plain if cell == "lstm" else rnn.gru_avg_plain
    for dtype in (torch.float32, torch.bfloat16):
        name = f"{cell}_avg{rnn.dtype_suffix(dtype)}"
        launches = cuda_rnn.LAUNCHES.snapshot()
        calls = rnn.PLAIN_CALLS.get(name)
        got = wrapper(params, codes, dtype)
        assert rnn.PLAIN_CALLS.get(name) == calls + 1
        assert cuda_rnn.LAUNCHES.snapshot() == launches
        for g, w in zip(got, plain(params, codes, dtype)):
            assert g.dtype == dtype and g.shape[-1] == units
            assert torch.equal(g, w)


@pytest.mark.parametrize("units", [4100, 5000])
def test_cpu_gru_apply_past_cluster_ceiling(units):
    """``cuda_rnn.gru_apply`` on a CPU tensor past u=4096 against the JAX
    package's ``pallas_gru_apply`` in interpret mode (atol 1e-5)."""
    rng = np.random.default_rng(units)
    params = {
        "kernel": rng.normal(0.0, 0.5, (5, 3 * units)).astype(np.float32),
        "recurrent": rng.normal(0.0, units ** -0.5,
                                (units, 3 * units)).astype(np.float32),
        "bias": rng.normal(0.0, 0.3, (2, 3 * units)).astype(np.float32),
    }
    x = rng.random((2, 3, 5)).astype(np.float32)
    want_seq, want_last = pallas_rnn.pallas_gru_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        interpret=True, block_b=8)
    launches = cuda_rnn.LAUNCHES.snapshot()
    seq, last = cuda_rnn.gru_apply(torch_params(params), torch.from_numpy(x))
    assert cuda_rnn.LAUNCHES.snapshot() == launches
    assert seq.shape == (2, 3, units) and last.shape == (2, units)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               atol=ATOL)


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
    grid within one wave, up to the kernel's cap (then the fewest waves:
    2048 rows need 18 a CTA on 114 SMs, so 16 and two waves).  Up to
    u=128 one CTA owns its rows' units, at most 16 rows; past it a
    cluster of CTAs splits them (8 up to u=256, 16 beyond), each CTA of a
    cluster holds the cluster's rows, and the wave counts clusters (16
    rows, but 4 from u=257 to 512, where U's slice fills the shared
    memory) up to the cluster tile's ceiling u=1024.  Past it the grid
    tile: 32 rows and 32 units a CTA, no cluster.  The scan route's
    2048 rows take 128 CTAs of 16 on a 132-SM card, the shape of the
    fused kernel's tile at 8 windows."""
    for units, most, cluster in ((60, 16, 1), (128, 16, 1), (129, 16, 8),
                                 (256, 16, 8), (257, 4, 16), (512, 4, 16),
                                 (513, 16, 16), (1023, 16, 16),
                                 (1024, 16, 16)):
        assert cuda_rnn.seq_cluster(units) == cluster
        rows_a_cta, n_cta = cuda_rnn.seq_tile(rows, units, sms)
        clusters = sms // cluster
        assert 1 <= rows_a_cta <= most
        assert n_cta == -(-rows // rows_a_cta) * cluster
        assert n_cta <= clusters * cluster or rows_a_cta == most
        assert rows_a_cta == 1 or -(-rows // (rows_a_cta - 1)) > clusters
    if sms == 132:
        assert cuda_rnn.seq_tile(rows, 60, sms) == {
            2048: (16, 128), 256: (2, 128), 7: (1, 7), 1: (1, 1)}[rows]
        # u=512 at 16 rows: 8 clusters of 16 CTAs, 2 rows each.
        assert cuda_rnn.seq_tile(16, 512, sms) == (2, 128)
    # Past the cluster tile's ceiling (u=1024) the grid tile, whatever the
    # SMs: every row and unit covered; only u <= 0 is refused.
    for units in (1025, 2048, 2049, 4096, 4097, 8192):
        assert cuda_rnn.seq_cluster(units) == 1
        assert cuda_rnn.seq_max_rows(units) == 32
        assert cuda_rnn.seq_tile(rows, units, sms) == (
            min(rows, 32), -(-rows // 32) * -(-units // 32))
    with pytest.raises(ValueError, match="u >= 1, not u=0"):
        cuda_rnn.seq_tile(rows, 0, sms)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,units", [
    (10, 2049), (128, 2049), (128, 4096), (128, 4608), (512, 4608),
    (32, 8192), (2048, 1025), (74, 3000), (1, 4097)])
def test_grid_tile_by_dtype(rows, units, sms):
    """The grid tile's CTAs a step (pure Python): in float32 32 rows and
    32 units a CTA; in bfloat16 (the tensor-core step) 128 rows a CTA and
    32 units, or 16 where the grid of 32 would have fewer CTAs than the
    card has SMs (B=64 at u=4608: 144 CTAs of 32 units; at u=2049: 130
    of 16)."""
    row_blocks, unit_blocks = -(-rows // 128), -(-units // 32)
    assert cuda_rnn.grid_tile(rows, units, sms=sms) == (
        min(32, rows), -(-rows // 32) * unit_blocks)
    unit_block = 32 if row_blocks * unit_blocks >= sms else 16
    assert cuda_rnn.grid_mma_units(rows, units, sms) == unit_block
    assert cuda_rnn.grid_tile(rows, units, torch.bfloat16, sms) == (
        min(128, rows), row_blocks * unit_blocks * 32 // unit_block)
    if sms == 132:
        assert cuda_rnn.grid_tile(128, 4608, torch.bfloat16, sms) == (128,
                                                                      144)
        assert cuda_rnn.grid_tile(128, 2049, torch.bfloat16, sms) == (128,
                                                                      130)


# (units, tile) at each width where the inference kernels' tile changes,
# the cluster and stationary tiles' ceilings (u=1024 in float32, 1279 in
# bfloat16), one past each and beyond.
AVG_TILES = {
    "float32": [(1, "registers"), (64, "registers"), (65, "l2"),
                (128, "l2"), (129, "cluster"), (300, "cluster"),
                (383, "cluster"), (384, "stationary"),
                (1023, "stationary"), (1024, "stationary"), (1025, "grid"),
                (2048, "grid"), (4096, "grid"), (4097, "grid"),
                (8192, "grid"), (26800, "grid")],
    "bfloat16": [(1, "mma"), (128, "mma"), (129, "cluster"),
                 (520, "cluster"), (1024, "cluster"), (1025, "cluster"),
                 (1279, "cluster"), (1280, "grid"), (2048, "grid"),
                 (2049, "grid"), (3000, "grid"), (4096, "grid"),
                 (4097, "grid"), (8192, "grid")],
}


@pytest.mark.parametrize("cell,dtype", [(cell, dtype) for cell in (
    "gru", "lstm") for dtype in sorted(AVG_TILES)])
def test_avg_layout_by_width(cell, dtype):
    """The inference kernels' tile by width (pure Python): one CTA a window
    up to u=128 (the register tile in float32, the tensor-core tile in
    bf16), past it a window's units over a cluster of CTAs (in float32 up
    to u=383, then the stationary tile: every CTA of one resident grid
    owns some units for every window) up to the ceiling (u=1024 in
    float32, 1279 in bf16), and past it the grid tile at every width;
    only u <= 0 is refused:
    ``avg_tile_name`` and ``avg_layout`` raise ``ValueError`` naming the
    width, before they ask the library."""
    for units, tile in AVG_TILES[dtype]:
        assert cuda_rnn.avg_tile_name(cell, units,
                                      getattr(torch, dtype)) == tile, units
    for units in (0, -1):
        for fn in (cuda_rnn.avg_tile_name, cuda_rnn.avg_layout):
            with pytest.raises(ValueError, match=f"u >= 1, not u={units}"):
                fn(cell, units, getattr(torch, dtype))


def test_route_widths_by_row():
    """Each row's cluster tile up to its route width, the grid tile past
    it (pure Python): the training kernels up to
    ``TRAIN_CLUSTER_MAX_UNITS`` (u=511), the float32 inference rows up to
    ``CLUSTER_MAX_UNITS`` (u=1024; the cluster tile below
    ``STATIONARY_MIN_UNITS``, u=384, the stationary tile from it) and row
    7 with float32 IO up to ``CLUSTER_MAX_UNITS``, the bf16 rows up to
    ``BF16_CLUSTER_MAX_UNITS`` (u=1279), row 7 with bf16 IO up to
    ``SEQ_BF16_CLUSTER_MAX_UNITS`` (u=767); every width runs, only
    u <= 0 is refused."""
    assert (cuda_rnn.TRAIN_CLUSTER_MAX_UNITS, cuda_rnn.CLUSTER_MAX_UNITS,
            cuda_rnn.BF16_CLUSTER_MAX_UNITS,
            cuda_rnn.SEQ_BF16_CLUSTER_MAX_UNITS,
            cuda_rnn.STATIONARY_MIN_UNITS) == (511, 1024, 1279, 767, 384)
    assert cuda_rnn.avg_tile_name("gru", 383) == "cluster"
    for units in (384, 1023, 1024):
        assert cuda_rnn.avg_tile_name("gru", units) == "stationary"
        assert cuda_rnn.avg_tile_name("gru", units,
                                      torch.bfloat16) == "cluster"
    assert cuda_rnn.train_layout(511) == "cluster"
    for units in (512, 1023, 1024, 1025, 2048, 4096, 4097, 8192):
        assert cuda_rnn.train_layout(units) == "grid"
    for units in (1025, 2048, 4096, 4097, 8192):
        assert cuda_rnn.avg_tile_name("lstm", units) == "grid"
    for units in (0, -4097):
        with pytest.raises(ValueError, match=f"not u={units}"):
            cuda_rnn.train_layout(units)


@pytest.mark.parametrize("dtype,ceiling", [("float32", 1024),
                                           ("bfloat16", 767)])
def test_gru_seq_route_by_io_dtype(dtype, ceiling):
    """Row 7 (the GRU sequence kernel) runs its cluster tile up to its
    route width for the IO type (u=1024 with float32 IO, 767 with
    bfloat16) and the grid tile one past it (pure Python): no cluster,
    the grid tile's rows a CTA (128 for the bf16 step) and CTAs a step."""
    dtype = getattr(torch, dtype)
    assert cuda_rnn._grid_route(ceiling, "seq", dtype) is False
    assert cuda_rnn.seq_cluster(ceiling, dtype) == 16
    assert cuda_rnn.seq_max_rows(ceiling, dtype) == 16
    units = ceiling + 1
    assert cuda_rnn._grid_route(units, "seq", dtype) is True
    assert cuda_rnn.seq_cluster(units, dtype) == 1
    most = 128 if dtype == torch.bfloat16 else 32
    assert cuda_rnn.seq_max_rows(units, dtype) == most
    for rows in (16, 64, 2048):
        assert cuda_rnn.seq_tile(rows, units, 132, dtype=dtype) == (
            cuda_rnn.grid_tile(rows, units, dtype, 132))
        assert cuda_rnn.seq_tile(rows, units, 132, dtype=dtype)[0] == min(
            rows, most)
