"""The port's training recurrence (plain versions and the CPU path of the
autograd Functions) against the JAX package's trainable Pallas kernels.

Inputs and per-gate dropout masks come from a numpy seed and go to both
sides, so the two compute the same function.  The JAX kernels run in
interpret mode with explicit masks, as ``tests/test_pallas_train.py`` runs
them on the CPU.  Tolerances: forwards atol 1e-5 (float32 rounding of the
recurrent dot, summed in other orders); gradients through the custom VJPs
atol 2e-4 and the loss rtol 1e-5 (the JAX package's own tolerances,
``tests/test_pallas_train.py:86-90``); the plain backward against torch
autograd through the plain forward atol 1e-5 (both in float32 on the CPU,
same formulas, other summation orders).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.models import rnn as jax_rnn  # noqa: E402
from deepgrp_tpu.models.pallas_rnn_train import (  # noqa: E402
    pallas_gru_avg_train, pallas_lstm_avg_train)
from deepgrp_tpu_torch.models import cuda_rnn, rnn  # noqa: E402

SHAPES = [(4, 19, 6), (8, 16, 12), (3, 9, 5)]


def gates_of(cell):
    return 4 if cell == "lstm" else 3


def random_case(seed, cell, batch, steps, units, rate):
    """Parameters, codes (with N and pad steps) and masks (None at rate
    0) as numpy arrays."""
    rng = np.random.default_rng(seed)
    gates = gates_of(cell)
    width = gates * units
    params = {
        "kernel": rng.normal(0.0, 0.5, (5, width)).astype(np.float32),
        "recurrent": rng.normal(0.0, units ** -0.5,
                                (units, width)).astype(np.float32),
        "bias": rng.normal(0.0, 0.3, (2, width) if gates == 3
                           else (width,)).astype(np.float32),
    }
    codes = rng.integers(0, 5, size=(batch, steps)).astype(np.int8)
    codes[0, :2] = 4  # N channel
    codes[-1, -2:] = 5  # pad (zero-row) steps inside a window
    masks = None
    if rate > 0:
        keep = 1.0 - rate
        masks = ((rng.random((gates, 2 * batch, 5)) < keep)
                 / keep).astype(np.float32)
    return params, codes, masks


def to_torch(params, codes, masks):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(codes),
            None if masks is None else torch.from_numpy(masks))


def jax_train(cell, params, codes, masks):
    fn = pallas_lstm_avg_train if cell == "lstm" else pallas_gru_avg_train
    has_mask = masks is not None
    if not has_mask:
        masks = np.ones((gates_of(cell), 2 * codes.shape[0], 5), np.float32)
    return fn, {k: jnp.asarray(v) for k, v in params.items()}, \
        jnp.asarray(codes.astype(np.int32)), jnp.asarray(masks), has_mask


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("batch,steps,units", SHAPES)
def test_plain_train_fwd_matches_pallas(cell, rate, batch, steps, units):
    params, codes, masks = random_case(batch + steps, cell, batch, steps,
                                       units, rate)
    fn, j_params, j_codes, j_masks, has_mask = jax_train(cell, params,
                                                         codes, masks)
    want_avg, want_hidden = fn(j_params, j_codes, j_masks, has_mask)
    plain = (rnn.lstm_avg_train_fwd_plain if cell == "lstm"
             else rnn.gru_avg_train_fwd_plain)
    avg, hidden, *seqs = plain(*to_torch(params, codes, masks))
    assert avg.shape == (batch, steps, units)
    assert hidden.shape == (batch, units)
    assert len(seqs) == (2 if cell == "lstm" else 1)
    for seq in seqs:
        assert seq.shape == (2 * batch, steps, units)
    np.testing.assert_allclose(avg.numpy(), np.asarray(want_avg), atol=1e-5)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               atol=1e-5)
    # hseq holds both branches: its branch average is avg.
    torch.testing.assert_close((seqs[0][:batch] + seqs[0][batch:]) * 0.5,
                               avg, atol=0, rtol=0)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("batch,steps,units,rate", [
    (4, 19, 6, 0.0),
    (4, 19, 6, 0.3),
    (8, 16, 12, 0.0928),
])
def test_autograd_function_matches_jax_vjp(cell, batch, steps, units,
                                           rate):
    """``value_and_grad`` of a weighted sum of both outputs through the
    port's autograd Function (CPU: plain versions) against the same
    through the JAX custom VJP, with the same masks."""
    params, codes, masks = random_case(7 * batch + units, cell, batch,
                                       steps, units, rate)
    rng = np.random.default_rng(11)
    w_avg = rng.normal(size=(batch, steps, units)).astype(np.float32)
    w_hid = rng.normal(size=(batch, units)).astype(np.float32)
    fn, j_params, j_codes, j_masks, has_mask = jax_train(cell, params,
                                                         codes, masks)

    def loss_jax(p):
        avg, hid = fn(p, j_codes, j_masks, has_mask)
        return jnp.sum(avg * w_avg) + jnp.sum(hid * w_hid)

    want_v, want_g = jax.value_and_grad(loss_jax)(j_params)
    t_params, t_codes, t_masks = to_torch(params, codes, masks)
    for value in t_params.values():
        value.requires_grad_(True)
    avg, hid = cuda_rnn.avg_train(cell, t_params, t_codes, t_masks)
    loss = (avg * torch.from_numpy(w_avg)).sum() + (
        hid * torch.from_numpy(w_hid)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for name in ("kernel", "recurrent", "bias"):
        np.testing.assert_allclose(t_params[name].grad.numpy(),
                                   np.asarray(want_g[name]), atol=2e-4,
                                   err_msg=name)


# The widths either side of the window tile's ceiling (u=128 | 129), up to
# u=256, u=257, u=520 (ragged over 16 CTAs: 33 units a CTA), u=1024 and
# past it u=1025 (ragged) and u=2048, and u=4100 (ragged against the grid
# tile's 32-unit blocks); the LSTM's u=128 cases keep the ids they had
# when u=128 was the ceiling.  On the CPU every case runs the plain
# versions; the tiles are the card tests'.
WIDE_CASES = [
    pytest.param(cell, units, rate,
                 id=(str(rate) if (cell, units) == ("lstm", 128)
                     else f"{cell}-u{units}-{rate}"))
    for cell in ("gru", "lstm") for units in (128, 129, 200, 256, 257, 520,
                                              1024, 1025, 2048, 4100)
    for rate in (0.0, 0.0928)]
# Steps of a wide case: 20 up to u=256, 8 past it, fewer past u=1024,
# where the JAX kernels' interpret mode takes seconds a step.
WIDE_STEPS = {1025: 3, 2048: 2, 4100: 2}
WIDE_STEPS_MAX_UNITS = 256


@pytest.mark.parametrize("cell,units,rate", WIDE_CASES)
def test_lstm_train_matches_jax_vjp_u128(cell, units, rate):
    """One training step (loss and gradients) of either cell's autograd
    Function at widths from u=128 to u=4100 (named for the LSTM at u=128,
    its first case), against the JAX custom VJP, at the tolerances above
    (past u=256 over 8 steps, not 20, and past u=1024 over 3 or 2: the JAX
    kernels' interpret mode takes seconds a step there).  The loss weights have
    random magnitudes and the signs of the forward's avg, so the loss is a
    sum of 2 x T x u positive terms: with random signs it cancels to a
    value near 0 (0.06 at u=129), where rtol 1e-5 reads the float32
    rounding of avg (which agrees within 3e-7) and not the kernels'
    agreement."""
    batch = 2
    steps = WIDE_STEPS.get(units, 20 if units <= WIDE_STEPS_MAX_UNITS else 8)
    params, codes, masks = random_case(units, cell, batch, steps, units,
                                       rate)
    with torch.no_grad():
        avg_sign = np.sign(cuda_rnn._PLAIN[cell][0](
            *to_torch(params, codes, masks))[0].numpy())
    rng = np.random.default_rng(12)
    w_avg = (np.abs(rng.normal(size=(batch, steps, units)))
             * avg_sign).astype(np.float32)
    fn, j_params, j_codes, j_masks, has_mask = jax_train(cell, params,
                                                         codes, masks)

    def loss_jax(p):
        return jnp.sum(fn(p, j_codes, j_masks, has_mask)[0] * w_avg)

    want_v, want_g = jax.value_and_grad(loss_jax)(j_params)
    t_params, t_codes, t_masks = to_torch(params, codes, masks)
    for value in t_params.values():
        value.requires_grad_(True)
    avg, _ = cuda_rnn.avg_train(cell, t_params, t_codes, t_masks)
    loss = (avg * torch.from_numpy(w_avg)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for name in ("kernel", "recurrent", "bias"):
        np.testing.assert_allclose(t_params[name].grad.numpy(),
                                   np.asarray(want_g[name]), atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("batch,steps,units", SHAPES)
def test_plain_bwd_matches_autograd(cell, rate, batch, steps, units):
    """The explicit reverse loop equals torch autograd through the plain
    forward (which is differentiable torch code)."""
    params, codes, masks = random_case(3 * steps + units, cell, batch,
                                       steps, units, rate)
    t_params, t_codes, t_masks = to_torch(params, codes, masks)
    for value in t_params.values():
        value.requires_grad_(True)
    fwd, bwd = cuda_rnn._PLAIN[cell]
    avg, hidden, *seqs = fwd(t_params, t_codes, t_masks)
    rng = np.random.default_rng(5)
    d_avg = torch.from_numpy(rng.normal(size=avg.shape).astype(np.float32))
    d_hid = torch.from_numpy(rng.normal(size=hidden.shape).astype(
        np.float32))
    torch.autograd.backward([avg, hidden], [d_avg, d_hid])
    with torch.no_grad():
        grads = bwd(t_params, t_codes, t_masks, *(s.detach() for s in seqs),
                    d_avg, d_hid)
    for name, got in zip(("kernel", "recurrent", "bias"), grads):
        assert got.shape == t_params[name].shape
        torch.testing.assert_close(got, t_params[name].grad, atol=1e-5,
                                   rtol=0, msg=name)


def test_train_layout_by_width():
    """The training kernels' layout of a width (the window tile up to
    u=128, the cluster tile past it up to ``TRAIN_CLUSTER_MAX_UNITS``,
    u=511), the grid tile from u=512 at every width, and the refusal of
    u <= 0 only."""
    for units, layout in ((1, "registers"), (64, "registers"), (65, "l2"),
                          (128, "l2"), (129, "cluster"), (256, "cluster"),
                          (257, "cluster"), (511, "cluster"), (512, "grid"),
                          (520, "grid"),
                          (1023, "grid"), (1024, "grid"), (1025, "grid"),
                          (2048, "grid"), (3000, "grid"),
                          (4096, "grid"), (4097, "grid"), (4100, "grid"),
                          (8192, "grid"), (26800, "grid")):
        assert cuda_rnn.train_layout(units) == layout
    assert cuda_rnn.TRAIN_CLUSTER_MAX_UNITS == 511
    assert cuda_rnn.TRAIN_WINDOW_UNITS == 128
    for units in (0, -1):
        with pytest.raises(ValueError, match=f"u >= 1, not u={units}"):
            cuda_rnn.train_layout(units)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,units", [
    (2, 1024), (10, 1025), (32, 4096), (38, 4097), (74, 2048), (128, 3001),
    (128, 3300), (128, 4097), (128, 4608), (512, 1024), (512, 1537),
    (512, 4096), (4, 26800)])
def test_grid_bwd_tile_by_fill(rows, units, sms):
    """The grid's backward step (B) (pure Python): 32 rows a CTA and 1-4
    blocks of 32 units, never more than the width has, and CTAs that
    cover every row and unit.  On 132 SMs, at the three shapes whose
    every count ``tools/train_tile_sweep.py --ablate`` timed (the note at
    ``GRID_BWD_BLOCK_COST``), the count that was fastest: B=64, u=4608 3
    blocks, B=256, u=1024 2, B=16, u=4096 1."""
    row_blocks, blocks = -(-rows // 32), -(-units // 32)
    groups = cuda_rnn.grid_bwd_groups(rows, units, sms)
    assert 1 <= groups <= min(cuda_rnn.GRID_BWD_MAX_GROUPS, blocks)
    tile = cuda_rnn.grid_bwd_tile(rows, units, sms)
    assert tile == (32, 32 * groups, row_blocks * -(-blocks // groups))
    assert tile[0] * row_blocks >= rows
    assert tile[1] * (tile[2] // row_blocks) >= units
    fastest = {(128, 4608): 3, (512, 1024): 2, (32, 4096): 1}
    if sms == 132 and (rows, units) in fastest:
        assert groups == fastest[(rows, units)]
    with pytest.raises(ValueError, match="u=0"):
        cuda_rnn.grid_bwd_groups(rows, 0, sms)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cpu_function_runs_plain_versions(cell):
    params, codes, masks = to_torch(*random_case(2, cell, 3, 8, 4, 0.2))
    for value in params.values():
        value.requires_grad_(True)
    launches = cuda_rnn.LAUNCHES.snapshot()
    fwd_calls = rnn.PLAIN_CALLS.get(f"{cell}_train_fwd")
    bwd_calls = rnn.PLAIN_CALLS.get(f"{cell}_train_bwd")
    avg, hidden = cuda_rnn.avg_train(cell, params, codes, masks)
    (avg.sum() + hidden.sum()).backward()
    assert rnn.PLAIN_CALLS.get(f"{cell}_train_fwd") == fwd_calls + 1
    assert rnn.PLAIN_CALLS.get(f"{cell}_train_bwd") == bwd_calls + 1
    assert cuda_rnn.LAUNCHES.snapshot() == launches
    assert codes.grad is None and masks.grad is None


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_train_launchers_refuse_cpu_tensors(cell):
    params, codes, masks = to_torch(*random_case(1, cell, 2, 5, 4, 0.2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rnn.train_fwd(cell, params, codes, masks)
    hseq = torch.zeros(4, 5, 4)
    seqs = (hseq, hseq) if cell == "lstm" else (hseq,)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rnn.train_bwd(cell, params, codes, masks, seqs,
                           torch.zeros(2, 5, 4), torch.zeros(2, 4))


def test_dropout_masks_shape_and_values():
    gen = torch.Generator().manual_seed(0)
    masks = rnn.input_dropout_masks(gen, 2 * 64, 0.25, 3)
    assert masks.shape == (3, 128, 5) and masks.dtype == torch.float32
    values = set(masks.unique().tolist())
    assert values <= {0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs((masks > 0).float().mean().item() - 0.75) < 0.05
    again = rnn.input_dropout_masks(torch.Generator().manual_seed(0),
                                    128, 0.25, 3)
    assert torch.equal(masks, again)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_init_follows_keras_defaults(cell):
    """Distribution-level parity with the JAX initialisers (the PRNG
    streams differ): glorot bound, orthonormal recurrent rows, biases."""
    units = 6
    gen = torch.Generator().manual_seed(3)
    init = rnn.lstm_init if cell == "lstm" else rnn.gru_init
    params = init(5, units, gen)
    gates = gates_of(cell)
    key = jax.random.PRNGKey(0)
    want = (jax_rnn.lstm_init if cell == "lstm" else jax_rnn.gru_init)(
        key, 5, units)
    for name in ("kernel", "recurrent", "bias"):
        assert tuple(params[name].shape) == want[name].shape, name
    limit = (6.0 / (5 + gates * units)) ** 0.5
    assert params["kernel"].abs().max().item() <= limit
    rec = params["recurrent"]
    torch.testing.assert_close(rec @ rec.T, torch.eye(units), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(params["bias"].numpy(),
                                  np.asarray(want["bias"]))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("units", [60, 128, 256])
def test_init_independent_of_thread_count(cell, units):
    """The same seed gives the same initial weights, bit for bit, at one
    torch host thread and at ``os.cpu_count()`` (the recurrent kernel's
    orthogonal init is a host QR, whose bits follow the thread count
    unless pinned); the caller's thread count is restored."""
    init = rnn.lstm_init if cell == "lstm" else rnn.gru_init
    saved = torch.get_num_threads()
    try:
        got = {}
        for threads in (1, os.cpu_count() or 1):
            torch.set_num_threads(threads)
            got[threads] = init(5, units, torch.Generator().manual_seed(0))
            assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(saved)
    one, many = got.values()
    for name in ("kernel", "recurrent", "bias"):
        assert torch.equal(one[name], many[name]), name


SPLIT_SHAPES = [(3, 17, 8), (5, 40, 12)]


def cotangents(seed, batch, steps, units):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, steps, units)).astype(np.float32),
            rng.normal(size=(batch, units)).astype(np.float32))


def plain_split(cell, params, codes, masks, seqs, d_avg, d_hid):
    """The plain recurrence of ``cell``, then the plain reduction fed its
    cotangents (GRU: ``d_rp`` and ``d_xp``; LSTM: ``da``)."""
    hseq = seqs[0]
    if cell == "lstm":
        da_seq = rnn.lstm_bwd_recurrence_plain(params, codes, masks, *seqs,
                                               d_avg, d_hid)
        assert da_seq.shape == hseq.shape[:2] + (4 * hseq.shape[2],)
        return rnn.train_reduce_plain(hseq, da_seq, codes, masks)
    d_rp, d_xp = rnn.gru_bwd_recurrence_plain(params, codes, masks, hseq,
                                              d_avg, d_hid)
    assert d_rp.shape == d_xp.shape == hseq.shape[:2] + (3 * hseq.shape[2],)
    return rnn.train_reduce_plain(hseq, d_rp, codes, masks, d_xp)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("batch,steps,units", SPLIT_SHAPES)
def test_plain_reduce_matches_pallas_vjp(cell, rate, batch, steps, units):
    """The plain reduction fed the plain recurrence's cotangents gives the
    JAX custom VJP's ``(dW, dU, db)`` (interpret mode), atol 1e-5."""
    params, codes, masks = random_case(batch * units + steps, cell, batch,
                                       steps, units, rate)
    d_avg, d_hid = cotangents(steps, batch, steps, units)
    fn, j_params, j_codes, j_masks, has_mask = jax_train(cell, params,
                                                         codes, masks)
    _, vjp = jax.vjp(lambda p: fn(p, j_codes, j_masks, has_mask), j_params)
    (want,) = vjp((jnp.asarray(d_avg), jnp.asarray(d_hid)))
    t_params, t_codes, t_masks = to_torch(params, codes, masks)
    _, _, *seqs = cuda_rnn._PLAIN[cell][0](t_params, t_codes, t_masks)
    got = plain_split(cell, t_params, t_codes, t_masks, seqs,
                      torch.from_numpy(d_avg), torch.from_numpy(d_hid))
    for name, grad in zip(("kernel", "recurrent", "bias"), got):
        assert grad.shape == t_params[name].shape, name
        np.testing.assert_allclose(grad.numpy(), np.asarray(want[name]),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("batch,steps,units", SPLIT_SHAPES)
def test_split_plain_bwd_matches_autograd(cell, rate, batch, steps, units):
    """The composed plain backward (recurrence, then reduction) equals
    torch autograd through the plain forward, atol 1e-5, and is exactly the
    composition of its two parts."""
    params, codes, masks = random_case(batch + 2 * units, cell, batch,
                                       steps, units, rate)
    t_params, t_codes, t_masks = to_torch(params, codes, masks)
    for value in t_params.values():
        value.requires_grad_(True)
    plain_fwd, plain_bwd = cuda_rnn._PLAIN[cell]
    avg, hidden, *seqs = plain_fwd(t_params, t_codes, t_masks)
    d_avg, d_hid = (torch.from_numpy(a) for a in
                    cotangents(units, batch, steps, units))
    torch.autograd.backward([avg, hidden], [d_avg, d_hid])
    with torch.no_grad():
        seqs = [seq.detach() for seq in seqs]
        grads = plain_bwd(t_params, t_codes, t_masks, *seqs, d_avg, d_hid)
        parts = plain_split(cell, t_params, t_codes, t_masks, seqs, d_avg,
                            d_hid)
    for name, got, part in zip(("kernel", "recurrent", "bias"), grads,
                               parts):
        torch.testing.assert_close(got, t_params[name].grad, atol=1e-5,
                                   rtol=0, msg=name)
        assert torch.equal(got, part), name


@pytest.mark.parametrize("batch,steps,units,gates,sms", [
    (256, 342, 60, 4, 132), (37, 150, 32, 4, 132), (64, 342, 96, 4, 132),
    (1, 1, 5, 4, 132), (256, 342, 60, 3, 114), (256, 342, 2048, 3, 132),
    (256, 342, 4096, 4, 132)])
def test_reduce_splits(batch, steps, units, gates, sms):
    """The reduction's split count: at least one, no more than one for
    every 256 rows, at most about four CTAs an SM, and a function of the
    shape and SM count alone (so sums repeat bitwise).  The partials' rows
    a split, ``(u + 7) g u``, stay below 2^31 up to the cluster tiles'
    ceiling u=4096 (past u=23,167 they do not: the kernel counts them in
    64 bits)."""
    rows = 2 * batch * steps
    splits = cuda_rnn.reduce_splits(rows, units, gates, sms)
    assert (units + 7) * gates * units < 2 ** 31
    assert splits == cuda_rnn.reduce_splits(rows, units, gates, sms)
    assert 1 <= splits <= -(-rows // 256)
    tiles = -(-gates * units // 64) * -(-units // 64)
    assert tiles * splits <= 4 * sms + tiles
    if (batch, steps, units, gates) == (256, 342, 60, 4):
        assert splits == 132  # 4 column tiles x 132 splits: 4 CTAs an SM
    if units == 4096:
        assert splits == 1  # 256 x 64 tiles already fill the card
