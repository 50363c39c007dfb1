"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU).

Run on a machine with a CUDA card, without the JAX conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card, at
atol 1e-5 (the JAX package's kernel tolerance, tests/test_pallas_rnn.py):
the kernel and the plain version sum the recurrent dot in other orders.
The shapes include the engine's default tile at the flagship shape
(1024 windows, T=342, u=60), a ragged batch and tiny widths.
"""

import os

import numpy as np
import pytest
import torch

from deepgrp_tpu_torch.models import cuda_rnn, rnn
from deepgrp_tpu_torch.models.keras_io import load_model
from deepgrp_tpu_torch.models.model import (DeepGRPModel,
                                            require_full_f32_matmul)
from deepgrp_tpu_torch.predict.engine import PredictionEngine

pytestmark = pytest.mark.cuda

ATOL = 1e-5
TORCH_FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "torch")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    require_full_f32_matmul()
    return torch.device("cuda")


def random_case(seed, gates, batch, steps, units, device):
    rng = np.random.default_rng(seed)
    width = gates * units
    params = {
        "kernel": rng.normal(0.0, 0.5, (5, width)),
        "recurrent": rng.normal(0.0, units ** -0.5, (units, width)),
        "bias": rng.normal(0.0, 0.3, (2, width) if gates == 3 else (width,)),
    }
    codes = rng.integers(0, 6, size=(batch, steps)).astype(np.int8)
    codes[0, :3] = 4  # N
    codes[-1, -4:] = 5  # pad
    return ({k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in params.items()},
            torch.from_numpy(codes).to(device))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("batch,steps,units", [(1024, 342, 60),
                                               (1000, 150, 32), (3, 7, 5),
                                               (9, 1, 17)])
def test_kernel_matches_plain(device, cell, batch, steps, units):
    gates = 4 if cell == "lstm" else 3
    params, codes = random_case(batch + steps + units, gates, batch, steps,
                                units, device)
    kernel = getattr(cuda_rnn, f"{cell}_avg")
    plain = getattr(rnn, f"{cell}_avg_plain")
    launches = cuda_rnn.LAUNCHES.get(f"{cell}_avg")
    avg, hidden = kernel(params, codes)
    torch.cuda.synchronize()
    assert cuda_rnn.LAUNCHES.get(f"{cell}_avg") == launches + 1
    want_avg, want_hidden = plain(params, codes)
    assert avg.shape == (batch, steps, units)
    assert hidden.shape == (batch, units)
    torch.testing.assert_close(avg, want_avg, atol=ATOL, rtol=0)
    torch.testing.assert_close(hidden, want_hidden, atol=ATOL, rtol=0)


def test_kernel_refuses_wrong_dtype(device):
    params, codes = random_case(0, 3, 4, 8, 6, device)
    with pytest.raises(ValueError, match="int8"):
        cuda_rnn.gru_avg(params, codes.int())


def test_engine_on_card_matches_cpu(device):
    """The whole scan on the card (kernels) against the same scan on the
    CPU (plain versions): classes equal, max probability to 1e-5."""
    config, params = load_model(
        os.path.join(TORCH_FIXDIR, "gru_att.npz"))
    codes = np.random.default_rng(3).integers(0, 5, 20000).astype(np.int8)
    results = []
    for dev in (device, "cpu"):
        model = DeepGRPModel.from_params(config, params, dev)
        results.append(PredictionEngine(model, batch_size=64,
                                        step_size=50).predict_scored(codes))
    (got_c, got_p), (want_c, want_p) = results
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, atol=ATOL)
