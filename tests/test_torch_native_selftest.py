"""The port's native host library (``deepgrp_tpu_torch/native/``): its C++
self-test through ``make check``, plain and under ASAN/UBSAN (the
counterpart of ``tests/test_native_selftest.py``), and the library held
against the JAX package's on seeded score tracks (segments and classes
equal: both do the same float64 work in the same order)."""

import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest

pytest.importorskip("jax")
from deepgrp_tpu import native as jax_native  # noqa: E402
from deepgrp_tpu_torch.ops import mss  # noqa: E402

from test_torch_ops import load_jax_native  # noqa: E402

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..",
                          "deepgrp_tpu_torch", "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "..", "_build")
S0 = math.log(0.99 / 0.01)


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("make") is None,
                    reason="toolchain unavailable")
def test_native_selftest_with_sanitizers():
    """The self-test (MSS search, class labelling, N-trimming, the split
    scan) passes plain and under the sanitizers; both binaries land in
    ``_build/``, none in the sources."""
    result = subprocess.run(["make", "-s", "check"], cwd=NATIVE_DIR,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stdout + result.stderr
    assert result.stdout.count("native selftest OK") == 2
    for name in ("selftest", "selftest_asan"):
        assert os.path.isfile(os.path.join(BUILD_DIR, name)), name
    assert sorted(os.listdir(os.path.join(NATIVE_DIR, "src"))) == [
        "deepgrp_native.h", "encode.cc", "mss.cc", "mss_parallel.cc",
        "selftest.cc"]


def scores_and_labels(seed, n, positive_rate):
    """A score track shaped like the MSS transform's output, blocks of it
    dense in positives (segments), and random labels 0..4."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.1, S0, size=n)
    rate = np.where((np.arange(n) >> 11) % 4 == 0, 0.3, positive_rate)
    scores = np.where(rng.random(n) < rate, t, -10 * t)
    return scores, rng.integers(0, 5, size=n).astype(np.int64)


def jax_segments(lib, scores, min_score, xdrop, threads):
    out = (jax_native.DgSegment * (scores.size // 2 + 1))()
    count = lib.dg_mss_find_all_mt(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), scores.size,
        min_score, xdrop, threads, out, len(out))
    return [(s.start, s.end, s.score) for s in out[:count]]


CASES = [(0, 1 << 16, 0.97, 1), (1, 1 << 18, 0.97, 8), (2, 1 << 17, 0.9, 3),
         (3, 5000, 0.95, 2)]


@pytest.mark.parametrize("seed,n,positive_rate,threads", CASES)
@pytest.mark.parametrize("min_mss_len,xdrop_len", [(50, 50), (10, 0)])
def test_library_matches_jax_library(seed, n, positive_rate, threads,
                                     min_mss_len, xdrop_len):
    """``dg_mss_find_all_mt`` and ``dg_find_mss_classes_mt`` of the two
    packages' libraries give the same segments and classes."""
    jax_lib = load_jax_native()
    assert jax_lib is not None
    scores, labels = scores_and_labels(seed, n, positive_rate)
    min_score = S0 * min_mss_len
    xdrop = S0 * xdrop_len * 10 if xdrop_len > 0 else -1.0
    got = mss.mss_find_all(scores, min_score, xdrop, threads)
    want = jax_segments(jax_lib, scores, min_score, xdrop, threads)
    assert len(want) > 0
    assert [(int(s), int(e), float(v)) for s, e, v in got] == want

    classes = mss.find_mss_classes(scores, labels, 5, min_mss_len,
                                   xdrop_len, threads)
    want_classes = np.empty(n, np.int32)
    jax_lib.dg_find_mss_classes_mt(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, 5,
        min_mss_len, xdrop_len, threads,
        want_classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    np.testing.assert_array_equal(classes, want_classes)
    assert not np.array_equal(classes, labels)  # some label was voted
