"""The port's host and device operators against the JAX package's.

Inputs come from numpy seeds.  Everything here is exact: encoding, MSS
labelling, segments and FASTA reading are integer or identical float64
work, and the overlap-max merge is a max (no rounding).
"""

import fcntl
import io
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu import native as jax_native  # noqa: E402
from deepgrp_tpu.data import fasta as jax_fasta  # noqa: E402
from deepgrp_tpu.ops import encoding as jax_encoding  # noqa: E402
from deepgrp_tpu.ops import mss as jax_mss  # noqa: E402
from deepgrp_tpu.ops import overlap_max as jax_overlap  # noqa: E402
from deepgrp_tpu.ops import segments as jax_segments  # noqa: E402
from deepgrp_tpu.predict import engine as jax_engine  # noqa: E402
from deepgrp_tpu_torch.data.fasta import read_multi_fasta  # noqa: E402
from deepgrp_tpu_torch.ops import mss  # noqa: E402
from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed  # noqa: E402
from deepgrp_tpu_torch.ops.overlap_max import overlap_max_merge  # noqa: E402
from deepgrp_tpu_torch.ops.segments import yield_segments  # noqa: E402
from deepgrp_tpu_torch.predict import engine  # noqa: E402

S0 = math.log(0.99 / 0.01)


def load_jax_native():
    """Loads the JAX package's host library, building it at most once at a
    time across processes, and recovers a worker whose loader gave up.

    The loader compiles straight into the library's path, and once a load
    fails it gives up for the life of the process (``_load_failed``).  So a
    test worker that loaded while another compiled read a half-written
    file, and every test of that worker that needs the library skipped
    (``tests/test_mss.py``).  Under an exclusive lock on the loader's source
    file, a worker without the library rebuilds it with the loader's own
    command into a temporary file beside it, moves that into place (so no
    process maps a half-written file), clears the loader's verdict and loads
    again.  A worker whose load succeeded is left alone."""
    with open(jax_native.__file__, "rb") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if (jax_native._lib is None
                    and not os.environ.get("DEEPGRP_TPU_NO_NATIVE")):
                _rebuild_jax_native()
            return jax_native.load()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _rebuild_jax_native():
    """Runs the loader's compile into a temporary file beside the library
    (the loader writes to its module-level ``_LIB_PATH``), renames it over
    the library and clears ``_load_failed``."""
    lib_path = jax_native._LIB_PATH
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    jax_native._LIB_PATH = tmp
    try:
        built = jax_native._compile()
    finally:
        jax_native._LIB_PATH = lib_path
    if built:
        os.replace(tmp, lib_path)
    jax_native._load_failed = False


# Every test worker collects this module before it runs a test.
load_jax_native()


def test_jax_native_library_loads():
    """Both packages' host libraries load, so the JAX package's native
    tests run instead of skipping."""
    assert jax_native.available()
    assert load_jax_native() is not None


def random_scores(rng, n):
    """Score tracks shaped like the MSS transform's output."""
    t = rng.uniform(0.1, S0, size=n)
    return np.where(rng.random(n) < 0.3, t, -10 * t)


@pytest.mark.parametrize("n,vecsize,step,out_len", [
    (7, 30, 10, 90), (5, 23, 7, 40), (1, 12, 12, 12), (6, 10, 15, 100),
    (0, 10, 5, 20)])
def test_overlap_max_merge_matches_jax(n, vecsize, step, out_len):
    windows = np.random.default_rng(n + vecsize).random(
        (n, vecsize, 5)).astype(np.float32)
    want = np.asarray(jax_overlap.overlap_max_merge(jnp.asarray(windows),
                                                    step, out_len))
    got = overlap_max_merge(torch.from_numpy(windows), step, out_len)
    np.testing.assert_array_equal(got.numpy(), want)


def random_dna(rng, length, alphabet="ACGTN"):
    return "".join(rng.choice(list(alphabet), size=length))


@pytest.mark.parametrize("seq", [
    "NNNACGTNNACGTNN", "ACGT", "NNNN", "", "acgtnNxyzACGT", "N", "NANNTN"])
def test_encode_codes_trimmed_matches_jax_cases(seq):
    start, codes = encode_codes_trimmed(seq)
    want_start, want = jax_encoding.encode_codes_trimmed(seq)
    assert start == want_start
    assert codes.dtype == np.int8
    np.testing.assert_array_equal(codes, want)


@pytest.mark.parametrize("seed", range(3))
def test_encode_codes_trimmed_matches_jax_random(seed):
    rng = np.random.default_rng(seed)
    seq = "N" * int(rng.integers(0, 9)) + random_dna(rng, 3000, "ACGTNacgt") \
        + "N" * int(rng.integers(0, 9))
    start, codes = encode_codes_trimmed(seq)
    want_start, want = jax_encoding.encode_codes_trimmed(seq)
    assert start == want_start
    np.testing.assert_array_equal(codes, want)


@pytest.mark.parametrize("n,threads", [(5000, 1), (1 << 17, 4), (0, 1)])
@pytest.mark.parametrize("min_len,xdrop_len", [(50, 50), (10, 0), (1, 5),
                                               (25, -1)])
def test_find_mss_classes_matches_jax(n, threads, min_len, xdrop_len):
    rng = np.random.default_rng(n + min_len)
    scores = random_scores(rng, n)
    labels = rng.integers(0, 5, size=n)
    got = mss.find_mss_classes(scores, labels, 5, min_len, xdrop_len,
                               threads=threads)
    want = jax_mss.find_mss_classes(scores, labels, 5, min_len, xdrop_len,
                                    threads=threads)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("xdrop_len", [50, 0])
def test_find_mss_classes_matches_spec(xdrop_len):
    rng = np.random.default_rng(xdrop_len)
    scores = random_scores(rng, 4000)
    labels = rng.integers(0, 5, size=4000)
    np.testing.assert_array_equal(
        mss.find_mss_classes(scores, labels, 5, 20, xdrop_len),
        mss.find_mss_classes_spec(scores, labels, 5, 20, xdrop_len))


def test_find_mss_classes_rejects_bad_labels():
    with pytest.raises(ValueError, match="labels"):
        mss.find_mss_classes(np.ones(4), np.array([0, 1, 5, 2]), 5, 1, 1)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("offset", [0, 17])
def test_yield_segments_matches_jax(seed, offset):
    rng = np.random.default_rng(seed)
    classes = np.repeat(rng.integers(0, 5, size=60),
                        rng.integers(1, 9, size=60))
    assert list(yield_segments(classes, offset)) == list(
        jax_segments.yield_segments(classes, offset))


@pytest.mark.parametrize("classes", [[], [3], [0], [0, 0, 2], [1, 1, 1]])
def test_yield_segments_edge_cases_match_jax(classes):
    classes = np.asarray(classes, dtype=np.int32)
    assert list(yield_segments(classes, 0)) == list(
        jax_segments.yield_segments(classes, 0))


def test_read_multi_fasta_matches_jax():
    text = ">chr1 desc\nacgtN\nNNAC\n\n>chr2\nGGGG\n>empty\n>chr3\nttaa\n"
    assert list(read_multi_fasta(io.StringIO(text))) == list(
        jax_fasta.read_multi_fasta(io.StringIO(text)))


def test_window_starts_and_score_transform_match_jax():
    for args in [(100, 30, 10), (130, 30, 50), (30, 30, 10), (10, 30, 10)]:
        np.testing.assert_array_equal(engine.window_starts(*args),
                                      jax_engine.window_starts(*args))
    rng = np.random.default_rng(0)
    classes = rng.integers(0, 5, size=1000).astype(np.int8)
    maxp = rng.random(1000).astype(np.float32)
    maxp[:5] = [0.0, 1.0, 0.99, 0.989999, 0.5]
    np.testing.assert_array_equal(
        engine.mss_score_transform(classes, maxp),
        jax_engine.mss_score_transform(classes, maxp))
