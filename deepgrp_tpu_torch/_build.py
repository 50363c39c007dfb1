"""Build-at-first-use for the package's native code, and launch counters.

Shared libraries are compiled from sources in the package, each at its
first use, into ``deepgrp_tpu_torch/_build/`` (ignored by git):

* each ``csrc/*.cu`` with ``nvcc`` for Hopper (``sm_90a``) into a library
  of its own (``rnn_avg``: the fused inference kernels, ``rnn_train``: the
  training kernels, ``rnn_seq``: the GRU over a float input sequence), a
  plain C interface loaded with :mod:`ctypes` (no
  PyTorch headers, so a build takes seconds; the libraries build
  independently, so they can build in parallel; ``rnn_grid``: the
  recurrences past the cluster tiles' ceiling, inference and training, one
  tiled product a step;
  ``mss_stack``: the on-device MSS's candidate-stack scan);
* ``native/src/*.cc`` with ``g++`` (host MSS and encoding, see
  :mod:`deepgrp_tpu_torch.native`).

A library's file name carries a hash of its sources and flags, so an edit
rebuilds it and a stale library is never loaded.  The compiler's output is
kept beside the library as ``<name>.log`` (``nvcc -Xptxas -v`` lists each
kernel's registers, shared memory and spills).  A failed build raises: there
is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "_build"
#: CUDA kernel libraries by name, one source each.
CUDA_SOURCES = {name: PKG_DIR / "csrc" / f"{name}.cu"
                for name in ("rnn_avg", "rnn_train", "rnn_seq", "rnn_grid",
                             "mss_stack")}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks = {name: threading.Lock() for name in CUDA_SOURCES}
_kernels: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Per-name integer counts (thread-safe), e.g. kernel launches.

    While :func:`recording_launches` is open, adds go into its record
    instead (a CUDA graph's capture launches nothing; each replay adds the
    record, :class:`LaunchRecord`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            record = _recording
            counts = (self._counts if record is None
                      else record.setdefault(self, {}))
            counts[name] = counts.get(name, 0) + n

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class LaunchRecord:
    """The adds of every counter made while recording, kept out of the
    counts; :meth:`replay` adds them once."""

    def __init__(self) -> None:
        self.counts: Dict[LaunchCounter, Dict[str, int]] = {}

    def replay(self) -> None:
        for counter, counts in self.counts.items():
            for name, n in counts.items():
                counter.add(name, n)


_recording: Optional[Dict[LaunchCounter, Dict[str, int]]] = None
_recording_lock = threading.Lock()


@contextlib.contextmanager
def recording_launches() -> Iterator[LaunchRecord]:
    """Within the block every :class:`LaunchCounter`'s adds, from any
    thread (the autograd engine runs a backward on its own), go into the
    yielded record instead of the counts.  One recording at a time, as one
    CUDA graph capture at a time; raises ``RuntimeError`` if another is
    open."""
    global _recording
    record = LaunchRecord()
    with _recording_lock:
        if _recording is not None:
            raise RuntimeError("launches are already being recorded")
        _recording = record.counts
    try:
        yield record
    finally:
        with _recording_lock:
            _recording = None


def build_shared_library(name: str, compiler: Sequence[str],
                         sources: Sequence[Path],
                         flags: Sequence[str]) -> Path:
    """Compile ``sources`` into ``_build/lib<name>-<hash>.so`` unless built.

    The hash covers the sources (and headers beside them) and the flags.
    The library is written under a temporary name and renamed into place,
    so a concurrent process never loads a half-written file.
    """
    digest = hashlib.sha1(" ".join([*compiler, *flags]).encode())
    src_dirs = sorted({Path(s).parent for s in sources})
    for path in sorted(p for d in src_dirs for p in d.iterdir()
                       if p.is_file()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd: List[str] = [*compiler, *flags, "-o", str(tmp),
                      *(str(s) for s in sources)]
    result = subprocess.run(cmd, capture_output=True, text=True,
                            timeout=600, check=False)
    if result.returncode != 0:
        raise RuntimeError(f"build of {name} failed: {' '.join(cmd)}\n"
                           f"{result.stdout}{result.stderr}")
    (BUILD_DIR / f"{name}.log").write_text(result.stdout + result.stderr)
    os.replace(tmp, out)
    return out


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the CUDA toolkit's standard location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin); the CUDA kernels cannot be built")
    return path


def load_kernels(name: str) -> ctypes.CDLL:
    """The CUDA kernel library ``name`` (``csrc/<name>.cu``), built on
    first use."""
    with _locks[name]:
        if name not in _kernels:
            path = build_shared_library(name, [nvcc()], [CUDA_SOURCES[name]],
                                        NVCC_FLAGS)
            lib = ctypes.CDLL(str(path))
            _DECLARE[name](lib)
            lib.dg_error_string.argtypes = [ctypes.c_int]
            lib.dg_error_string.restype = ctypes.c_char_p
            _kernels[name] = lib
        return _kernels[name]


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int


def _declare_rnn_avg(lib: ctypes.CDLL) -> None:
    # codes, batch, steps, kernel, bias, recurrent, units, windows a CTA,
    # avg, hidden, stream
    for fn in (lib.dg_gru_avg, lib.dg_gru_avg_bf16, lib.dg_lstm_avg,
               lib.dg_lstm_avg_bf16):
        fn.argtypes = [_PTR, _I32, _I32, _PTR, _PTR, _PTR, _I32, _I32, _PTR,
                       _PTR, _PTR]
        fn.restype = _I32
    lib.dg_avg_bf16_tile.argtypes = [_I32, _I32]  # gates, units
    lib.dg_avg_layout.argtypes = [_I32, _I32, _I32, _PTR]  # ..., bf16, out
    lib.dg_avg_clusters.argtypes = [_I32] * 4  # gates, units, bb, bf16
    # gates, variant, codes, batch, steps, kernel, bias, recurrent, units,
    # scratch, avg, hidden, stream
    lib.dg_avg_stationary.argtypes = ([_I32, _I32, _PTR, _I32, _I32]
                                      + [_PTR] * 3 + [_I32] + [_PTR] * 4)
    for fn in (lib.dg_avg_bf16_tile, lib.dg_avg_layout,
               lib.dg_avg_clusters, lib.dg_avg_stationary):
        fn.restype = _I32
    # gates, units, batch, variant, int[11] out -> scratch bytes
    lib.dg_avg_stationary_layout.argtypes = [_I32] * 4 + [_PTR]
    lib.dg_avg_stationary_layout.restype = ctypes.c_longlong


def _declare_rnn_train(lib: ctypes.CDLL) -> None:
    # codes, batch, steps, masks, kernel, bias, recurrent, units
    head = [_PTR, _I32, _I32, _PTR, _PTR, _PTR, _PTR, _I32]
    # the forwards: avg, hidden, hseq (and cseq), stream; the recurrences:
    # hseq (and cseq), d_avg, d_hidden, da (or d_rp, d_xp), stream
    lib.dg_gru_train_fwd.argtypes = head + [_PTR] * 4
    lib.dg_lstm_train_fwd.argtypes = head + [_PTR] * 5
    lib.dg_lstm_bwd_recurrence.argtypes = head + [_PTR] * 6
    lib.dg_gru_bwd_recurrence.argtypes = head + [_PTR] * 6
    # which (0 LSTM forward, 1 LSTM recurrence, 2 GRU recurrence, 3 GRU
    # forward), units, steps
    lib.dg_window_ctas_per_sm.argtypes = [_I32, _I32, _I32]
    # which (as above), units, batch, out [3]: CTAs a cluster, windows a
    # cluster, clusters at once
    lib.dg_train_clusters.argtypes = [_I32, _I32, _I32, _PTR]
    # hseq, r1, r2, codes, masks, batch, steps, units, gates, splits, parts,
    # d_kernel, d_bias_1, d_bias_2, d_recurrent, stream
    lib.dg_train_reduce.argtypes = ([_PTR] * 5 + [_I32] * 5 + [_PTR] * 6)
    for fn in (lib.dg_gru_train_fwd, lib.dg_lstm_train_fwd,
               lib.dg_lstm_bwd_recurrence, lib.dg_gru_bwd_recurrence,
               lib.dg_window_ctas_per_sm, lib.dg_train_clusters,
               lib.dg_train_reduce):
        fn.restype = _I32


def _declare_rnn_seq(lib: ctypes.CDLL) -> None:
    # x, batch, steps, channels, kernel, bias, recurrent, units, rows a CTA,
    # bf16, seq, last, stream
    lib.dg_gru_seq.argtypes = [_PTR, _I32, _I32, _I32, _PTR, _PTR, _PTR,
                               _I32, _I32, _I32, _PTR, _PTR, _PTR]
    lib.dg_gru_seq.restype = _I32
    # units, rows a CTA, int[4] out
    lib.dg_gru_seq_layout.argtypes = [_I32, _I32, _PTR]
    lib.dg_gru_seq_layout.restype = _I32
    # units, rows a CTA, steps, channels, bf16
    lib.dg_gru_seq_clusters.argtypes = [_I32] * 5
    lib.dg_gru_seq_clusters.restype = _I32


def _declare_rnn_grid(lib: ctypes.CDLL) -> None:
    # gates, bf16, codes, batch, steps, kernel, bias, recurrent, units, h0,
    # h1, carry, avg, hidden, stream
    lib.dg_avg_grid.argtypes = ([_I32, _I32, _PTR, _I32, _I32]
                                + [_PTR] * 3 + [_I32] + [_PTR] * 6)
    # bf16, x, batch, steps, channels, kernel, bias, recurrent, units, h0,
    # h1, carry, seq, last, stream
    lib.dg_seq_grid.argtypes = ([_I32, _PTR, _I32, _I32, _I32]
                                + [_PTR] * 3 + [_I32] + [_PTR] * 6)
    lib.dg_grid_shape.argtypes = [_I32, _I32, _PTR]  # rows, units, int64[4]
    lib.dg_grid_layout.argtypes = [_I32, _I32, _I32, _PTR]  # bf16, rows,
    # units, int[8]
    # codes, batch, steps, masks, kernel, bias, padded U, units (as
    # dg_gru_train_fwd's head); the forwards: avg, hidden, hseq (and cseq),
    # h0, h1, carry, stream; the recurrences: padded U^T, hseq (and cseq),
    # d_avg, d_hidden, d_rp and d_xp (or da), carry, cot, blocks of 32
    # units a CTA of (B), stream
    head = [_PTR, _I32, _I32, _PTR, _PTR, _PTR, _PTR, _I32]
    lib.dg_gru_train_fwd_grid.argtypes = head + [_PTR] * 7
    lib.dg_lstm_train_fwd_grid.argtypes = head + [_PTR] * 8
    lib.dg_gru_bwd_grid.argtypes = head + [_PTR] * 8 + [_I32, _PTR]
    lib.dg_lstm_bwd_grid.argtypes = head + [_PTR] * 8 + [_I32, _PTR]
    for fn in (lib.dg_avg_grid, lib.dg_seq_grid, lib.dg_grid_shape,
               lib.dg_grid_layout, lib.dg_gru_train_fwd_grid,
               lib.dg_lstm_train_fwd_grid, lib.dg_gru_bwd_grid,
               lib.dg_lstm_bwd_grid):
        fn.restype = _I32


def _declare_mss_stack(lib: ctypes.CDLL) -> None:
    # starts, ends, l_glob, r_glob, n_runs, capacity, min_score, xdrop,
    # stack_f, stack_i, out, stream
    lib.dg_mss_stack.argtypes = ([_PTR] * 5 + [_I32, ctypes.c_double,
                                               ctypes.c_double]
                                 + [_PTR] * 4)
    lib.dg_mss_stack.restype = _I32


_DECLARE: Dict[str, Callable[[ctypes.CDLL], None]] = {
    "rnn_avg": _declare_rnn_avg,
    "rnn_train": _declare_rnn_train,
    "rnn_seq": _declare_rnn_seq,
    "rnn_grid": _declare_rnn_grid,
    "mss_stack": _declare_mss_stack,
}
