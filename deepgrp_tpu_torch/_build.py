"""Build-at-first-use for the package's native code, and launch counters.

Two shared libraries are compiled from sources in the package, each at its
first use, into ``deepgrp_tpu_torch/_build/`` (ignored by git):

* ``csrc/*.cu`` with ``nvcc`` for Hopper (``sm_90a``), a plain C interface
  loaded with :mod:`ctypes` (no PyTorch headers, so the build takes seconds);
* ``native/src/*.cc`` with ``g++`` (host MSS and encoding, see
  :mod:`deepgrp_tpu_torch.native`).

A library's file name carries a hash of its sources and flags, so an edit
rebuilds it and a stale library is never loaded.  The compiler's output is
kept beside the library as ``<name>.log`` (``nvcc -Xptxas -v`` lists each
kernel's registers, shared memory and spills).  A failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "_build"
CUDA_SOURCES = (PKG_DIR / "csrc" / "rnn_avg.cu",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_kernels: Optional[ctypes.CDLL] = None


class LaunchCounter:
    """Per-name integer counts (thread-safe), e.g. kernel launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


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


def load_kernels() -> ctypes.CDLL:
    """The CUDA kernel library (``csrc/*.cu``), built on first use."""
    global _kernels
    with _lock:
        if _kernels is None:
            path = build_shared_library("rnn_avg", [nvcc()], CUDA_SOURCES,
                                        NVCC_FLAGS)
            _kernels = _declare_kernels(ctypes.CDLL(str(path)))
        return _kernels


def _declare_kernels(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.dg_gru_avg, lib.dg_lstm_avg):
        # codes, batch, steps, kernel, bias, recurrent, units, avg, hidden,
        # stream
        fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, ptr, ptr, ptr]
        fn.restype = i32
    lib.dg_rnn_avg_error_string.argtypes = [i32]
    lib.dg_rnn_avg_error_string.restype = ctypes.c_char_p
    return lib
