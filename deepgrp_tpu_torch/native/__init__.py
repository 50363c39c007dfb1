"""Native host library: build at first use, load with ctypes.

Compiles ``native/src/*.cc`` (a copy of the parts of the JAX package's
native library that prediction uses: the Ruzzo–Tompa MSS labelling and
N-trimming; and the streaming MSS's split scan, which the JAX package
does in numpy) with ``g++`` into ``deepgrp_tpu_torch/_build/`` and loads it.
A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from deepgrp_tpu_torch import _build

SRC_DIR = _build.PKG_DIR / "native" / "src"
SOURCES = tuple(SRC_DIR / name
                for name in ("mss.cc", "mss_parallel.cc", "encode.cc"))
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class DgSegment(ctypes.Structure):
    """Mirror of the C ``DgSegment`` struct (``deepgrp_native.h``)."""

    _fields_ = [
        ("start", ctypes.c_int64),
        ("end", ctypes.c_int64),
        ("score", ctypes.c_double),
    ]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.dg_mss_find_all_mt.restype = i64
    lib.dg_mss_find_all_mt.argtypes = [
        ctypes.POINTER(ctypes.c_double), i64, ctypes.c_double,
        ctypes.c_double, i32, ctypes.POINTER(DgSegment), i64,
    ]
    lib.dg_find_mss_classes_mt.restype = None
    lib.dg_find_mss_classes_mt.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(i64), i64, i32, i32,
        i32, i32, ctypes.POINTER(i32),
    ]
    for fn, scores in ((lib.dg_split_scan_f32, ctypes.c_float),
                       (lib.dg_split_scan_f64, ctypes.c_double)):
        fn.restype = i64
        fn.argtypes = [
            ctypes.POINTER(scores), i64, i64, ctypes.c_double, i64,
            ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(i64),
        ]
    lib.dg_trim_n.restype = None
    lib.dg_trim_n.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    return lib


def load() -> ctypes.CDLL:
    """The native library, built on first use (raises if the build
    fails)."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build.build_shared_library("deepgrp_native", ["g++"],
                                               SOURCES, GXX_FLAGS)
            _lib = _declare(ctypes.CDLL(str(path)))
        return _lib
