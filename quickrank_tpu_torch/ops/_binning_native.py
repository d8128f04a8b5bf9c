"""ctypes bindings for the native C++ feature binner (``native/binner.cc``),
the same source the JAX package binds.  Built with g++ on first use into the
port's build directory, with ``-ffp-contract=off`` so the equi-width grid
``fmin + step * i`` is rounded twice, as the numpy fallback rounds it.
``ops/binning.py`` routes any failure here to its numpy path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from quickrank_tpu_torch._build import BUILD_DIR, compile_library, is_stale

_SRC = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                 "native", "binner.cc")
)
_LIB_PATH = os.path.join(BUILD_DIR, "libbinner.so")
_GXX = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
        "-std=c++17", "-pthread"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        if is_stale(_LIB_PATH, [_SRC]):
            compile_library(_GXX, [_SRC], _LIB_PATH)
        lib = ctypes.CDLL(_LIB_PATH)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bin_build_thresholds.restype = ctypes.c_int
        lib.bin_build_thresholds.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            f32p, i32p,
        ]
        lib.bin_apply.restype = ctypes.c_int
        lib.bin_apply.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_int, i32p,
        ]
        _lib = lib
    return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_thresholds(features: np.ndarray, nthresholds: int):
    """Native threshold-table build: ``(thresholds [F, nthresholds + 1],
    counts [F])``; ``nthresholds`` must be > 0."""
    if nthresholds <= 0:
        raise ValueError("the native binner needs nthresholds > 0")
    lib = _load()
    feats = np.ascontiguousarray(features, np.float32)
    N, F = feats.shape
    out = np.empty((F, nthresholds + 1), np.float32)
    counts = np.empty((F,), np.int32)
    rc = lib.bin_build_thresholds(
        _f32p(feats), N, F, int(nthresholds), 0, _f32p(out),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"bin_build_thresholds failed (rc={rc})")
    return out, counts


def apply_bins(features: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Native bin ids int32 ``[N, F]``."""
    lib = _load()
    feats = np.ascontiguousarray(features, np.float32)
    th = np.ascontiguousarray(thresholds, np.float32)
    N, F = feats.shape
    if th.shape[0] != F:
        raise ValueError(f"thresholds for {th.shape[0]} features, data has {F}")
    out = np.empty((N, F), np.int32)
    rc = lib.bin_apply(
        _f32p(feats), N, F, _f32p(th), th.shape[1], 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"bin_apply failed (rc={rc})")
    return out
