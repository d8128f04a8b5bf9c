"""ctypes bindings for the native C++ SVML parser and writer
(``native/svml_parser.cc``, ``native/svml_writer.cc``), the same sources the
JAX package binds.  The libraries are built with g++ on first use into the
port's build directory; ``data/svml.py`` routes any failure here to its numpy
parser and Python writer.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from quickrank_tpu_torch._build import BUILD_DIR, compile_library, is_stale

_NATIVE = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                 "native")
)
_SRC = os.path.join(_NATIVE, "svml_parser.cc")
_LIB_PATH = os.path.join(BUILD_DIR, "libsvmlparse.so")
_WSRC = os.path.join(_NATIVE, "svml_writer.cc")
_WLIB_PATH = os.path.join(BUILD_DIR, "libsvmlwrite.so")

_GXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread"]

_lib = None
_wlib = None


class _SvmlResult(ctypes.Structure):
    _fields_ = [
        ("num_docs", ctypes.c_int64),
        ("num_features", ctypes.c_int64),
        ("features", ctypes.POINTER(ctypes.c_float)),
        ("labels", ctypes.POINTER(ctypes.c_float)),
        ("qids", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char_p),
    ]


def _library(src: str, lib_path: str) -> ctypes.CDLL:
    if is_stale(lib_path, [src]):
        compile_library(_GXX, [src], lib_path)
    return ctypes.CDLL(lib_path)


def _load():
    global _lib
    if _lib is None:
        lib = _library(_SRC, _LIB_PATH)
        lib.svml_read.restype = ctypes.POINTER(_SvmlResult)
        lib.svml_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.svml_release.restype = None
        lib.svml_release.argtypes = [ctypes.POINTER(_SvmlResult)]
        _lib = lib
    return _lib


def read(path: str, nthreads: int = 0):
    """Parse an SVML file into a Dataset using the native parser."""
    from quickrank_tpu_torch.data.dataset import Dataset

    lib = _load()
    res = lib.svml_read(path.encode(), nthreads)
    try:
        r = res.contents
        if r.error:
            raise ValueError(f"{path}: {r.error.decode()}")
        n, f = int(r.num_docs), int(r.num_features)
        feats = np.ctypeslib.as_array(r.features, shape=(n, f)).copy()
        labels = np.ctypeslib.as_array(r.labels, shape=(n,)).copy()
        qids = np.ctypeslib.as_array(r.qids, shape=(n,)).copy()
    finally:
        lib.svml_release(res)
    return Dataset.from_arrays(feats, labels, qids, name=os.path.basename(path))


def _load_writer():
    global _wlib
    if _wlib is None:
        lib = _library(_WSRC, _WLIB_PATH)
        lib.svml_write.restype = ctypes.c_int
        lib.svml_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
        ]
        _wlib = lib
    return _wlib


def write(ds, path: str, nthreads: int = 0) -> None:
    """Write a Dataset as SVML with the multithreaded native writer.
    Raises on any toolchain or I/O failure."""
    lib = _load_writer()
    feats = np.ascontiguousarray(ds.features, np.float32)
    labels = np.ascontiguousarray(ds.labels, np.float32)
    qids = np.ascontiguousarray(np.repeat(ds.qids, ds.docs_per_query()), np.int64)
    rc = lib.svml_write(
        path.encode(),
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        qids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(feats.shape[0]),
        ctypes.c_int64(feats.shape[1]),
        ctypes.c_int(nthreads),
    )
    if rc != 0:
        raise OSError(f"native svml writer failed (rc={rc}) for {path}")
