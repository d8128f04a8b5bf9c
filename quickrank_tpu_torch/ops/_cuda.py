"""Builds the CUDA kernels of ``quickrank_tpu_torch/csrc`` and binds them.

Every ``csrc/*.cu`` file is compiled by nvcc for ``sm_90a``, one nvcc process
per source, all started together, and the objects are linked into one shared
library with a plain C interface, ``quickrank_tpu_torch/build/libqrkernels.so``,
loaded with ctypes.  The build runs at the first kernel call, and again
whenever a source is newer than the library.  Pointers are passed as
``c_void_p``, sizes as ``c_int64``/``c_int``, the stream as ``c_void_p``.
Without nvcc the build raises: there is no other route to a kernel.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
from typing import Optional

from quickrank_tpu_torch._build import BUILD_DIR, compile_library, is_stale

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
LIB_PATH = os.path.join(BUILD_DIR, "libqrkernels.so")
#: ``-I CSRC`` finds the shared headers (``*.cuh``) from a copy of a source
#: built elsewhere too (``scripts/profile_torch_kernels.py``)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
]

#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_MAX = 232448

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry points: name -> argtypes (each returns the launch's cudaError_t)
SIGNATURES = {
    # x, n, f, packed, trees, nodes, leaves, words, stride_words, out, stream
    "qs_score": [_P, _I64, _I64, _P, _I, _I, _I, _I, _I, _P, _P],
    "qs_score_u8": [_P, _I64, _I64, _P, _I, _I, _I, _I, _I, _P, _P],
    "qs_score_u16": [_P, _I64, _I64, _P, _I, _I, _I, _I, _I, _P, _P],
    # the same arguments; out is [n, trees]
    "qs_partial": [_P, _I64, _I64, _P, _I, _I, _I, _I, _I, _P, _P],
    "qs_partial_u8": [_P, _I64, _I64, _P, _I, _I, _I, _I, _I, _P, _P],
    "qs_partial_u16": [_P, _I64, _I64, _P, _I, _I, _I, _I, _I, _P, _P],
    # x, n, f, packed, trees, depth, stride_words, out, stream
    "perfect_score": [_P, _I64, _I64, _P, _I, _I, _I, _P, _P],
    # x, x_kind, n, f, packed, trees, depth, out, stream
    "oblivious_score": [_P, _I, _I64, _I64, _P, _I, _I, _P, _P],
    # x_kind, f, trees, depth, design (int32 [5])
    "oblivious_score_design": [_I, _I64, _I, _I, _P],
    # binned, bin_bytes, n, width, features, values, channels, stride_c,
    # stride_n, pos, n0, k, num_bins, maxbits, n_scale, acc, stream
    "histogram_launch": [_P, _I, _I64, _I64, _I, _P, _I, _I64, _I64, _P, _I,
                         _I, _I, _P, _I64, _P, _P],
    # channels, num_bins: 1 where histogram_launch takes the wide-bin path
    "histogram_takes_wide_path": [_I, _I],
    # acc, ncells, channels, maxbits, n_scale, out, stream
    "histogram_to_float": [_P, _I64, _I, _P, _I64, _P, _P],
    # data, n, width, mode, dsta, dstb, stamp_z, stamp_o, fstar, tstar,
    # pos_col, out, stream
    "partition_rows": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    # x, rows, length, inner, out, stream
    "query_sum": [_P, _I64, _I64, _I64, _P, _P],
    # f, bins: the blocks a node's rows take (0: past shared memory)
    "split_scan_blocks": [_I64, _I64],
    # hist, k, f, bins, channels, masks, minls, partial, counter, can, fstar,
    # tstar, gain, stream
    "split_scan": [_P, _I64, _I64, _I64, _I, _P, ctypes.c_float, _P, _P, _P, _P, _P, _P,
                   _P],
    # hist, f, bins, channels, start, count, deviance, stream
    "node_stats": [_P, _I64, _I64, _I, _I64, _I64, _P, _P],
    # x, ndim, sizes, strides, axis_stride, rows, length, out, stream
    "xla_prefix_sum": [_P, _I, _P, _P, _I64, _I64, _I64, _P, _P],
    "xla_tree_sum": [_P, _I, _P, _P, _I64, _I64, _I64, _P, _P],
    # x, n, f, thresholds, bins, col_map, width, n_loc, out_bytes, out, stream
    "bin_apply_wire": [_P, _I64, _I64, _P, _I64, _P, _I64, _I64, _I, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def build(force: bool = False) -> str:
    """Compile the kernels when the library is missing or stale (always
    with ``force``).  Returns nvcc's stderr, which holds ptxas's register
    and spill report ('' when nothing was rebuilt).  Raises RuntimeError
    when nvcc is missing or fails."""
    srcs = sources()
    if not force and not is_stale(LIB_PATH, srcs):
        return ""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "quickrank_tpu_torch are compiled from csrc/ with nvcc at first "
            "use; CUDA tensors have no other path"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        _, err = proc.communicate()
        log.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode})\n{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        compile_library([nvcc, "-shared"], objs, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.qr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.qr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = library().qr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
