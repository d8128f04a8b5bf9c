"""Oblivious-ensemble scoring: the CUDA kernel ``csrc/oblivious_score.cu``
and its plain version (``ops/oblivious.py``).

Replaces quickrank_tpu/ops/pallas_oblivious.py::score_oblivious_pallas: the
same plain float32 sum of ``wleaf[t, leafidx]`` over the trees.  Kernel and
plain version add the same float32 terms in tree order, so they are bitwise
equal on the card, at any depth.  The kernel reads the tables as one packed
record a tree (``ObliviousEnsemble.packed``, built once per table); past
depth 12 it reads the leaves from global memory instead of staging them.
"""

from __future__ import annotations

import ctypes

import torch

from quickrank_tpu_torch.ops import _cuda
from quickrank_tpu_torch.ops import oblivious as plain
from quickrank_tpu_torch.trees.oblivious import ObliviousEnsemble

#: kernel launches by this wrapper; a run that must show its path went
#: through the kernel sets it to 0 first and reads it after
LAUNCHES = 0

#: deepest tree the kernel takes: its leaf index is a 32-bit int (a tree of
#: depth 31 holds 2^31 leaves, 8 GB of float32)
MAX_DEPTH = 31

#: feature dtype -> the kernel's x_kind; uint8 holds bin ids (up to 256
#: bins; the bin-space entry takes no wider ids, and has no caller)
_KINDS = {torch.float32: 0, torch.uint8: 1}
_DTYPES = (*_KINDS, torch.int32)


def score_oblivious(features: torch.Tensor, ens: ObliviousEnsemble) -> torch.Tensor:
    """Weighted ensemble scores f32 [N].  float32 ``features`` are compared
    with ``ens.thr`` (value space); uint8 or int32 ones are bin ids and are
    compared with ``ens.thr_bin`` (bin space).  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises (bin ids wider than
    uint8 raise on the card)."""
    global LAUNCHES
    if features.dim() != 2 or features.dtype not in _DTYPES:
        raise ValueError(
            "score_oblivious: features must be float32, uint8 or int32 "
            f"[N, F], got {features.dtype} {tuple(features.shape)}"
        )
    if not features.is_contiguous():
        raise ValueError("score_oblivious: features must be contiguous")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"score_oblivious: unsupported device {features.device}")
    if ens.fid.device != features.device:
        raise ValueError(
            f"score_oblivious: tables on {ens.fid.device}, features on "
            f"{features.device}"
        )
    if features.shape[1] < ens.min_features:
        raise ValueError(
            f"score_oblivious: model splits on feature {ens.min_features - 1}, "
            f"features have {features.shape[1]} columns"
        )
    binned = features.dtype != torch.float32
    if features.device.type == "cpu":
        fn = plain.score_oblivious_binned if binned else plain.score_oblivious
        return fn(features, ens)
    if features.dtype not in _KINDS:
        raise ValueError(
            "score_oblivious: on the card bin ids are uint8, got "
            f"{features.dtype}"
        )
    if not 1 <= ens.depth <= MAX_DEPTH:
        raise ValueError(
            f"score_oblivious: depth {ens.depth}, the kernel takes 1..{MAX_DEPTH} "
            "(its leaf index is a 32-bit int)"
        )
    N, F = features.shape
    out = torch.empty(N, dtype=torch.float32, device=features.device)
    if N == 0:
        return out
    packed = ens.packed(binned)
    rc = _cuda.library().oblivious_score(
        features.data_ptr(), _KINDS[features.dtype], N, F, packed.data_ptr(),
        ens.capacity, ens.depth, out.data_ptr(),
        torch.cuda.current_stream(features.device).cuda_stream,
    )
    _cuda.check(rc, "oblivious_score")
    LAUNCHES += 1
    return out


def design(features: torch.Tensor, ens: ObliviousEnsemble) -> dict:
    """The design a launch on these inputs takes, as the C side plans it:
    ``depth_path`` ("template" for depths 1..12, else "runtime", leaves
    read from global memory), ``rows`` ("staged" in shared memory or
    "global"), ``trees_in_flight``, ``docs_per_thread``, ``docs_per_block``.
    Needs the kernel library (a card's build)."""
    buf = (ctypes.c_int * 5)()
    rc = _cuda.library().oblivious_score_design(
        _KINDS[features.dtype], features.shape[1], ens.capacity, ens.depth,
        ctypes.addressof(buf))
    _cuda.check(rc, "oblivious_score_design")
    return {"depth_path": "template" if buf[0] else "runtime",
            "rows": "staged" if buf[1] else "global", "trees_in_flight": buf[2],
            "docs_per_thread": buf[3], "docs_per_block": buf[4]}
