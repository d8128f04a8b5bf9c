"""QuickScorer scoring: the CUDA kernel ``csrc/qs_score.cu`` and its plain
version (``trees/qs.py::score_qs``).

Replaces quickrank_tpu/ops/pallas_qs.py::score_qs_pallas.  Unlike the Pallas
kernel, which sums trees in plain float32 block order, the CUDA kernel keeps
the per-tree Kahan chain of the plain scorer and is bitwise equal to it.
The kernel stages a block's document rows and a tile of the packed tables
(``QSEnsemble.packed``) in shared memory; a tree too wide for one block's
shared memory streams through it in tiles of its own records.  The plain
scorer reads the unpacked tables.

The kernel's partial entry (:func:`partial_scores_qs`) writes each tree's
unweighted exit-leaf value, ``[N, trees]``, in place of the sum; its plain
version is ``trees/qs.py::partial_scores_qs``.

Bin-space tables score the training wire itself: uint8 ids up to 256 bins
(``qs_score_u8``), uint16 up to 65,536 (``qs_score_u16``).
"""

from __future__ import annotations

from typing import Optional

import torch

from quickrank_tpu_torch.ops import _cuda
from quickrank_tpu_torch.trees.qs import QSEnsemble
from quickrank_tpu_torch.trees.qs import partial_scores_qs as plain_partial_scores_qs
from quickrank_tpu_torch.trees.qs import score_qs as plain_score_qs

#: kernel launches by :func:`score_qs`; a run that must show its path went
#: through the kernel sets it to 0 first and reads it after
LAUNCHES = 0
#: launches of the partial entry by :func:`partial_scores_qs`, the same way
PARTIAL_LAUNCHES = 0

#: cells of one block of per-tree columns in :func:`partial_score_blocks`
#: (1 GiB of float32)
PARTIAL_BLOCK_ELEMS = 1 << 28
#: feature dtypes the kernel takes: float32 values, or bin ids of the wire
FEATURE_DTYPES = (torch.float32, torch.uint8, torch.uint16)
#: entry-name suffix by feature dtype
_SUFFIX = {torch.float32: "", torch.uint8: "_u8", torch.uint16: "_u16"}


def check_inputs(features: torch.Tensor, tables, name: str,
                 dtypes=(torch.float32,)) -> None:
    """Shared checks of the scoring wrappers: contiguous [N, F] features of
    one of ``dtypes`` on the tables' device, wide enough for every split."""
    if features.dtype not in dtypes or features.dim() != 2:
        raise ValueError(
            f"{name}: features must be {' or '.join(str(d) for d in dtypes)} "
            f"[N, F], got {features.dtype} {tuple(features.shape)}"
        )
    if not features.is_contiguous():
        raise ValueError(f"{name}: features must be contiguous")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {features.device}")
    if tables.fid.device != features.device:
        raise ValueError(
            f"{name}: tables on {tables.fid.device}, features on "
            f"{features.device}"
        )
    if features.shape[1] < tables.min_features:
        raise ValueError(
            f"{name}: model splits on feature {tables.min_features - 1}, "
            f"features have {features.shape[1]} columns"
        )


def score_qs(features: torch.Tensor, qs: QSEnsemble) -> torch.Tensor:
    """Weighted ensemble scores f32 [N].  ``features`` are float32 values,
    or uint8 or uint16 bin ids for bin-space tables
    (``ensemble_to_qs(space="bin")``).  A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel or raises."""
    global LAUNCHES
    check_inputs(features, qs, "score_qs", FEATURE_DTYPES)
    if features.device.type == "cpu":
        return plain_score_qs(features, qs)
    N, F = features.shape
    T, I = qs.fid.shape
    packed = qs.packed()
    out = torch.empty(N, dtype=torch.float32, device=features.device)
    if N == 0:
        return out
    lib = _cuda.library()
    rc = getattr(lib, "qs_score" + _SUFFIX[features.dtype])(
        features.data_ptr(), N, F, packed.data_ptr(), T, I, qs.num_leaves,
        int(qs.excl.shape[2]), int(packed.shape[1]), out.data_ptr(),
        torch.cuda.current_stream(features.device).cuda_stream,
    )
    _cuda.check(rc, "qs_score")
    LAUNCHES += 1
    return out


def partial_scores_qs(features: torch.Tensor, qs: QSEnsemble, t0: int = 0,
                      t1: Optional[int] = None) -> torch.Tensor:
    """Per-tree unweighted scores f32 ``[N, t1 - t0]`` of the slots ``[t0,
    t1)`` (default all): column ``t`` is the value of the leaf each doc exits
    at in slot ``t0 + t``.  ``features`` as for :func:`score_qs`.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel's
    partial entry or raises.  The output is written whole: take a large
    ensemble a range of slots at a time."""
    global PARTIAL_LAUNCHES
    check_inputs(features, qs, "partial_scores_qs", FEATURE_DTYPES)
    T = qs.fid.shape[0]
    t1 = T if t1 is None else t1
    if not 0 <= t0 <= t1 <= T:
        raise ValueError(f"partial_scores_qs: slots [{t0}, {t1}) outside [0, {T})")
    if features.device.type == "cpu":
        return plain_partial_scores_qs(features, qs, t0, t1)
    N, F = features.shape
    I = qs.fid.shape[1]
    packed = qs.packed()
    out = torch.empty((N, t1 - t0), dtype=torch.float32, device=features.device)
    if N == 0 or t1 == t0:
        return out
    lib = _cuda.library()
    rc = getattr(lib, "qs_partial" + _SUFFIX[features.dtype])(
        features.data_ptr(), N, F, packed[t0].data_ptr(), t1 - t0, I, qs.num_leaves,
        int(qs.excl.shape[2]), int(packed.shape[1]), out.data_ptr(),
        torch.cuda.current_stream(features.device).cuda_stream,
    )
    _cuda.check(rc, "qs_partial")
    PARTIAL_LAUNCHES += 1
    return out


def partial_score_blocks(features: torch.Tensor, qs: QSEnsemble):
    """Yields ``(t0, t1, cols)`` over all slots of ``qs``: the per-tree
    columns of :func:`partial_scores_qs` a block of slots at a time, each
    block at most :data:`PARTIAL_BLOCK_ELEMS` cells (2.5M docs by 1000 trees
    would be 10 GB at once)."""
    T = qs.fid.shape[0]
    step = max(1, PARTIAL_BLOCK_ELEMS // max(1, features.shape[0]))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        yield t0, t1, partial_scores_qs(features, qs, t0, t1)
