"""Feature binning: threshold tables and doc -> bin quantization (counterpart
of quickrank_tpu/ops/binning.py; thresholds and bin ids are bitwise the JAX
package's, from the same native binner or the same numpy arithmetic).

Threshold semantics follow the reference (mart.cc:127-170):
  * the sorted unique values of a feature, when there are at most
    ``nthresholds`` of them (or ``nthresholds == 0``);
  * else ``nthresholds`` equi-width points from fmin, computed in double;
  * then a final FLT_MAX sentinel, the "everything" bin.

A doc with value ``v`` lands in bin ``t`` iff ``thresholds[t-1] < v <=
thresholds[t]``, so a split at ``t`` sends bins ``<= t`` left, exactly the
value routing ``v <= threshold`` (rt.cc:330).

The bin matrix travels as the JAX package's wire (:func:`bin_wire`): uint8
up to 256 bins, uint16 up to 65,536, int32 beyond.  torch's uint16 has
almost no kernels (no compare, gather or index_copy), so every torch reader
of the matrix goes through :func:`bin_columns`, :func:`gather_bins` or
:func:`bin_rows`, which read uint16 ids as their int16 bits and widen only
the column or block they return to int32, never the whole matrix.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MAX = np.float32(np.finfo(np.float32).max)


def build_thresholds(features: np.ndarray, nthresholds: int = 0):
    """Per-feature threshold tables ``(thresholds [F, B], counts [F])``, B
    the largest count, FLT_MAX padded.

    The multithreaded native binner serves ``nthresholds > 0``; the numpy
    loop is its fallback and the ``nthresholds == 0`` path."""
    N, F = features.shape
    if not np.isfinite(features).all():
        # the grid is built from a finite-clamped copy; apply_bins still
        # quantizes the raw values (non-finite -> top bin)
        features = np.nan_to_num(
            features, nan=FLT_MAX, posinf=FLT_MAX, neginf=-FLT_MAX,
        )
    if nthresholds > 0:
        try:
            from quickrank_tpu_torch.ops._binning_native import (
                build_thresholds as _native_build,
            )

            out, counts = _native_build(features, nthresholds)
        except Exception:  # noqa: BLE001 - any native failure: numpy path
            pass
        else:
            return np.ascontiguousarray(out[:, : int(counts.max())]), counts
    per_feature = []
    counts = np.zeros(F, dtype=np.int64)
    for f in range(F):
        uniq = np.unique(features[:, f].astype(np.float32))
        if nthresholds == 0 or len(uniq) <= nthresholds:
            th = np.concatenate([uniq, [FLT_MAX]]).astype(np.float32)
        else:
            # double grid: fmax - fmin can exceed FLT_MAX for full-range
            # features, which a float32 step would overflow
            fmin, fmax = np.float64(uniq[0]), np.float64(uniq[-1])
            step = np.float64(abs(fmax - fmin)) / np.float64(nthresholds)
            th = (fmin + step * np.arange(nthresholds, dtype=np.float64)).astype(
                np.float32
            )
            th = np.concatenate([th, [FLT_MAX]]).astype(np.float32)
        per_feature.append(th)
        counts[f] = len(th)
    out = np.full((F, int(counts.max())), FLT_MAX, dtype=np.float32)
    for f in range(F):
        out[f, : counts[f]] = per_feature[f]
    return out, counts.astype(np.int32)


def apply_bins(features: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Bin ids int32 ``[N, F]``: the smallest t with value <= thresholds[t],
    clamped to [0, B-1] (non-finite values land in the top bin, so they
    route right at every real split, as in value space)."""
    try:
        from quickrank_tpu_torch.ops._binning_native import apply_bins as _native

        return _native(features, thresholds)
    except Exception:  # noqa: BLE001 - any native failure: numpy path
        pass
    N, F = features.shape
    B = thresholds.shape[1]
    out = np.empty((N, F), dtype=np.int32)
    for f in range(F):
        out[:, f] = np.searchsorted(
            thresholds[f], features[:, f].astype(np.float32), side="left"
        )
    np.minimum(out, B - 1, out=out)
    return out


def bin_wire(binned: np.ndarray, num_bins: int) -> np.ndarray:
    """Bin ids ``[N, F]`` in the training wire's dtype, the JAX package's
    (quickrank_tpu/learning/mart.py): uint8 up to 256 bins, uint16 up to
    65,536, int32 beyond."""
    if num_bins <= 256:
        return binned.astype(np.uint8)
    if num_bins <= 65536:
        return binned.astype(np.uint16)
    return binned.astype(np.int32)


def _raw(binned: torch.Tensor) -> torch.Tensor:
    """``binned`` in a dtype torch has kernels for: uint16 ids as their
    int16 bits (torch's uint16 has no compare, gather or index kernels)."""
    return binned.view(torch.int16) if binned.dtype == torch.uint16 else binned


def widen(ids: torch.Tensor) -> torch.Tensor:
    """Bin ids of any wire dtype (or their int16 bits) as int32."""
    if ids.dtype in (torch.uint16, torch.int16):
        return _raw(ids).to(torch.int32) & 0xFFFF
    return ids.to(torch.int32)


def bin_rows(binned: torch.Tensor, rows) -> torch.Tensor:
    """int32 ids of ``binned[rows]`` (an index, a slice or a mask), the rest
    of the wire untouched."""
    return widen(_raw(binned)[rows])


def bin_columns(binned: torch.Tensor, cols) -> torch.Tensor:
    """int32 ids of ``binned[:, cols]``: ``[N]`` for an int, ``[N, len(cols)]``
    for an index tensor."""
    return widen(_raw(binned)[:, cols])


def gather_bins(binned: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int32 ids ``[N]``: row n's bin in column ``cols[n]``."""
    return widen(_raw(binned).gather(1, cols.long()[:, None])[:, 0])


def scorer_rows(binned: torch.Tensor) -> torch.Tensor:
    """The bin matrix as the QuickScorer scorers take it: the u8 or u16
    wire itself; int32 ids (more than 65,536 bins) as float32, exact."""
    return binned if binned.dtype in (torch.uint8, torch.uint16) else binned.float()
