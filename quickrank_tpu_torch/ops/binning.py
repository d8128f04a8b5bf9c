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
"""

from __future__ import annotations

import numpy as np

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
