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
up to 256 bins, uint16 up to 65,536, int32 beyond.  On the card
:func:`device_bin_wire` writes it from the float32 rows with
``csrc/bin_apply.cu``, a launch a piece of rows, the same ids bit for bit.  torch's uint16 has
almost no kernels (no compare, gather or index_copy), so every torch reader
of the matrix goes through :func:`bin_columns`, :func:`gather_bins` or
:func:`bin_rows`, which read uint16 ids as their int16 bits and widen only
the column or block they return to int32, never the whole matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.ops import _cuda

FLT_MAX = np.float32(np.finfo(np.float32).max)

#: calls of :func:`device_bin_wire` on a CUDA device: one a
#: ``learning/mart.py::TrainData.build`` binned on the card; a run that must
#: show its path went through the kernel sets it to 0 first and reads it after
DEVICE_BUILDS = 0

#: the most float32 rows :func:`device_bin_wire` holds on the card at once,
#: in bytes: a train fold of MSLR-WEB30K (1.39 GB) goes up in 6 pieces
UPLOAD_BYTES = 1 << 28


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


def host_bin_ids(features: np.ndarray, thresholds: np.ndarray,
                 col_map: np.ndarray) -> np.ndarray:
    """int32 bin ids ``[N, W]`` of host features ``[N, F]``: column ``w``
    holds :func:`apply_bins`'s ids of column ``col_map[w]``, or 0 where
    ``col_map[w]`` is -1 (a pad column).  The host binner's path; with
    :func:`bin_wire`, :func:`device_bin_wire`'s plain version."""
    live = np.flatnonzero(col_map >= 0)
    cols = col_map[live]
    if not np.array_equal(cols, np.arange(features.shape[1])):
        features, thresholds = np.ascontiguousarray(features[:, cols]), thresholds[cols]
    ids = np.zeros((features.shape[0], len(col_map)), np.int32)
    ids[:, live] = apply_bins(features, thresholds)
    return ids


def device_bin_wire(rows: np.ndarray, thresholds: np.ndarray, col_map: np.ndarray,
                    n_loc: int, device) -> torch.Tensor:
    """The bin wire ``[n_loc, W]`` of a block's float32 rows ``[n, F]`` on
    ``device``: column ``w`` holds the ids of rows' column ``col_map[w]``
    under ``thresholds[col_map[w]]`` (``thresholds`` ``[F, B]``), or 0 where
    ``col_map[w]`` is -1 (a pad column); rows ``n..n_loc-1`` hold the ids of
    0.0, as the zero pad rows of the host layout bin: :func:`bin_wire` of
    :func:`host_bin_ids` of those rows, bit for bit.  On the CPU the host
    binner runs on the zero-padded rows.  On a CUDA device the tables and
    map are uploaded once and the rows in pieces of at most
    :data:`UPLOAD_BYTES`, each binned by a launch of :func:`bin_apply` into
    its rows of the wire (the last piece also writes the pad rows), so the
    card holds one piece of float32 rows at a time."""
    global DEVICE_BUILDS
    device = torch.device(device)
    col_map = np.asarray(col_map, dtype=np.int64)
    n, F = rows.shape
    W, B = len(col_map), thresholds.shape[1]
    if thresholds.shape[0] != F:
        raise ValueError(f"thresholds for {thresholds.shape[0]} features, rows have {F}")
    if W and (col_map.min() < -1 or col_map.max() >= F):
        raise ValueError(f"column map out of range [-1, {F}): "
                         f"{int(col_map.min())}..{int(col_map.max())}")
    if n > n_loc:
        raise ValueError(f"{n} rows do not fit a block of {n_loc}")
    if device.type == "cpu":
        feats = np.zeros((n_loc, F), np.float32)
        feats[:n] = rows
        return torch.from_numpy(bin_wire(host_bin_ids(feats, thresholds, col_map), B))
    dtype = torch.uint8 if B <= 256 else torch.uint16 if B <= 65536 else torch.int32
    up = lambda a, t: torch.from_numpy(np.ascontiguousarray(a, t)).to(device)  # noqa: E731
    th, cmap = up(thresholds, np.float32), up(col_map, np.int32)
    out = torch.empty((n_loc, W), dtype=dtype, device=device)
    step = max(1, UPLOAD_BYTES // max(1, 4 * F))
    for a in range(0, max(n, 1), step):
        b = min(a + step, n)
        bin_apply(up(rows[a:b], np.float32), th, cmap, out[a:b if b < n else n_loc])
    DEVICE_BUILDS += 1
    return out


def bin_apply(x: torch.Tensor, th: torch.Tensor, cmap: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/bin_apply.cu`` on card tensors: ``out`` ``[m,
    W]`` (u8, u16 or int32; rows contiguous) gets the ids of ``x``'s float32
    rows ``[n, F]``, ``n <= m``, under ``th`` ``[F, B]`` by the int32 map
    ``cmap`` ``[W]``, and rows ``n..m-1`` the ids of 0.0."""
    (n, F), (m, W) = x.shape, out.shape
    _cuda.check(_cuda.library().bin_apply_wire(
        x.data_ptr(), n, F, th.data_ptr(), th.shape[1], cmap.data_ptr(), W, m,
        out.element_size(), out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream),
        "bin_apply_wire")
    return out


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
