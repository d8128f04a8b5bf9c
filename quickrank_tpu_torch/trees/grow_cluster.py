"""Best-first growth over a node-clustered work buffer (counterpart of
quickrank_tpu/trees/grow_cluster.py).

The same grower as ``trees/grow.py::fit_tree`` (split priority, gains, minls
veto, routing, leaf assignment), with the docs kept so that every tree
node's docs are a contiguous run of whole 1024-row tiles of a work buffer.
A split's histogram pass then runs over the splitting node's run only, and
after the split the run is repartitioned into its two children by the
row-partition kernel (``ops/kernel_partition.py``).

The work buffer is ``[N_work, W] u8``: the binned features in columns
``[0, F)`` and per-doc payload bytes in the last 8 pad columns: the gradient
as its 4 little-endian float32 bytes, a count/mask byte, and the node id as
``pos + 1`` (0 = dead row).  The payload travels with its row, so a split's
channel values are rebuilt from the buffer itself (a ``view`` of the four
gradient bytes).  Layout and directive arithmetic are the JAX package's, so
the buffer after every split is its buffer byte for byte; its 128-lane
column padding and its one-hot column reads are TPU machinery and are not
carried over.

The heap bookkeeping lives on the host, the run table and the directives on
the tensors' device; each split reads one small tensor back (leaf, split
found, feature, bin, the leaf's run), one host sync a split as in
``fit_tree``.  The per-doc leaf assignment is recomputed over the original
doc order by a bin-space descent, so callers see ``fit_tree``'s
``(tree, node_of_doc)`` contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.ops.histogram import histogram_scale, masked_histogram_t
from quickrank_tpu_torch.ops.kernel_partition import (
    MODE_COPY,
    MODE_DEAD,
    MODE_MOVE,
    TILE,
    partition_rows,
)
from quickrank_tpu_torch.ops.scoring import descend_tree_binned
from quickrank_tpu_torch.trees import grow
from quickrank_tpu_torch.trees.grow import (
    NEG_INF,
    GrowConfig,
    _best_split,
    _feature_sample_mask,
    _finish_tree,
    set_deviance,
)
from quickrank_tpu_torch.utils.profiling import span

#: payload byte columns, relative to the end of the work buffer
_GRAD = -8   # ..-4: the gradient's float32 bytes, little-endian
_CNT = -4    # count/mask byte (doc mask & sample mask)
_POS = -3    # node id + 1 (0 = dead row)


def payload_columns_required() -> int:
    """Pad columns the clustered layout needs past the real features."""
    return 8


def work_rows(num_docs: int, max_nodes: int) -> int:
    """Rows of the work buffer: the docs plus slack the child runs grow into
    (per-tile 8-row alignment gaps are made anew by every split, never
    accumulated, and every run ends in one guard tile; ``2 * max_nodes + 32``
    tiles cover both with margin)."""
    return num_docs + TILE * (2 * max_nodes + 32)


def build_work_buffer(binned: torch.Tensor, grad: torch.Tensor,
                      sample_mask: torch.Tensor, n_work: int) -> torch.Tensor:
    """The per-tree work buffer u8 ``[n_work, W]``: ``binned`` with the
    payload bytes written over its last 8 columns (every doc in node 0),
    then dead rows up to ``n_work``."""
    N, W = binned.shape
    g = torch.where(sample_mask, grad, 0.0).float().contiguous()
    work = torch.zeros((n_work, W), dtype=torch.uint8, device=binned.device)
    work[:N] = binned
    work[:N, W + _GRAD:W + _CNT] = g.view(torch.uint8).view(N, 4)
    work[:N, W + _CNT] = sample_mask.to(torch.uint8)
    work[:N, W + _POS] = 1
    work[:N, W + _POS + 1:] = 0
    return work


def _channels(rows: torch.Tensor):
    """(chan_t float32 [3, n] = count, grad, grad^2; pos int32 [n]; live bool
    [n]) of buffer rows, from their payload bytes."""
    W = rows.shape[1]
    g = rows[:, W + _GRAD:W + _CNT].contiguous().view(torch.float32)[:, 0]
    posb = rows[:, W + _POS]
    chan_t = torch.stack([rows[:, W + _CNT].float(), g, g * g])
    return chan_t, posb.to(torch.int32) - 1, posb > 0


def _align8(x):
    return (x + 7) // 8 * 8


def fit_tree_clustered(binned: torch.Tensor, grad: torch.Tensor,
                       doc_mask: torch.Tensor, thresholds: torch.Tensor,
                       cfg: GrowConfig,
                       generator: Optional[torch.Generator] = None, group=None):
    """Drop-in for ``trees/grow.py::fit_tree`` on the clustered work buffer.

    Requires u8 bins, ``N % 1024 == 0``, ``cfg.num_real_features`` set with at
    least 8 pad columns past the real features, and no collapse factor.
    Feature sampling draws as ``fit_tree`` does (over all ``W`` columns), and
    the card's histograms take one fixed-point scale a tree, the root's, as
    ``fit_tree`` takes it, so the same generator gives the same tree.  With
    ``group`` the docs are this rank's shard: every split's histogram is
    reduced over the ranks (JAX grow_cluster.py:174-183), so every rank takes
    the same split, and each repartitions its own work buffer."""
    N, W = binned.shape
    dev = binned.device
    B = cfg.num_bins
    max_nodes = cfg.max_nodes
    minls = cfg.min_leaf_support
    F_real = cfg.num_real_features or W
    if binned.dtype != torch.uint8 or B > 256:
        raise ValueError("fit_tree_clustered: bins must be uint8 (at most 256 bins), "
                         f"got {binned.dtype} and {B} bins")
    if N % TILE:
        raise ValueError(f"fit_tree_clustered: {N} docs are not a multiple of {TILE}")
    if W - F_real < payload_columns_required():
        raise ValueError(
            f"fit_tree_clustered: {W - F_real} pad columns past the {F_real} real "
            f"features, the payload needs {payload_columns_required()}")
    if cfg.collapse_factor > 0:
        raise ValueError("fit_tree_clustered: a collapse factor is not supported")
    thr_host = thresholds.cpu().numpy()

    n_work = work_rows(N, max_nodes)
    T_w = n_work // TILE
    # the two buffers of the tree: every split repacks one into the other
    work = build_work_buffer(binned, grad, doc_mask, n_work)
    spare = torch.empty_like(work)
    pos_col = W + _POS
    tiles = torch.arange(T_w, device=dev)

    rows = work[:N]
    chan_t, pos, live = _channels(rows)
    scale = histogram_scale(chan_t, group, cfg.num_docs)

    def hist_of(rows, chan_t, mask):
        return masked_histogram_t(rows, chan_t, mask, B, f_used=F_real, group=group,
                                  scale=scale)

    hist = torch.zeros((max_nodes, F_real, B, 3), dtype=torch.float32, device=dev)
    hist[0] = hist_of(rows, chan_t, (pos == 0) & live)
    deviance = torch.zeros(max_nodes, dtype=torch.float32, device=dev)
    set_deviance(deviance, hist, 0, 1)
    # first tile and tile count (0 = none) of each node's run
    run_tile = torch.zeros(max_nodes, dtype=torch.int64, device=dev)
    run_ntiles = torch.zeros(max_nodes, dtype=torch.int64, device=dev)
    run_ntiles[0] = N // TILE

    feature = np.full(max_nodes, -1, np.int32)
    threshold = np.zeros(max_nodes, np.float32)
    threshold_bin = np.full(max_nodes, -1, np.int32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    active = np.zeros(max_nodes, bool)
    active[0] = True
    frozen = np.zeros(max_nodes, bool)
    depth = np.zeros(max_nodes, np.int64)
    parent = np.full(max_nodes, -1, np.int64)
    n_nodes, taken = 1, 0
    nfs = cfg.num_feature_samples(W)

    def full(v):
        return torch.full((T_w,), v, dtype=torch.int32, device=dev)

    while True:
        heap = active & ~frozen
        hs = int(heap.sum())
        if not (hs > 0 and taken + hs < cfg.nleaves):
            break
        heap_t = torch.from_numpy(heap).to(dev)
        # kept 1-element, so that indexing with it reads nothing back
        leaf_t = torch.argmax(torch.where(heap_t, deviance, NEG_INF)).reshape(1)
        feat_mask = _feature_sample_mask(generator, W, nfs)[:F_real].to(dev)
        h_leaf = hist[leaf_t][0]
        has_split, f_star, t_star, _ = _best_split(h_leaf, feat_mask, minls)
        decision = torch.stack([
            leaf_t[0], has_split.long(), f_star, t_star, (deviance[leaf_t][0] > 0).long(),
            run_tile[leaf_t][0], run_ntiles[leaf_t][0]])
        # the split's one host sync; the leaf's run rides it
        with span("qr.grow.readback"):
            leaf, has_split, f_star, t_star, positive, rs, rn = decision.tolist()
        grow.HOST_SYNCS += 1
        can_split = bool(has_split and positive)
        if cfg.max_depth:
            can_split = can_split and depth[leaf] < cfg.max_depth
        if not can_split:
            frozen[leaf] = True
            taken += 1
            continue
        a, b = n_nodes, n_nodes + 1
        # the leaf's run: its docs, alignment gaps and guard tile (dead rows)
        r0, r1 = rs * TILE, (rs + rn) * TILE
        rows = work[r0:r1]
        chan_t, pos, live = _channels(rows)
        goes_left = rows[:, f_star] <= t_star
        in_leaf = (pos == leaf) & live
        to_left, to_right = in_leaf & goes_left, in_leaf & ~goes_left
        left_hist = hist_of(rows, chan_t, to_left)
        hist[a] = left_hist
        hist[b] = h_leaf - left_hist
        set_deviance(deviance, hist, a, 2)

        # partition directives: per-tile child counts padded to 8 rows, child
        # runs of whole tiles plus one guard tile, the children in the leaf's
        # place in run order, every run repacked densely in that order
        zc = torch.zeros(T_w, dtype=torch.int64, device=dev)
        oc = torch.zeros(T_w, dtype=torch.int64, device=dev)
        zc[rs:rs + rn] = _align8(to_left.view(rn, TILE).sum(dim=1))
        oc[rs:rs + rn] = _align8(to_right.view(rn, TILE).sum(dim=1))
        ltiles = (zc.sum() + TILE - 1) // TILE + 1
        rtiles = (oc.sum() + TILE - 1) // TILE + 1
        new_ntiles = run_ntiles.clone()
        new_ntiles[leaf] = 0
        new_ntiles[a] = ltiles
        new_ntiles[b] = rtiles
        sort_key = 2 * run_tile
        sort_key[a] = 2 * rs
        sort_key[b] = 2 * rs + 1
        order = torch.argsort(torch.where(new_ntiles > 0, sort_key, 2 ** 30),
                              stable=True)
        sizes_sorted = new_ntiles[order]
        new_start = torch.zeros_like(run_tile)
        new_start[order] = sizes_sorted.cumsum(0) - sizes_sorted
        # old owner of each tile (runs are disjoint; dead tiles have none)
        cover = ((tiles[:, None] >= run_tile[None, :])
                 & (tiles[:, None] < (run_tile + run_ntiles)[None, :])
                 & (run_ntiles[None, :] > 0))
        run_of_tile = cover.to(torch.int8).argmax(dim=1)
        in_leaf_tile = (tiles >= rs) & (tiles < rs + rn)
        mode = torch.where(
            in_leaf_tile, MODE_MOVE,
            torch.where(cover.any(dim=1), MODE_COPY, MODE_DEAD)).to(torch.int32)
        dsta = torch.where(
            in_leaf_tile,
            new_start[a] * TILE + (zc.cumsum(0) - zc),
            (new_start[run_of_tile] + (tiles - run_tile[run_of_tile])) * TILE,
        ).to(torch.int32)
        dstb = (new_start[b] * TILE + (oc.cumsum(0) - oc)).to(torch.int32)
        bit = None
        if dev.type == "cpu":  # the plain version's routing bits
            bit = torch.full((n_work,), 2, dtype=torch.int32)
            bit[r0:r1] = torch.where(in_leaf, torch.where(goes_left, 0, 1), 2)
        repacked = partition_rows(
            work, bit, mode, dsta, dstb, full(a + 1), full(b + 1), pos_col,
            fstar=full(f_star), tstar=full(t_star), out=spare)
        work, spare = repacked, work
        run_tile, run_ntiles = new_start, new_ntiles

        feature[leaf] = f_star
        threshold[leaf] = thr_host[f_star, t_star]
        threshold_bin[leaf] = t_star
        left[leaf], right[leaf] = a, b
        active[leaf] = False
        active[a] = active[b] = True
        depth[a] = depth[b] = depth[leaf] + 1
        parent[a] = parent[b] = leaf
        n_nodes += 2

    nodes = dict(feature=feature, threshold=threshold, threshold_bin=threshold_bin,
                 left=left, right=right)
    tree, _ = _finish_tree(binned, cfg, nodes, None, deviance, depth, parent, n_nodes)
    node_of_doc = descend_tree_binned(binned, tree, int(depth.max())).to(torch.int32)
    return tree, node_of_doc
