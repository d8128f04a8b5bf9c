"""Best-first regression-tree growth (counterpart of quickrank_tpu/trees/
grow.py, after RegressionTree::fit / split, src/learning/tree/rt.cc:49-140
and :208-355).

The deviance max-heap is an argmax over a per-node deviance vector; docs
carry a ``node_of_doc`` assignment; a split builds the left child's
histogram with one masked pass and takes the right child as parent minus
left (rtnode_histogram.cc:72-87).  The JAX package's ``while_loop`` is a
Python loop here: the heap bookkeeping lives on the host, the histograms,
split scans and doc routing on the tensors' device, and each split reads one
small tensor back (leaf, split found, feature, bin), one host sync a split.

Under a query-sharded group (``group``, ``parallel/mesh.py``) every rank
holds a shard of the docs; the node histograms and the leaf sums are
reduced over the ranks (``ops/histogram.py``), and every decision is taken
from the reduced values, so every rank grows the same tree.

Under a 2-D data x feature mesh (``feat``, a ``parallel.mesh.FeatureShard``;
JAX grow.py:220-282) ``binned`` is this rank's feature block behind the
stats column: the histograms cover the block (reduced over the data axis
only), the feature mask is drawn over the global padded width and sliced,
each rank's best candidate is gathered over the feature axis and the first
maximum wins (``FeatureShard.best``), and the owner of the split feature
computes the routing bits, which the others take from one all-reduce
(``FeatureShard.route``).  The split's value comes from the global
threshold table every rank holds, so it needs no collective.  The split
still costs one host read.

Reference semantics kept:
  * split priority = node deviance sum g^2 - (sum g)^2 / count (rt.cc:59-76);
  * gain = lsum^2/lcount + rsum^2/rcount over splits whose children both
    hold >= min_leaf_support docs (rt.cc:261-291);
  * loop until ``taken + |heap| >= nleaves``, ``taken`` counting
    unsplittable leaves (rt.cc:64-90);
  * per-split feature sampling when max_features != 1 (rt.cc:222-244);
  * doc routing ``x[f] <= threshold`` (rt.cc:330).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.ops import kernel_split
from quickrank_tpu_torch.ops.binning import bin_columns, gather_bins
from quickrank_tpu_torch.ops.histogram import (
    _prefix_sum_loops,
    _tree_sum_loops,
    doc_channels,
    group_histogram,
    histogram_scale,
    masked_histogram_t,
)
from quickrank_tpu_torch.ops.scoring import descend_tree_binned
from quickrank_tpu_torch.trees.structs import Tree
from quickrank_tpu_torch.utils.profiling import span

NEG_INF = float("-inf")
#: DBL_EPSILON guard of rt.cc:200
EPS = 2.220446049250313e-16

#: reads of a split decision back to the host, by the best-first grower (one
#: a split) and the best-k grower (one a round); a run that reports syncs
#: per tree sets it to 0 first and reads it after
HOST_SYNCS = 0


@dataclasses.dataclass(frozen=True)
class GrowConfig:
    nleaves: int = 10
    min_leaf_support: int = 1
    num_bins: int = 256
    max_features: float = 1.0  # 1.0 = all; <1 fraction; >1 count (rt.cc:222-233)
    newton: bool = False  # leaf = sum(g)/sum(w) instead of mean(g)
    #: depth cap (0 = unbounded, the reference's behavior)
    max_depth: int = 0
    #: bottom-up leaf-merge pruning (rt.cc:93-152), 0 = off: after growth,
    #: nodes pop deepest first (ties by deviance); a popped node's parent
    #: collapses into a leaf while n_nodes <= (2^(depth+1) - 1) * factor,
    #: and the pass stops at the first violation
    collapse_factor: float = 0.0
    #: number of real feature columns (0 = all of binned's columns).  The
    #: clustered grower (trees/grow_cluster.py) writes per-doc payload bytes
    #: over binned's last pad columns, and keeps its histograms and split
    #: scan to the real columns.
    num_real_features: int = 0
    #: real docs among the rows (0: every row is one), the doc count of the
    #: card's fixed-point histogram scale (``ops/histogram.py::
    #: scale_doc_count``); a query-sharded group counts its own
    num_docs: int = 0

    @property
    def max_nodes(self) -> int:
        return 2 * self.nleaves - 1

    def num_feature_samples(self, F: int) -> int:
        if self.max_features == 1.0:
            return F
        if self.max_features > 1.0:
            return min(int(self.max_features), F)
        return min(int(-(-self.max_features * F // 1)), F)


def _node_stats(hist_node: torch.Tensor):
    """(count, sum_g, sum_g2) of a node from its [F, B, 3] histogram (or of
    k nodes from [k, F, B, 3], each [k]): every feature sees each doc once,
    so feature 0 is read, summed over bins in XLA's order (the loops, on
    any device: the plain version of ``kernel_split.node_stats``)."""
    s = _tree_sum_loops(hist_node[..., 0, :, :].transpose(-1, -2))
    return s[..., 0], s[..., 1], s[..., 2]


def _deviance(c, s, s2):
    """Node deviance sum g^2 - (sum g)^2 / count (rtnode_histogram.cc's
    squares_sum_ bookkeeping feeding rt.cc:59)."""
    return torch.where(c > 0, s2 - s * s / torch.clamp(c, min=1.0), 0.0)


def set_deviance(deviance: torch.Tensor, hist: torch.Tensor, start: int, count: int) -> None:
    """``deviance[start:start + count]`` = the deviance of the nodes
    ``hist[start:start + count]`` of the grower's ``[nodes, F, B, 3]``
    table, in place: one launch of ``kernel_split.node_stats`` on the card,
    :func:`_deviance` of :func:`_node_stats` on the CPU."""
    if hist.device.type == "cuda":
        kernel_split.node_stats(hist, deviance, start, count)
    else:
        deviance[start:start + count] = _deviance(*_node_stats(hist[start:start + count]))


def _feature_sample_mask(generator: Optional[torch.Generator], F: int, k: int):
    """Random k-of-F feature mask (rt.cc:235-244), host bool [F]."""
    if k >= F:
        return torch.ones(F, dtype=torch.bool)
    r = torch.rand(F, generator=generator)
    kth = torch.sort(r).values[k - 1]
    return r <= kth


def _best_splits(hist_nodes: torch.Tensor, feat_masks: torch.Tensor, minls: int):
    """Scan the cumulative histograms ``[k, F, B, 3]`` of k nodes, each under
    its own feature mask ``[k, F]``, for the max-gain (feature, bin):
    ``(can_split, f_star, t_star, gain)``, each ``[k]`` (rt.cc:257-313).
    One launch of ``kernel_split.split_scan`` on the card,
    :func:`_best_splits_plain` on the CPU."""
    if hist_nodes.device.type == "cuda":
        return kernel_split.split_scan(hist_nodes, feat_masks, minls)
    return _best_splits_plain(hist_nodes, feat_masks, minls)


def _best_splits_plain(hist_nodes: torch.Tensor, feat_masks: torch.Tensor, minls: int):
    """:func:`_best_splits` in plain PyTorch on any device: the scan's loops
    (XLA's order), the gain, and ``torch.argmax``, which takes the first
    maximum, as ``jnp.argmax`` does."""
    k, _, B, _ = hist_nodes.shape
    cum = _prefix_sum_loops(hist_nodes, 2)
    lc = cum[..., 0]
    ls = cum[..., 1]
    rc = cum[:, :, -1:, 0] - lc
    rs = cum[:, :, -1:, 1] - ls
    valid = (lc >= minls) & (rc >= minls) & feat_masks[:, :, None]
    gain = ls * ls / torch.clamp(lc, min=1.0) + rs * rs / torch.clamp(rc, min=1.0)
    gain = torch.where(valid, gain, NEG_INF).reshape(k, -1)
    flat = torch.argmax(gain, dim=1)
    best = gain.gather(1, flat[:, None])[:, 0]
    return valid.reshape(k, -1).any(dim=1), flat // B, flat % B, best


def _best_split(hist_node: torch.Tensor, feat_mask: torch.Tensor, minls: int):
    """:func:`_best_splits` of one node ``[F, B, 3]``: 0-d tensors."""
    return tuple(x[0] for x in _best_splits(hist_node[None], feat_mask[None], minls))


def feature_masks(generator: Optional[torch.Generator], F: int, nfs: int, count: int,
                  feat=None) -> torch.Tensor:
    """``count`` per-split feature masks ``[count, F]`` drawn over ``F``
    columns (the global padded width under ``feat``, then sliced to this
    rank's block behind the stats column)."""
    masks = torch.stack([_feature_sample_mask(generator, F, nfs) for _ in range(count)])
    return masks if feat is None else feat.local_mask(masks)


def global_width(binned: torch.Tensor, feat=None) -> int:
    """The bin matrix's global padded width (this rank's block is narrower
    under ``feat``)."""
    return binned.shape[1] if feat is None else feat.global_width


def route_bits(binned: torch.Tensor, f: torch.Tensor, t: torch.Tensor, feat=None,
               right: bool = False) -> torch.Tensor:
    """Each doc's routing bit at its own split (feature ``f[n]``, bin
    ``t[n]``, global ids), or at one split for every doc (``f`` an int or
    0-d): ``bin <= t`` (left), or ``bin > t`` with ``right``.  Under
    ``feat`` the owner of each doc's feature computes its bit and the
    feature axis takes it from one all-reduce."""
    def read(cols):
        if isinstance(cols, int):
            return bin_columns(binned, cols)
        if cols.dim() == 0:  # one split, on the device: read nothing back
            return bin_columns(binned, cols.reshape(1))[:, 0]
        return gather_bins(binned, cols)

    if feat is None:
        x = read(f)
        return x > t if right else x <= t
    fl = feat.local_ids(torch.as_tensor(f))
    x = read(fl.clamp(min=0))
    mine = (x > t) if right else (x <= t)
    return feat.route(mine & (fl >= 0))


def fit_tree(binned: torch.Tensor, grad: torch.Tensor, doc_mask: torch.Tensor,
             thresholds: torch.Tensor, cfg: GrowConfig,
             generator: Optional[torch.Generator] = None, group=None, feat=None):
    """Grow one tree on binned docs.

    binned: [N, F] bin ids on the wire (uint8, uint16 or int32); grad: f32
    [N] pseudoresponses;
    doc_mask: bool [N] (False = padding or sampled-out doc); thresholds:
    f32 [F, B] split values per bin (read on the host).

    Returns (tree without leaf values, see :func:`leaf_outputs`;
    node_of_doc int32 [N]).  Every doc is routed, masked ones too, so the
    caller can update scores from ``leaf_value[node_of_doc]``.  With
    ``group`` the docs are this rank's shard and the histograms are
    reduced over the ranks; with ``feat`` the columns are this rank's
    feature block (the module docstring) and ``thresholds`` the global
    table."""
    global HOST_SYNCS
    N, F = binned.shape
    dev = binned.device
    B = cfg.num_bins
    max_nodes = cfg.max_nodes
    minls = cfg.min_leaf_support
    thr_host = thresholds.cpu().numpy()

    chan = doc_channels(grad, doc_mask)
    chan_t = torch.where(doc_mask[None, :], chan.T, 0.0).contiguous()
    scale = histogram_scale(chan_t, group, cfg.num_docs)

    def hist_of(mask):
        return masked_histogram_t(binned, chan_t, mask, B, group=group, scale=scale)

    hist = torch.zeros((max_nodes, F, B, 3), dtype=torch.float32, device=dev)
    deviance = torch.zeros(max_nodes, dtype=torch.float32, device=dev)
    with span("qr.grow.hist"):
        hist[0] = hist_of(doc_mask)
        set_deviance(deviance, hist, 0, 1)

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
    node_of_doc = torch.zeros(N, dtype=torch.int32, device=dev)
    F_global = global_width(binned, feat)
    nfs = cfg.num_feature_samples(F_global)

    while True:
        heap = active & ~frozen
        hs = int(heap.sum())
        if not (hs > 0 and taken + hs < cfg.nleaves):
            break
        with span("qr.grow.split"):
            heap_t = torch.from_numpy(heap).to(dev)
            # kept 1-element, so that indexing with it reads nothing back to
            # the host (a 0-d index tensor is read back, a sync of its own)
            leaf_t = torch.argmax(torch.where(heap_t, deviance, NEG_INF)).reshape(1)
            feat_mask = feature_masks(generator, F_global, nfs, 1, feat)[0].to(dev)
            h_leaf = hist[leaf_t][0]
            has_split, f_star, t_star, gain = _best_split(h_leaf, feat_mask, minls)
            if feat is not None:
                has_split, _, f_star, t_star = feat.best(has_split, gain, f_star, t_star)
            decision = torch.stack([
                leaf_t[0], has_split.long(), f_star, t_star, (deviance[leaf_t][0] > 0).long()])
        with span("qr.grow.readback"):  # the split's one host sync
            leaf, has_split, f_star, t_star, positive = decision.tolist()
        HOST_SYNCS += 1
        can_split = bool(has_split and positive)
        if cfg.max_depth:
            can_split = can_split and depth[leaf] < cfg.max_depth
        if not can_split:
            frozen[leaf] = True
            taken += 1
            continue
        a, b = n_nodes, n_nodes + 1
        with span("qr.grow.route"):
            goes_left = route_bits(binned, f_star, t_star, feat)
            in_leaf = node_of_doc == leaf
            node_of_doc = torch.where(
                in_leaf, torch.where(goes_left, a, b), node_of_doc
            ).to(torch.int32)
        with span("qr.grow.hist"):
            left_hist = hist_of(in_leaf & goes_left & doc_mask)
            hist[a] = left_hist
            hist[b] = h_leaf - left_hist
            set_deviance(deviance, hist, a, 2)
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
    return _finish_tree(binned, cfg, nodes, node_of_doc, deviance, depth,
                        parent, n_nodes, feat)


def _finish_tree(binned, cfg: GrowConfig, nodes: dict, node_of_doc, deviance,
                 depth, parent, n_nodes: int, feat=None):
    """The grown tree (host arrays of the five split fields) as a ``Tree`` on
    ``binned``'s device, after the optional leaf collapse; a collapse moves
    docs, so they are routed again through the pruned tree (over the whole
    feature axis: refused under ``feat``, as in JAX grow.py:315-318)."""
    max_nodes = cfg.max_nodes
    if cfg.collapse_factor > 0 and feat is not None:
        raise NotImplementedError(
            "collapse-leaves-factor under feature sharding not supported")
    nodes["is_leaf"] = nodes["feature"] < 0
    if cfg.collapse_factor > 0:
        with span("qr.grow.readback"):
            deviance = deviance.cpu().numpy()
        _collapse_leaves(nodes, deviance, depth, parent, n_nodes, cfg.collapse_factor)
    tree = Tree.from_numpy(dict(nodes, leaf_value=np.zeros(max_nodes, np.float32)),
                           device=binned.device)
    if cfg.collapse_factor > 0:
        node_of_doc = descend_tree_binned(binned, tree, cfg.nleaves).to(torch.int32)
    return tree, node_of_doc


def _collapse_leaves(nodes: dict, deviance: np.ndarray, depth: np.ndarray,
                     parent: np.ndarray, n_nodes: int, factor: float) -> None:
    """Bottom-up leaf-merge pruning (rt.cc:93-152 with tree_heap_nodes,
    :364-384), in place on the host arrays: pop nodes deepest first (ties by
    deviance over the largest deviance, the heap key ``depth + dev /
    max_dev``); a popped node's parent collapses into a leaf while
    ``n_nodes <= (2^(depth+1) - 1) * factor``; stop at the first violation.
    Collapsed children stay in the arrays, unreachable.  Arithmetic is
    float32, as in the JAX package."""
    f32 = np.float32
    max_nodes = deviance.shape[0]
    idx = np.arange(max_nodes)
    exists = (idx < n_nodes) & (idx > 0)  # the root is never popped
    dev32 = deviance.astype(f32)
    max_dev = max(f32(np.max(np.where(exists, dev32, f32(0.0)))), f32(1e-30))
    prio = np.where(exists, depth.astype(f32) + dev32 / max_dev, f32(NEG_INF))
    todo = exists.copy()
    n_eff = int(n_nodes)
    while todo.any():
        i = int(np.argmax(np.where(todo, prio, f32(NEG_INF))))  # first maximum
        todo[i] = False
        p = int(parent[i])
        if not (depth[i] > 0 and p >= 0 and not nodes["is_leaf"][p]):
            continue
        max_n = (1 << (int(depth[i]) + 1)) - 1
        if f32(n_eff) > f32(max_n) * f32(factor):
            break
        nodes["is_leaf"][p] = True
        nodes["feature"][p] = -1
        nodes["threshold"][p] = 0.0
        nodes["threshold_bin"][p] = -1
        n_eff -= 2


def segment_sums(index: torch.Tensor, values: torch.Tensor, num_slots: int,
                 group=None, num_docs: int = 0):
    """``sum_n values[n, c]`` into slot ``index[n]``: [num_slots, C], through
    the plain histogram (K5) with one column of slot ids; over every rank's
    docs under ``group`` (JAX grow.py:456-458).  ``num_docs`` counts the
    real docs among the rows (0: all), for the card's fixed-point scale."""
    return group_histogram(index.to(torch.int32)[:, None].contiguous(),
                           values.contiguous(), num_slots, group, num_docs)[0]


def leaf_outputs(tree: Tree, node_of_doc: torch.Tensor, grad: torch.Tensor,
                 doc_mask: torch.Tensor,
                 weights: Optional[torch.Tensor] = None, group=None,
                 num_docs: int = 0) -> Tree:
    """Fill leaf values: mean pseudoresponse (rt.cc:165-184), or the Newton
    step sum(lambda)/sum(w) when ``weights`` is given (rt.cc:186-207); the
    sums over every rank's docs under ``group``.  ``num_docs`` counts the
    real docs among the rows (0: all), for the card's fixed-point scale."""
    max_nodes = tree.max_nodes
    ok = doc_mask & (node_of_doc >= 0)
    g = torch.where(ok, grad, 0.0)
    den_src = ok.float() if weights is None else torch.where(ok, weights, 0.0)
    idx = torch.where(ok, node_of_doc, max_nodes)
    both = segment_sums(idx, torch.stack([g, den_src], dim=-1), max_nodes + 1, group,
                        num_docs)
    sums, den = both[:max_nodes, 0], both[:max_nodes, 1]
    value = torch.where(den >= EPS, sums / torch.clamp(den, min=EPS), 0.0)
    return dataclasses.replace(
        tree, leaf_value=torch.where(tree.is_leaf, value, 0.0)
    )
