"""Level-wise (depth-wise) tree growth (counterpart of quickrank_tpu/trees/
grow_level.py).

Every node of a level splits from one batched histogram pass over the
node-packed channels (``ops/histogram.py::node_histograms``), so a depth-D
tree costs D passes.  Each node still picks its own (feature, threshold),
with the gain, minimum-support and routing rules of the best-first grower.

Leaf values come from the level histograms, not from a separate
aggregation: a split node's left child sums are the cumulative histogram at
its chosen (feature, bin), the right child is total minus left, and a node
that stops keeps its own totals.  The Newton denominator rides as the third
channel in place of the squared gradient.  The JAX package picks each doc's
split column with a one-hot matmul on the TPU; the port gathers it.  There
is no host sync.  Under a query-sharded group each level's histograms are
reduced over the ranks (``ops/histogram.py``); the leaf values come from
them, so they need no other collective.

Under a 2-D mesh (``feat``; JAX grow_level.py:98-220) a level's candidates,
one a node, are gathered over the feature axis together with each
candidate's left and total sums (so every rank takes the owner's values),
and the owners' routing bits are combined in one all-reduce: two feature
collectives a level.  A node that stops keeps the totals of the stats
column, global column 0 (JAX takes shard 0's, :219-220).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from quickrank_tpu_torch.ops.histogram import histogram_scale, node_histograms_t, prefix_sum
from quickrank_tpu_torch.trees.grow import (
    EPS,
    NEG_INF,
    GrowConfig,
    feature_masks,
    global_width,
    route_bits,
)
from quickrank_tpu_torch.trees.structs import Tree
from quickrank_tpu_torch.utils.profiling import span


def fit_tree_levelwise(binned: torch.Tensor, grad: torch.Tensor,
                       doc_mask: torch.Tensor, thresholds: torch.Tensor,
                       depth: int, cfg: GrowConfig,
                       generator: Optional[torch.Generator] = None,
                       weights: Optional[torch.Tensor] = None, group=None, feat=None):
    """Grow a depth-``depth`` tree breadth-first in heap layout (node i has
    children 2i+1 and 2i+2; leaves at [2^depth - 1, 2^(depth+1) - 1)).

    Returns (tree with leaf values, node_of_doc int32 [N] over all docs).
    Leaf values are the mean pseudoresponse, or the Newton step
    sum(lambda)/sum(w) when ``weights`` is given.  ``thresholds`` is the
    global table (on ``binned``'s device), also under ``feat``."""
    N, F = binned.shape
    dev = binned.device
    B = cfg.num_bins
    minls = cfg.min_leaf_support
    max_nodes = 2 ** (depth + 1) - 1
    thresholds = thresholds.to(dev)

    newton = weights is not None
    m = doc_mask.to(grad.dtype)
    cols = [m, grad * m] + ([weights * m] if newton else [])
    chan_t = torch.stack(cols).contiguous()
    scale = histogram_scale(chan_t, group, cfg.num_docs)

    tree = Tree.empty(max_nodes, dev)
    leaf_num = torch.zeros(max_nodes, dtype=torch.float32, device=dev)
    leaf_den = torch.zeros(max_nodes, dtype=torch.float32, device=dev)
    pos = torch.zeros(N, dtype=torch.long, device=dev)
    F_global = global_width(binned, feat)
    nfs = cfg.num_feature_samples(F_global)

    for d in range(depth):
        with span("qr.grow.level"):
            n_nodes = 2 ** d
            base = n_nodes - 1
            hist = node_histograms_t(binned, chan_t, pos, n_nodes, B, group=group,
                                     scale=scale)  # [nodes, F, B, C]
            feat_mask = feature_masks(generator, F_global, nfs, 1, feat)[0].to(dev)

            cum = prefix_sum(hist, 2)
            lc = cum[..., 0]
            ls = cum[..., 1]
            tc = cum[:, :, -1:, 0]
            ts = cum[:, :, -1:, 1]
            rc = tc - lc
            rs = ts - ls
            gain = ls * ls / torch.clamp(lc, min=1.0) + rs * rs / torch.clamp(rc, min=1.0)
            valid = (lc >= minls) & (rc >= minls) & feat_mask[None, :, None]
            gain = torch.where(valid, gain, NEG_INF)
            flat = torch.argmax(gain.reshape(n_nodes, -1), dim=1)  # [nodes]
            f_star = flat // B
            t_star = flat % B

            def take(arr):  # [nodes, F, B] -> the winner's entry per node
                return arr.reshape(n_nodes, -1).gather(1, flat[:, None])[:, 0]

            def total(arr):  # [nodes, F] -> the winner feature's entry
                return arr.gather(1, f_star[:, None])[:, 0]

            best = take(gain)
            has_valid = valid.reshape(n_nodes, -1).any(dim=1)
            l_grad = take(ls)
            t_grad = total(ts[:, :, 0])
            if newton:
                l_den = take(cum[..., 2])
                t_den = total(cum[:, :, -1, 2])
            else:
                l_den, t_den = take(lc), total(tc[:, :, 0])
            # a node that stops here keeps its own totals (feature 0's column)
            stop_num = cum[:, 0, -1, 1]
            stop_den = cum[:, 0, -1, 2] if newton else cum[:, 0, -1, 0]

            if feat is not None:
                # the winners over the feature axis, with the owners' sums
                has_valid, best, f_star, t_star, l_grad, l_den, t_grad, t_den = feat.best(
                    has_valid, best, f_star, t_star, l_grad, l_den, t_grad, t_den)
            can = has_valid & (best > 0)
            thr_val = thresholds[f_star, t_star]
            # routing bit of every doc at its own node's split
            bit = route_bits(binned, f_star[pos], t_star[pos], feat, right=True).long()

            ids = base + torch.arange(n_nodes, device=dev)
            tree.feature[ids] = torch.where(can, f_star, -1).to(torch.int32)
            tree.threshold[ids] = torch.where(can, thr_val, 0.0)
            tree.threshold_bin[ids] = torch.where(can, t_star, -1).to(torch.int32)
            tree.left[ids] = torch.where(can, 2 * ids + 1, 0).to(torch.int32)
            tree.right[ids] = torch.where(can, 2 * ids + 2, 0).to(torch.int32)
            tree.is_leaf[ids] = ~can
            leaf_num[ids] = torch.where(can, 0.0, stop_num)
            leaf_den[ids] = torch.where(can, 0.0, stop_den)
            if d == depth - 1:
                leaf_num[2 * ids + 1] = torch.where(can, l_grad, 0.0)
                leaf_den[2 * ids + 1] = torch.where(can, l_den, 0.0)
                leaf_num[2 * ids + 2] = torch.where(can, t_grad - l_grad, 0.0)
                leaf_den[2 * ids + 2] = torch.where(can, t_den - l_den, 0.0)
            # docs of a node that stops keep routing left (bit 0), the
            # perfect-tree embedding's convention
            bit = torch.where(can[pos], bit, 0)
            pos = 2 * pos + bit

    value = torch.where(leaf_den >= EPS, leaf_num / torch.clamp(leaf_den, min=EPS), 0.0)
    tree = dataclasses.replace(tree, leaf_value=torch.where(tree.is_leaf, value, 0.0))

    # each doc's node: replay its path bits, stopping at the first leaf
    node = torch.zeros(N, dtype=torch.long, device=dev)
    left, right = tree.left.long(), tree.right.long()
    for d in range(depth):
        b = (pos >> (depth - 1 - d)) & 1
        nxt = torch.where(b == 1, right[node], left[node])
        node = torch.where(tree.is_leaf[node], node, nxt)
    return tree, node.to(torch.int32)
