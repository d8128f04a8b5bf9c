"""Best-k regression-tree growth: best-first priority, several splits per
histogram pass (counterpart of quickrank_tpu/trees/grow_bestk.py).

The reference grows one split per histogram pass: pop the max-deviance leaf,
split it, push its children (src/learning/tree/rt.cc:49-90).  The best-first
grower of ``trees/grow.py`` does the same on the card and reads each split
back to the host, so a tree of L leaves costs L-1 launches of the histogram
kernel and L-1 host syncs, with the card idle in between.  This grower pops
the ``k`` highest-deviance heap leaves per round, scans their splits in one
batch, reads them back once, and builds all their left-child histograms in
one packed launch of the node-histogram kernel (right child = parent minus
left, rtnode_histogram.cc:72-87): one launch and one host sync a round.

Every split still maximizes the same gain over the same histogram under the
same minimum-support rule, and the leaf budget is rt.cc:64-90's: a popped
leaf that cannot split freezes and counts as taken; at most ``nleaves -
(taken + |heap|)`` splits apply per round, in deviance-rank order, so the
final leaf count is exact best-first's.  Where k > 1 differs: children born
in a round cannot be popped in that round, so when a child's deviance would
have outranked the round's rank 2..k leaves, exact best-first would have
split the child first.  Only which leaves use the budget changes, never how
a split is chosen.  ``k = 1`` is ``fit_tree`` bit for bit.

Ties in deviance go to the lower node id (a stable descending sort), as
``jax.lax.top_k`` orders them.  Feature sampling draws one mask per popped
rank from the host generator, ``fit_tree``'s schedule at k = 1.  Under a
query-sharded group a round's histograms are reduced over the ranks
(``ops/histogram.py``), as in ``fit_tree``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.ops.histogram import doc_channels, histogram_scale, node_histograms_t
from quickrank_tpu_torch.trees import grow
from quickrank_tpu_torch.trees.grow import (
    NEG_INF,
    GrowConfig,
    _best_splits,
    _deviance,
    _feature_sample_mask,
    _finish_tree,
    _node_stats,
)


def fit_tree_bestk(binned: torch.Tensor, grad: torch.Tensor,
                   doc_mask: torch.Tensor, thresholds: torch.Tensor,
                   cfg: GrowConfig, k: int,
                   generator: Optional[torch.Generator] = None, group=None):
    """Grow one tree, splitting up to ``k`` heap leaves per histogram pass.

    Arguments and result as :func:`trees.grow.fit_tree` (a tree without leaf
    values, and node_of_doc int32 [N] over all docs, this rank's under
    ``group``); ``k`` is clamped to [1, nleaves - 1]."""
    N, F = binned.shape
    dev = binned.device
    B = cfg.num_bins
    max_nodes = cfg.max_nodes
    minls = cfg.min_leaf_support
    k = int(min(max(k, 1), max(cfg.nleaves - 1, 1)))
    thr_host = thresholds.cpu().numpy()

    chan = doc_channels(grad, doc_mask)
    chan_t = torch.where(doc_mask[None, :], chan.T, 0.0).contiguous()
    scale = histogram_scale(chan_t, group, cfg.num_docs)

    def hists_of(pos, num_nodes):
        return node_histograms_t(binned, chan_t, pos, num_nodes, B, group=group,
                                 scale=scale)

    hist = torch.zeros((max_nodes, F, B, 3), dtype=torch.float32, device=dev)
    hist[0] = hists_of(torch.where(doc_mask, 0, 1), 1)[0]
    deviance = torch.zeros(max_nodes, dtype=torch.float32, device=dev)
    deviance[0] = _deviance(*_node_stats(hist[0]))

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
    nfs = cfg.num_feature_samples(F)

    while True:
        heap = active & ~frozen
        hs = int(heap.sum())
        if not (hs > 0 and taken + hs < cfg.nleaves):
            break
        heap_t = torch.from_numpy(heap).to(dev)
        sel_dev, sel_ids = torch.sort(torch.where(heap_t, deviance, NEG_INF),
                                      descending=True, stable=True)
        sel_dev, sel_ids = sel_dev[:k], sel_ids[:k]
        masks = torch.stack([_feature_sample_mask(generator, F, nfs)
                             for _ in range(k)]).to(dev)
        has_split, f_star, t_star, _ = _best_splits(hist[sel_ids], masks, minls)
        # the round's one host sync; a rank beyond |heap| holds -inf
        sel, has_split, f_star, t_star, positive, in_heap = torch.stack([
            sel_ids, has_split.long(), f_star, t_star, (sel_dev > 0).long(),
            (sel_dev > NEG_INF).long(),
        ]).tolist()
        grow.HOST_SYNCS += 1
        budget = cfg.nleaves - (taken + hs)
        splits = []  # (leaf, feature, bin), in deviance-rank order
        for r in range(k):
            if not in_heap[r]:
                continue
            leaf = sel[r]
            can_split = bool(has_split[r] and positive[r])
            if cfg.max_depth:
                can_split = can_split and depth[leaf] < cfg.max_depth
            if not can_split:
                frozen[leaf] = True
                taken += 1
            elif len(splits) < budget:
                splits.append((leaf, f_star[r], t_star[r]))
            # a splittable leaf over the budget stays on the heap: exact
            # best-first would not have popped it
        if not splits:
            continue
        n_sel = len(splits)
        leaves = [s[0] for s in splits]
        a_ids = [n_nodes + 2 * j for j in range(n_sel)]
        # one upload: the slot of every node among the round's splits
        # (n_sel = none), and each slot's feature, bin, left child and leaf
        slot_of_node = np.full(max_nodes, n_sel, np.int64)
        slot_of_node[leaves] = np.arange(n_sel)
        tables = torch.from_numpy(np.concatenate([
            slot_of_node, [s[1] for s in splits], [0], [s[2] for s in splits], [0],
            a_ids, [0], leaves, [0]]).astype(np.int64)).to(dev)
        slot_of_node_t, f_tab, t_tab, a_tab, leaf_tab = torch.split(
            tables, [max_nodes] + [n_sel + 1] * 4)
        slot = slot_of_node_t[node_of_doc.long()]
        in_sel = slot < n_sel
        goes_right = binned.gather(1, f_tab[slot][:, None])[:, 0].long() > t_tab[slot]
        node_of_doc = torch.where(
            in_sel, a_tab[slot] + goes_right.long(), node_of_doc).to(torch.int32)
        left_hist = hists_of(
            torch.where(in_sel & ~goes_right & doc_mask, slot, n_sel), n_sel)
        a_t, leaves_t = a_tab[:n_sel], leaf_tab[:n_sel]
        right_hist = hist[leaves_t] - left_hist
        hist[a_t] = left_hist
        hist[a_t + 1] = right_hist
        deviance[a_t] = _deviance(*_node_stats(left_hist))
        deviance[a_t + 1] = _deviance(*_node_stats(right_hist))
        for (leaf, f, t), a in zip(splits, a_ids):
            b = a + 1
            feature[leaf] = f
            threshold[leaf] = thr_host[f, t]
            threshold_bin[leaf] = t
            left[leaf], right[leaf] = a, b
            active[leaf] = False
            active[a] = active[b] = True
            depth[a] = depth[b] = depth[leaf] + 1
            parent[a] = parent[b] = leaf
        n_nodes += 2 * n_sel

    nodes = dict(feature=feature, threshold=threshold, threshold_bin=threshold_bin,
                 left=left, right=right)
    return _finish_tree(binned, cfg, nodes, node_of_doc, deviance, depth,
                        parent, n_nodes)
