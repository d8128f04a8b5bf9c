"""Plain reference of the tree growers the training cells check, on bin ids,
at a dtype the caller picks (float64 for the reference, bfloat16 for the
control), and of a tree's output on raw feature values.

Best-first growth follows QuickRank's RegressionTree (rt.cc:49-355): the
leaf of largest deviance ``sum g^2 - (sum g)^2 / count`` splits next, at
the (feature, bin) of largest ``lsum^2/lcount + rsum^2/rcount`` whose
children both hold ``min_leaf_support`` docs (first maximum in feature-major
order), until the leaves number ``nleaves``.  Oblivious growth follows
ObliviousRT (ot.cc:46-201): one (feature, bin) a level, of largest gain
summed over every node of the level, valid only where every node keeps
``min_leaf_support`` docs on both sides; a level with no valid split or no
positive gain sends every doc left.  Leaf outputs are Newton steps
``sum(lambda) / sum(w)`` (rt.cc:186-207), 0 where ``sum(w)`` is below
DBL_EPSILON.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

EPS = 2.220446049250313e-16


def _histogram(bin_ids: torch.Tensor, channels: torch.Tensor, node: torch.Tensor,
               nodes: int, num_bins: int, block: int = 16) -> torch.Tensor:
    """``[nodes, F, B, C]`` sums of ``channels [N, C]`` by (node, feature,
    bin), docs with ``node < 0`` left out; features in blocks so that the
    index stays small."""
    N, F = bin_ids.shape
    C = channels.shape[1]
    out = torch.zeros((nodes * F * num_bins, C), dtype=channels.dtype,
                      device=channels.device)
    keep = node >= 0
    ids, vals, nd = bin_ids[keep], channels[keep], node[keep]
    for f0 in range(0, F, block):
        f = torch.arange(f0, min(f0 + block, F), device=ids.device)
        flat = (nd[:, None] * F + f[None, :]) * num_bins + ids[:, f0:f0 + len(f)]
        out.index_add_(0, flat.reshape(-1),
                       vals[:, None, :].expand(-1, len(f), -1).reshape(-1, C))
    return out.reshape(nodes, F, num_bins, C)


def _split_gains(hist: torch.Tensor, min_leaf_support: int):
    """(gain, valid) ``[..., F, B]`` of sending bins ``<= b`` left."""
    cum = hist.cumsum(-2)
    lc, ls = cum[..., 0], cum[..., 1]
    rc, rs = cum[..., -1:, 0] - lc, cum[..., -1:, 1] - ls
    gain = ls * ls / lc.clamp(min=1.0) + rs * rs / rc.clamp(min=1.0)
    return gain, (lc >= min_leaf_support) & (rc >= min_leaf_support)


def newton_leaves(node: torch.Tensor, lam: torch.Tensor, w: torch.Tensor, leaves: int):
    s = torch.zeros(leaves, dtype=lam.dtype, device=lam.device).index_add_(0, node, lam)
    d = torch.zeros(leaves, dtype=w.dtype, device=w.device).index_add_(0, node, w)
    return torch.where(d >= EPS, s / torch.where(d >= EPS, d, 1.0), 0.0)


def grow_best_first(bin_ids, table, lam, w, nleaves: int, min_leaf_support: int = 1):
    """A best-first tree: dict of per-node ``feature``, ``bin``,
    ``threshold`` (value), ``left``, ``right``, ``is_leaf``, ``leaf_value``
    (the output, on leaves) and each doc's leaf node ``node``."""
    N, F = bin_ids.shape
    B = table.shape[1]
    dt = lam.dtype
    chan = torch.stack([torch.ones_like(lam), lam, lam * lam], dim=1)
    max_nodes = 2 * nleaves - 1
    node = torch.zeros(N, dtype=torch.int64, device=lam.device)
    hist = {0: _histogram(bin_ids, chan, node, 1, B)[0]}

    def deviance(h):
        c, s, s2 = h[0, :, 0].sum(), h[0, :, 1].sum(), h[0, :, 2].sum()
        return float(s2 - s * s / c) if float(c) > 0 else 0.0

    dev = {0: deviance(hist[0])}
    feature, bin_, thr = [-1] * max_nodes, [-1] * max_nodes, [0.0] * max_nodes
    left, right = [0] * max_nodes, [0] * max_nodes
    heap, frozen, n_nodes, taken = [0], set(), 1, 0
    while True:
        live = [i for i in heap if i not in frozen]
        if not live or taken + len(live) >= nleaves:
            break
        leaf = max(live, key=lambda i: (dev[i], -i))
        gain, valid = _split_gains(hist[leaf], min_leaf_support)
        gain = torch.where(valid, gain, -torch.inf).reshape(-1)
        flat = int(torch.argmax(gain))
        if not bool(valid.any()) or dev[leaf] <= 0:
            frozen.add(leaf)
            taken += 1
            continue
        f, b = divmod(flat, B)
        a, c = n_nodes, n_nodes + 1
        in_leaf = node == leaf
        go_left = bin_ids[:, f] <= b
        node = torch.where(in_leaf, torch.where(go_left, a, c), node)
        for child in (a, c):
            hist[child] = _histogram(bin_ids, chan, torch.where(node == child, 0, -1), 1, B)[0]
            dev[child] = deviance(hist[child])
        feature[leaf], bin_[leaf], thr[leaf] = f, b, float(table[f, b])
        left[leaf], right[leaf] = a, c
        heap.remove(leaf)
        heap += [a, c]
        n_nodes += 2
    leaf_value = newton_leaves(node, lam, w, max_nodes)
    is_leaf = torch.tensor([i < n_nodes and feature[i] < 0 for i in range(max_nodes)],
                           device=lam.device)
    return dict(feature=torch.tensor(feature, device=lam.device), bin=torch.tensor(bin_),
                threshold=torch.tensor(thr, dtype=torch.float32, device=lam.device),
                left=torch.tensor(left, device=lam.device),
                right=torch.tensor(right, device=lam.device),
                is_leaf=is_leaf, leaf_value=torch.where(is_leaf, leaf_value, 0.0).to(dt),
                node=node)


def grow_oblivious(bin_ids, table, lam, w, depth: int, min_leaf_support: int = 1):
    """An oblivious tree: ``fid``, ``bin``, ``threshold`` per level, ``leaf``
    outputs ``[2^depth]`` and each doc's leaf index ``node``."""
    N, F = bin_ids.shape
    B = table.shape[1]
    chan = torch.stack([torch.ones_like(lam), lam], dim=1)
    node = torch.zeros(N, dtype=torch.int64, device=lam.device)
    fid, bins_, thr = [], [], []
    alive = True
    for d in range(depth):
        hist = _histogram(bin_ids, chan, node, 2 ** d, B)
        gain, valid = _split_gains(hist, min_leaf_support)
        valid = valid.all(0)
        total = torch.where(valid, gain.sum(0), -torch.inf).reshape(-1)
        flat = int(torch.argmax(total))
        f, b = divmod(flat, B)
        can = alive and bool(valid.any()) and float(total[flat]) > 0
        bit = (bin_ids[:, f] > b).long() if can else torch.zeros_like(node)
        node = 2 * node + bit
        fid.append(f if can else 0)
        bins_.append(b if can else B)
        thr.append(float(table[f, b]) if can else float(torch.finfo(torch.float32).max))
        alive = can
    leaf = newton_leaves(node, lam, w, 2 ** depth)
    return dict(fid=torch.tensor(fid, device=lam.device), bin=torch.tensor(bins_),
                threshold=torch.tensor(thr, dtype=torch.float32, device=lam.device),
                leaf=leaf, node=node)


def tree_output(x: torch.Tensor, tree: dict, dtype=torch.float64) -> torch.Tensor:
    """Leaf output of each row of raw features ``x`` under a best-first
    tree's node arrays (``x[f] <= threshold`` goes left)."""
    t = {k: torch.as_tensor(tree[k]).to(x.device)
         for k in ("feature", "threshold", "left", "right", "is_leaf", "leaf_value")}
    feature, threshold = t["feature"].long(), t["threshold"].float()
    left, right, is_leaf = t["left"].long(), t["right"].long(), t["is_leaf"].bool()
    node = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    for _ in range(len(feature)):
        f = feature[node].clamp(min=0)
        go = x[rows, f] <= threshold[node]
        node = torch.where(is_leaf[node], node, torch.where(go, left[node], right[node]))
    return t["leaf_value"].to(dtype)[node]

