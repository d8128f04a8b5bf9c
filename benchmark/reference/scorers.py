"""Plain reference of the scoring cells: an ensemble's score of each row of
raw features, summed over the trees in the dtype the caller picks (float64
for the reference, bfloat16 for the control).  A best-first tree sends
``x[f] <= threshold`` left; an oblivious tree's leaf index gathers one bit a
level, ``x[f] > threshold``.  It imports nothing of the program.
"""

from __future__ import annotations

import torch


def score_oblivious(x: torch.Tensor, fid, thr, leaf, weight, dtype=torch.float64,
                    block: int = 128) -> torch.Tensor:
    """Scores ``[N]`` of rows ``x`` under level tables ``fid``/``thr``
    ``[T, D]``, ``leaf`` ``[T, 2^D]`` and ``weight`` ``[T]``."""
    dev = x.device
    fid, thr = fid.long().to(dev), thr.to(dev, dtype)
    leaf, weight = leaf.to(dev, dtype), weight.to(dev, dtype)
    xs = x.to(dtype)
    out = torch.zeros(x.shape[0], dtype=dtype, device=dev)
    for t0 in range(0, fid.shape[0], block):
        t = slice(t0, t0 + block)
        idx = torch.zeros((x.shape[0], fid[t].shape[0]), dtype=torch.long, device=dev)
        for d in range(fid.shape[1]):
            idx = 2 * idx + (xs[:, fid[t, d]] > thr[t, d]).long()
        vals = leaf[t].gather(1, idx.T).T  # [N, block]
        out += (vals * weight[t]).sum(1)
    return out


def score_trees(x: torch.Tensor, feature, threshold, left, right, is_leaf, leaf_value,
                weight, dtype=torch.float64, block: int = 128) -> torch.Tensor:
    """Scores ``[N]`` of rows ``x`` under node arrays ``[T, nodes]`` (the
    root at node 0) and ``weight`` ``[T]``."""
    dev = x.device
    feature, left, right = (a.long().to(dev) for a in (feature, left, right))
    is_leaf = is_leaf.bool().to(dev)
    threshold, leaf_value = threshold.to(dev, dtype), leaf_value.to(dev, dtype)
    weight = weight.to(dev, dtype)
    xs = x.to(dtype)
    N, nodes = x.shape[0], feature.shape[1]
    out = torch.zeros(N, dtype=dtype, device=dev)
    for t0 in range(0, feature.shape[0], block):
        t = slice(t0, t0 + block)
        T = feature[t].shape[0]
        base = (torch.arange(T, device=dev) * nodes)[None, :]
        node = torch.zeros((N, T), dtype=torch.long, device=dev)
        feat, thr = feature[t].reshape(-1), threshold[t].reshape(-1)
        lf, rt, leafy = left[t].reshape(-1), right[t].reshape(-1), is_leaf[t].reshape(-1)
        for _ in range(nodes):
            flat = base + node
            done = leafy[flat]
            if bool(done.all()):
                break
            go = xs.gather(1, feat[flat].clamp(min=0)) <= thr[flat]
            node = torch.where(done, node, torch.where(go, lf[flat], rt[flat]))
        vals = leaf_value[t].reshape(-1)[base + node]
        out += (vals * weight[t]).sum(1)
    return out
