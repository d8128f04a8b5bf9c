"""The benchmark's inputs, drawn from ``--seed``: LETOR-shaped training data
and the random ensembles the scoring cells serve.

``letor_fold`` is a copy of the program's synthetic generator
(``data/synthetic.py``: graded labels 0..4 skewed toward 0 from per-query
quantiles of a utility of the first eight features, two redundant columns),
drawn on the device with a ``torch.Generator``.  The query lengths are drawn
once from the configuration's ``sizes_seed`` and only their order follows
``--seed``, so every seed gives the same amount of work.

``oblivious_model`` and ``bestfirst_model`` are copies of the program's
``trees/random_ensemble.py`` draws (``bench.py``'s headline model and
best-first-shaped 16-leaf trees) as numpy node arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def substream(seed: int, *keys: int) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *keys]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def query_lengths(num_queries: int, avg_docs: int, sizes_seed: int) -> np.ndarray:
    rng = np.random.default_rng(sizes_seed)
    return rng.integers(max(8, avg_docs // 3), avg_docs * 2, size=num_queries)


def letor_fold(num_queries: int, avg_docs: int, num_features: int, sizes_seed: int,
               seed: int, fold: int, device, noise: float = 0.35, grades: int = 5):
    """(features f32 [N, F], labels f32 [N], counts int64 [Q]) on ``device``;
    the docs of a query are consecutive."""
    counts = query_lengths(num_queries, avg_docs, sizes_seed)
    counts = counts[np.random.default_rng(substream(seed, fold, 0)).permutation(num_queries)]
    n = int(counts.sum())
    gen = torch.Generator(device=device).manual_seed(substream(seed, fold, 1))
    x = torch.randn((n, num_features), generator=gen, device=device)
    k = min(8, num_features)
    qid = torch.repeat_interleave(torch.arange(num_queries, device=device),
                                  torch.as_tensor(counts, device=device))
    shift = 0.5 * torch.randn((num_queries, k), generator=gen, device=device)
    x[:, :k] += shift[qid]

    def c(i):
        return x[:, i % num_features]

    u = (1.2 * c(0) + 0.9 * torch.tanh(c(1)) + 0.8 * (c(2) > 0.3) * c(3)
         + 0.6 * (c(4) > 0.0) * (c(5) > 0.0) + 0.4 * c(6).abs() - 0.5 * (c(7) < -0.5))
    u = u + noise * u.std() * torch.randn(n, generator=gen, device=device)

    # graded labels from each query's quantiles (numpy's linear method)
    D = int(counts.max())
    starts = torch.as_tensor(np.concatenate(([0], np.cumsum(counts)[:-1])), device=device)
    cnt = torch.as_tensor(counts, device=device)
    slot = torch.arange(D, device=device)[None, :]
    valid = slot < cnt[:, None]
    padded = torch.where(valid, u[(starts[:, None] + slot).clamp(max=n - 1)], torch.inf)
    srt = torch.sort(padded, dim=1).values
    q = torch.tensor([0.55, 0.75, 0.88, 0.97], device=device, dtype=torch.float64)
    h = (cnt[:, None] - 1).double() * q[None, :]
    lo = h.floor().long()
    hi = (lo + 1).clamp(max=(cnt[:, None] - 1))
    vlo, vhi = srt.gather(1, lo).double(), srt.gather(1, hi).double()
    cuts = (vlo + (h - lo.double()) * (vhi - vlo)).float()  # [Q, 4]
    grade = (u[:, None] >= cuts[qid]).sum(1)
    labels = grade.clamp(max=grades - 1).float()

    if num_features >= 10:
        x[:, 8] = x[:, 0] * 0.5 + 0.1 * torch.randn(n, generator=gen, device=device)
        x[:, 9] = (x[:, 1] > 0).float()
    return x, labels, counts


def oblivious_model(num_trees: int, depth: int, num_features: int, seed: int) -> dict:
    """Level tables of ``bench.py``'s headline draws: split features,
    normal thresholds and leaf values, weight 0.1 a tree."""
    rng = np.random.default_rng(substream(seed, 7))
    return dict(
        fid=rng.integers(0, num_features, size=(num_trees, depth)).astype(np.int32),
        thr=rng.normal(size=(num_trees, depth)).astype(np.float32),
        leaf=rng.normal(size=(num_trees, 2 ** depth)).astype(np.float32),
        weight=np.full((num_trees,), 0.1, np.float32),
    )


def oblivious_as_nodes(m: dict) -> dict:
    """The oblivious tables as perfect trees in heap layout (node i's
    children 2i+1 and 2i+2; leaf l of a level table is node 2^D - 1 + l)."""
    T, D = m["fid"].shape
    L = 2 ** D
    nodes = 2 * L - 1
    idx = np.arange(nodes)
    level = np.floor(np.log2(idx + 1)).astype(np.int64).clip(max=D - 1)
    internal = idx < L - 1
    feature = np.where(internal, m["fid"][:, level], -1).astype(np.int32)
    threshold = np.where(internal, m["thr"][:, level], 0.0).astype(np.float32)
    leaf_value = np.zeros((T, nodes), np.float32)
    leaf_value[:, L - 1:] = m["leaf"]
    return dict(feature=feature, threshold=threshold,
                threshold_bin=np.zeros((T, nodes), np.int32),
                left=np.broadcast_to(np.where(internal, 2 * idx + 1, 0), (T, nodes)).astype(np.int32),
                right=np.broadcast_to(np.where(internal, 2 * idx + 2, 0), (T, nodes)).astype(np.int32),
                is_leaf=np.broadcast_to(~internal, (T, nodes)).copy(),
                leaf_value=leaf_value, weight=m["weight"], num_trees=T)


def bestfirst_model(num_trees: int, nleaves: int, num_features: int, seed: int) -> dict:
    """Best-first-shaped trees: from a root leaf, split a random leaf
    (the newest with probability 0.6, so chains get deep) until there are
    ``nleaves``; normal thresholds and leaf values, weight 0.1 a tree."""
    rng = np.random.default_rng(substream(seed, 8))
    T, nodes = num_trees, 2 * nleaves - 1
    feature = np.full((T, nodes), -1, np.int32)
    threshold = np.zeros((T, nodes), np.float32)
    left = np.zeros((T, nodes), np.int32)
    right = np.zeros((T, nodes), np.int32)
    is_leaf = np.ones((T, nodes), bool)
    leaf_value = np.zeros((T, nodes), np.float32)
    for t in range(T):
        leaves, nxt = [0], 1
        while nxt < nodes:
            i = leaves.pop(-1 if rng.random() < 0.6 else rng.integers(len(leaves)))
            feature[t, i] = rng.integers(num_features)
            threshold[t, i] = rng.normal()
            left[t, i], right[t, i] = nxt, nxt + 1
            is_leaf[t, i] = False
            leaves += [nxt, nxt + 1]
            nxt += 2
        leaf_value[t, leaves] = rng.normal(size=len(leaves))
    return dict(feature=feature, threshold=threshold,
                threshold_bin=np.zeros((T, nodes), np.int32), left=left, right=right,
                is_leaf=is_leaf, leaf_value=leaf_value,
                weight=np.full((T,), 0.1, np.float32), num_trees=T)


def leaf_depths(m: dict) -> np.ndarray:
    """Mean leaf depth of each tree of node arrays (the QuickScorer bound)."""
    T, nodes = m["feature"].shape
    out = np.zeros(T)
    for t in range(T):
        depth = np.zeros(nodes, np.int64)
        for i in range(nodes):
            if not m["is_leaf"][t, i]:
                depth[m["left"][t, i]] = depth[m["right"][t, i]] = depth[i] + 1
        reach = np.zeros(nodes, bool)
        reach[0] = True
        for i in range(nodes):
            if reach[i] and not m["is_leaf"][t, i]:
                reach[m["left"][t, i]] = reach[m["right"][t, i]] = True
        out[t] = depth[reach & m["is_leaf"][t]].mean()
    return out


def feature_pool(batches: int, rows: int, num_features: int, seed: int, device) -> torch.Tensor:
    """``[batches, rows, F]`` float32 normal features, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(substream(seed, 9))
    return torch.randn((batches, rows, num_features), generator=gen, device=device)
