"""Oblivious (symmetric) regression trees: the level-synchronous fit and the
dense level tables (counterpart of quickrank_tpu/trees/oblivious.py, after
``ObliviousRT``, src/learning/tree/ot.cc:32-201).

One (feature, threshold) is chosen per depth level by maximizing the gain
summed over every fringe node, then all nodes split together.  A level is
one ``node_histograms`` pass over all 2^d fringe nodes with two channels
(count, gradient), so 16 nodes share a kernel launch, and one masked argmax
over the summed gain.

Reference semantics kept (ot.cc:177-201 ``fill``):
  * gain(f, t) = sum over fringe nodes of lsum^2/lcount + rsum^2/rcount;
  * a (f, t) that breaks min_leaf_support in any fringe node is invalid;
  * growth stops when no (f, t) is valid or the best gain is 0: dead levels
    keep threshold FLT_MAX (every doc routes left) and bin ``B``;
  * leaf values are the per-leaf mean, or the Newton step
    sum(lambda)/sum(w), through :func:`oblivious_leaf_outputs`.

The level tables (feature and threshold per level, 2^D leaf values) make
scoring free of traversal: a doc's leaf index is the OR of its per-level
comparison bits (src/io/generate_oblivious.cc:306-312).

Under a query-sharded group (``parallel/mesh.py``) each level's histograms
and the leaf sums are reduced over the ranks (JAX oblivious.py:126-127,
208-209); sharding the feature axis is ROADMAP.md §A item 10b.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from quickrank_tpu_torch.ops.histogram import (
    histogram_scale,
    node_histograms_t,
    prefix_sum,
    tree_sum,
)
from quickrank_tpu_torch.trees.structs import Tree

NEG_INF = float("-inf")
FLT_MAX = float(np.float32(3.4028235e38))
#: ``thr_bin`` of a slot that holds no tree
DEAD_BIN = 2 ** 30

_DTYPES = {
    "fid": torch.int32,
    "thr": torch.float32,
    "thr_bin": torch.int32,
    "leaf": torch.float32,
    "weight": torch.float32,
}


@dataclasses.dataclass
class ObliviousEnsemble:
    """Stacked oblivious trees: ``fid`` i32 [T, D] split feature per level;
    ``thr`` f32 [T, D] (FLT_MAX on dead levels); ``thr_bin`` i32 [T, D];
    ``leaf`` f32 [T, 2^D]; ``weight`` f32 [T]; ``num_trees`` live prefix."""

    fid: torch.Tensor
    thr: torch.Tensor
    thr_bin: torch.Tensor
    leaf: torch.Tensor
    weight: torch.Tensor
    num_trees: int
    #: cache of :attr:`min_features`; ``to`` carries it, ``push`` clears it
    _min_features: Optional[int] = None

    @property
    def capacity(self) -> int:
        return int(self.fid.shape[0])

    @property
    def depth(self) -> int:
        return int(self.fid.shape[1])

    @property
    def num_leaves(self) -> int:
        return int(self.leaf.shape[1])

    @property
    def min_features(self) -> int:
        """Smallest feature count the tables can be scored against (read
        from the device once, then cached)."""
        if self._min_features is None:
            self._min_features = int(self.fid.max()) + 1 if self.fid.numel() else 1
        return self._min_features

    @staticmethod
    def empty(capacity: int, depth: int, device="cpu") -> "ObliviousEnsemble":
        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=device)

        return ObliviousEnsemble(
            fid=full((capacity, depth), 0, torch.int32),
            thr=full((capacity, depth), FLT_MAX, torch.float32),
            thr_bin=full((capacity, depth), DEAD_BIN, torch.int32),
            leaf=full((capacity, 2 ** depth), 0.0, torch.float32),
            weight=full((capacity,), 0.0, torch.float32),
            num_trees=0,
        )

    def push(self, fid, thr, thr_bin, leaf, weight: float) -> None:
        """Write one tree into slot ``num_trees`` and count it live.  In
        place: the JAX package returns a new pytree."""
        t = self.num_trees
        if t >= self.capacity:
            raise ValueError(f"ensemble full: capacity {self.capacity}")
        self.fid[t] = fid
        self.thr[t] = thr
        self.thr_bin[t] = thr_bin
        self.leaf[t] = leaf
        self.weight[t] = weight
        self.num_trees = t + 1
        self._min_features = None

    def to(self, device) -> "ObliviousEnsemble":
        self.min_features  # read on the source's device, carried by replace
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _DTYPES}
        )

    def wleaf(self) -> torch.Tensor:
        """``leaf * (weight * live)[:, None]`` in float32, the table the
        scorers sum: each product is rounded once, before any add."""
        live = torch.arange(self.capacity, device=self.fid.device) < self.num_trees
        return self.leaf * (self.weight * live.float())[:, None]

    @staticmethod
    def from_numpy(d: Mapping[str, np.ndarray]) -> "ObliviousEnsemble":
        """Build from the six fields as numpy arrays (or anything
        ``np.asarray`` takes), e.g. the JAX package's ObliviousEnsemble."""
        kw = {k: torch.as_tensor(np.array(d[k])).to(dt) for k, dt in _DTYPES.items()}
        ens = ObliviousEnsemble(num_trees=int(np.asarray(d["num_trees"])), **kw)
        T, D = ens.fid.shape
        want = {"fid": (T, D), "thr": (T, D), "thr_bin": (T, D),
                "leaf": (T, 2 ** D), "weight": (T,)}
        for k, shape in want.items():
            if tuple(getattr(ens, k).shape) != shape:
                raise ValueError(
                    f"{k}: shape {tuple(getattr(ens, k).shape)}, want {shape}"
                )
        if not 0 <= ens.num_trees <= T:
            raise ValueError(f"num_trees {ens.num_trees} outside [0, {T}]")
        return ens


def fit_oblivious_tree(binned: torch.Tensor, grad: torch.Tensor,
                       doc_mask: torch.Tensor, thresholds: torch.Tensor,
                       depth: int, min_leaf_support: int = 1, group=None,
                       num_docs: int = 0):
    """Level-synchronous fit (ot.cc:46-175).

    Returns ``(fid [D] i32, thr [D] f32, thr_bin [D] i32, node_of_doc [N]
    i32 in [0, 2^D))`` on ``binned``'s device.  Every doc is routed; the mask
    only gates the statistics.  There is no host sync.  ``num_docs`` counts
    the real docs among the rows (0: all), for the card's fixed-point
    scale."""
    N = binned.shape[0]
    dev = binned.device
    B = thresholds.shape[1]
    thresholds = thresholds.to(dev)
    # two channels (count, gradient): the shared-split gain never reads the
    # squared gradient, and 16 nodes pack into a pass instead of 10
    m = doc_mask.to(grad.dtype)
    chan_t = torch.stack([m, grad * m]).contiguous()
    scale = histogram_scale(chan_t, group, num_docs)
    node = torch.zeros(N, dtype=torch.int32, device=dev)
    fid = torch.zeros(depth, dtype=torch.int32, device=dev)
    thr = torch.full((depth,), FLT_MAX, dtype=torch.float32, device=dev)
    thr_bin = torch.full((depth,), B, dtype=torch.int32, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)

    for d in range(depth):
        hist = node_histograms_t(binned, chan_t, node, 2 ** d, B, group=group,
                                 scale=scale)  # [nodes, F, B, 2]
        cum = prefix_sum(hist, 2)
        lc = cum[..., 0]
        ls = cum[..., 1]
        rc = cum[:, :, -1:, 0] - lc
        rs = cum[:, :, -1:, 1] - ls
        node_gain = ls * ls / torch.clamp(lc, min=1.0) + rs * rs / torch.clamp(rc, min=1.0)
        ok = (lc >= min_leaf_support) & (rc >= min_leaf_support)
        valid = ok.all(dim=0)  # [F, B]: must hold in every fringe node
        # nodes summed in XLA's order, so equal histograms give equal splits
        total_gain = tree_sum(node_gain.movedim(0, -1))
        gain = torch.where(valid, total_gain, NEG_INF).reshape(-1)
        # first maximum, as jnp.argmax; kept 1-element so that indexing
        # with it reads nothing back to the host
        flat = torch.argmax(gain).reshape(1)
        f_star = flat // B
        t_star = flat % B
        can = alive & valid.any() & (gain[flat][0] > 0)
        fcol = binned.index_select(1, f_star)[:, 0]
        bit = (fcol.to(torch.int32) > t_star).to(torch.int32)
        node = torch.where(can, 2 * node + bit, 2 * node)
        fid[d] = torch.where(can, f_star[0], 0)
        thr[d] = torch.where(can, thresholds.reshape(-1)[flat][0], FLT_MAX)
        thr_bin[d] = torch.where(can, t_star[0], B)
        alive = can

    return fid, thr, thr_bin, node


def oblivious_leaf_outputs(node_of_doc: torch.Tensor, grad: torch.Tensor,
                           doc_mask: torch.Tensor, num_leaves: int,
                           weights: Optional[torch.Tensor] = None,
                           group=None) -> torch.Tensor:
    """Leaf values f32 [num_leaves]: mean pseudoresponse (ot.cc:146-152), or
    the Newton step when ``weights`` is given."""
    from quickrank_tpu_torch.trees.grow import EPS, segment_sums

    idx = torch.where(doc_mask, node_of_doc, num_leaves)
    g = torch.where(doc_mask, grad, 0.0)
    den_src = doc_mask.float() if weights is None else torch.where(doc_mask, weights, 0.0)
    both = segment_sums(idx, torch.stack([g, den_src], dim=-1), num_leaves + 1, group)
    sums, den = both[:num_leaves, 0], both[:num_leaves, 1]
    return torch.where(den >= EPS, sums / torch.clamp(den, min=EPS), 0.0)


def oblivious_to_tree(fid: torch.Tensor, thr: torch.Tensor,
                      thr_bin: torch.Tensor, leaf: torch.Tensor) -> Tree:
    """(fid [D], thr [D], thr_bin [D], leaf [2^D]) -> the perfect tree that
    repeats one (feature, threshold) across each level, in heap layout: node
    i has children 2i+1 and 2i+2, leaves on the last level."""
    D = int(fid.shape[0])
    L = 2 ** D
    n_internal = L - 1
    max_nodes = 2 * L - 1
    dev = fid.device
    idx = torch.arange(max_nodes, device=dev)
    internal = idx < n_internal
    # heap layout: node i sits at depth floor(log2(i + 1))
    lvl = torch.tensor([min((i + 1).bit_length() - 1, D - 1) for i in range(max_nodes)],
                       device=dev)
    return Tree(
        feature=torch.where(internal, fid[lvl], -1).to(torch.int32),
        threshold=torch.where(internal, thr[lvl], 0.0).to(torch.float32),
        threshold_bin=torch.where(internal, thr_bin[lvl], -1).to(torch.int32),
        left=torch.where(internal, 2 * idx + 1, 0).to(torch.int32),
        right=torch.where(internal, 2 * idx + 2, 0).to(torch.int32),
        is_leaf=~internal,
        leaf_value=torch.cat([torch.zeros(n_internal, dtype=torch.float32, device=dev),
                              leaf.to(torch.float32)]),
    )
