"""Plain ensemble scoring by batched descent, Kahan-compensated over trees
(counterpart of quickrank_tpu/ops/scoring.py's ``kahan_add``,
``descend_tree``, ``descend_tree_binned``, ``tree_delta_binned``,
``score_ensemble(compensated=True)`` and ``partial_scores``).  The bin-space descent uses gathers
where the JAX package uses one-hot matmuls on the TPU (the two are bitwise
equal there).

This is the reference the fast scorers are held against.  Its one subtle
point is the Kahan step.  The JAX package writes ``kahan_add(s, c, w * d)``
with ``y = w*d - c``, and XLA on the CPU contracts that into one fused
multiply-add: ``y = fma(w, d, -c)``, rounded once.  Computing ``f32(w*d) - c``
instead differs from it in the last bit on a large share of documents.  So
the port fuses that one step (:func:`fma_f32`) and leaves the rest of the
chain unfused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.ops.binning import bin_columns, gather_bins
from quickrank_tpu_torch.trees.structs import EnsembleTensors, Tree


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once, as CUDA's ``__fmaf_rn``; any device.

    The product of two float32 values is exact in float64.  The float64 sum
    ``s = p + c`` is then turned into its round-to-odd value (TwoSum gives
    the exact error ``e``; an inexact ``s`` with an even last bit steps one
    ulp toward ``e``), and rounding a round-to-odd value with 53 bits to
    float32's 24 bits is the correct rounding of the exact sum (Boldo and
    Melquiond, "Emulation of FMA and correctly rounded sums: proved
    algorithms using rounding to odd", IEEE TC 2008)."""
    p = a.double() * b.double()
    q = c.double()
    s = p + q
    bv = s - p
    e = (p - (s - bv)) + (q - bv)
    step = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(step, torch.nextafter(s, toward), s)
    return s.float()


#: float32 lanes of XLA's CPU matrix-vector product (256-bit vectors)
_XLA_GEMV_LANES = 8


def matvec_f32(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``X @ w`` for ``X [N, T]`` and ``w [T]``, associated as XLA
    on the CPU evaluates a row-major matrix-vector product, on any device:
    per row, 8 lanes each accumulate every 8th of the first ``8 * (T // 8)``
    columns with a fused multiply-add, the lanes are summed in adjacent
    pairs ((0+1)+(2+3))+((4+5)+(6+7)), and the last ``T % 8`` columns,
    accumulated from zero by a chain of fused multiply-adds, are added to
    that sum.  Bitwise the JAX package's jitted ``X @ w`` (tests); a
    different order breaks exact ties between documents differently, and
    a ranking metric over few-leaf trees' scores moves with them."""
    N, T = X.shape
    L = _XLA_GEMV_LANES
    body = T // L * L
    lanes = torch.zeros((N, L), dtype=torch.float32, device=X.device)
    for j in range(0, body, L):
        lanes = fma_f32(X[:, j:j + L], w[None, j:j + L], lanes)
    while lanes.shape[1] > 1:
        lanes = lanes[:, 0::2] + lanes[:, 1::2]
    tail = torch.zeros(N, dtype=torch.float32, device=X.device)
    for j in range(body, T):
        tail = fma_f32(w[j], X[:, j], tail)
    return lanes[:, 0] + tail


def kahan_add(s: torch.Tensor, c: torch.Tensor, w: torch.Tensor,
              d: torch.Tensor):
    """One Kahan-compensated step adding ``w * d``: returns ``(s', c')``.

    ``y = fma(w, d, -c)`` is fused as in the JAX package on the CPU (module
    docstring); ``t = s + y`` and ``c' = (t - s) - y`` are plain float32
    operations, each rounded on its own."""
    y = fma_f32(w, d, -c)
    t = s + y
    return t, (t - s) - y


def descend_tree(features: torch.Tensor, ens: EnsembleTensors, t: int,
                 max_depth: int) -> torch.Tensor:
    """Leaf node id reached in tree slot ``t`` by every doc: int64 [N].

    ``max_depth`` rounds of: read the split at the current node, route left
    on ``x[f] <= threshold``.  Docs at a leaf stay put, so ``max_depth``
    only has to bound the tree's depth."""
    feature = ens.feature[t].long()
    threshold = ens.threshold[t]
    left = ens.left[t].long()
    right = ens.right[t].long()
    is_leaf = ens.is_leaf[t]
    node = torch.zeros(features.shape[0], dtype=torch.long,
                       device=features.device)
    for _ in range(max_depth):
        f = feature[node].clamp(min=0)
        x = features.gather(1, f[:, None])[:, 0]
        nxt = torch.where(x <= threshold[node], left[node], right[node])
        node = torch.where(is_leaf[node], node, nxt)
    return node


def descend_tree_binned(binned: torch.Tensor, tree: Tree,
                        max_depth: int) -> torch.Tensor:
    """Leaf node id int64 [N] reached by every doc in bin space: route left
    on ``bin <= threshold_bin``, which is the value routing ``x <=
    threshold`` by the binning's construction."""
    feature = tree.feature.long()
    left = tree.left.long()
    right = tree.right.long()
    node = torch.zeros(binned.shape[0], dtype=torch.long, device=binned.device)
    for _ in range(max_depth):
        f = feature[node].clamp(min=0)
        x = gather_bins(binned, f)
        nxt = torch.where(x <= tree.threshold_bin[node], left[node], right[node])
        node = torch.where(tree.is_leaf[node], node, nxt)
    return node


#: node tests a 64-bit word of :func:`delta_owned` carries (the sign bit
#: stays clear)
_WORD_BITS = 63
#: int64 words one all-reduce of :func:`delta_owned` carries at most (32
#: MiB; a block holds at least one doc and one slot)
OWNED_WORDS = 1 << 22
#: (doc, node test) elements :func:`delta_owned` compares at a time
_OWNED_CHUNK = 1 << 24


def _descend_owned(binned: torch.Tensor, fl: torch.Tensor, tb: torch.Tensor,
                   fields: dict, bit: torch.Tensor, per_tree: int, feat,
                   max_depth: int) -> torch.Tensor:
    """Leaf node ids int64 ``[n, T]`` of ``T`` trees (``fields``, their
    node arrays ``[T, M]``) for the ``n`` rows of ``binned``: this rank's
    node tests, ``per_tree`` words a tree (``bit``: each internal node's
    bit among its tree's), one all-reduce sum over the feature axis."""
    n = binned.shape[0]
    T = fl.shape[0]
    t_i, j_i = torch.nonzero(fl >= 0, as_tuple=True)  # the tests this rank owns
    word_of = t_i * per_tree + bit[t_i, j_i] // _WORD_BITS
    shift = bit[t_i, j_i] % _WORD_BITS
    col, thr = fl[t_i, j_i], tb[t_i, j_i]
    words = torch.zeros((n, T * per_tree), dtype=torch.int64, device=binned.device)
    step = max(1, _OWNED_CHUNK // max(n, 1))
    for p0 in range(0, col.numel(), step):
        p = slice(p0, p0 + step)
        tests = bin_columns(binned, col[p]).long() <= thr[p]
        words.index_add_(1, word_of[p], tests.long() << shift[p])
    words = feat.comm.all_reduce_sum(words).view(n, T, per_tree)
    left, right, is_leaf = fields["left"], fields["right"], fields["is_leaf"]
    node = torch.zeros((n, T), dtype=torch.long, device=binned.device)
    tree = torch.arange(T, device=binned.device)[None, :]
    for _ in range(max_depth):
        b = bit[tree, node]
        word = words.gather(2, (b // _WORD_BITS)[..., None])[..., 0]
        goes_left = ((word >> (b % _WORD_BITS)) & 1) > 0
        nxt = torch.where(goes_left, left[tree, node], right[tree, node])
        node = torch.where(is_leaf[tree, node], node, nxt)
    return node


def delta_owned(binned: torch.Tensor, ens: EnsembleTensors, slots, weights, feat,
                max_depth: int, words: int = OWNED_WORDS) -> torch.Tensor:
    """``sum_i weights[i] * tree_{slots[i]}(doc)`` f32 ``[N]`` when
    ``binned`` is one block of a 2-D mesh's feature axis (``feat``, a
    ``parallel.mesh.FeatureShard``) and the trees split on global feature
    ids (JAX ops/scoring.py:116-160 and :248-267, ``descend_tree_binned``
    and ``tree_delta_binned`` with ``feat_axis``).

    Each rank computes the node tests ``bin <= threshold_bin`` of the
    features it owns and packs them 63 to an int64 word (a tree's internal
    nodes in order); an all-reduce sum over the feature axis gives every
    rank every test, since each bit is set by at most its owner, so the sum
    is the OR, exactly.  The descent then reads the bits locally.  The work
    goes in blocks of docs, and within one in blocks of slots in order, one
    all-reduce of at most ``words`` int64 a block, so memory is bounded by
    ``words`` and not by docs x slots.  Each doc's Kahan chain of
    :func:`score_ensemble` runs over the slots in ``slots``' order: the
    leaves are the whole matrix's, so the sum is bitwise the QuickScorer
    scores of the same trees over the whole bin matrix, as K1 is bitwise
    the compensated descent."""
    dev = binned.device
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=ens.feature.device)
    fields = {k: getattr(ens, k).index_select(0, idx).to(dev)
              for k in ("feature", "threshold_bin", "left", "right", "is_leaf", "leaf_value")}
    for k in ("left", "right"):
        fields[k] = fields[k].long()
    inner = ~fields["is_leaf"]
    # an internal node's bit in its tree (a leaf reads a bit it then ignores)
    bit = (torch.cumsum(inner.long(), dim=1) - 1).clamp(min=0)
    per_tree = max(1, -(-int(inner.sum(1).max()) // _WORD_BITS)) if len(idx) else 1
    fl = torch.where(inner, feat.local_ids(fields["feature"]), -1)  # -1: another rank's
    tb = fields["threshold_bin"].long()
    w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    N, T = binned.shape[0], len(idx)
    tc = max(1, min(T, words // max(N * per_tree, 1)))
    nc = max(1, min(N, words // (tc * per_tree)))
    out = torch.zeros(N, dtype=torch.float32, device=dev)
    for d0 in range(0, N, nc):
        rows = binned[d0:d0 + nc]
        s = torch.zeros(rows.shape[0], dtype=torch.float32, device=dev)
        c = torch.zeros_like(s)
        for j0 in range(0, T, tc):
            j = slice(j0, j0 + tc)
            node = _descend_owned(rows, fl[j], tb[j], {k: v[j] for k, v in fields.items()},
                                  bit[j], per_tree, feat, max_depth)
            for i in range(node.shape[1]):
                leaf = fields["leaf_value"][j0 + i]
                s, c = kahan_add(s, c, w[j0 + i], leaf[node[:, i]])
        out[d0:d0 + nc] = s
    return out


def tree_delta_binned(binned: torch.Tensor, tree: Tree,
                      max_depth: int) -> torch.Tensor:
    """Leaf value f32 [N] reached by every doc, in bin space: the
    per-iteration validation rescore (mart.cc:361-366)."""
    return tree.leaf_value[descend_tree_binned(binned, tree, max_depth)]


def score_ensemble(features: torch.Tensor, ens: EnsembleTensors,
                   max_depth: Optional[int] = None) -> torch.Tensor:
    """Weighted ensemble scores f32 [N] = sum_t weight_t * tree_t(doc),
    Kahan-compensated over all capacity slots in order (dead slots take a
    zero-weight step, which still folds the compensation term)."""
    md = max_depth or ens.max_nodes
    n = features.shape[0]
    s = torch.zeros(n, dtype=torch.float32, device=features.device)
    c = torch.zeros_like(s)
    zero = torch.zeros((), dtype=torch.float32, device=features.device)
    for t in range(ens.capacity):
        d = ens.leaf_value[t][descend_tree(features, ens, t, md)]
        w = ens.weight[t] if t < ens.num_trees else zero
        s, c = kahan_add(s, c, w, d)
    return s


def partial_scores(features: torch.Tensor, ens: EnsembleTensors,
                   max_depth: Optional[int] = None) -> torch.Tensor:
    """Per-tree *unweighted* scores f32 ``[N, capacity]`` by descent: column
    ``t`` is ``leaf_value[node]`` of slot ``t``, dead slots are zero columns
    (Ensemble::partial_scores_instance, ensemble.cc:120-131; the per-tree
    SVML of Driver::extract_partial_scores, driver.cc:411-446)."""
    md = max_depth or ens.max_nodes
    out = torch.zeros((features.shape[0], ens.capacity), dtype=torch.float32,
                      device=features.device)
    for t in range(ens.num_trees):
        out[:, t] = ens.leaf_value[t][descend_tree(features, ens, t, md)]
    return out
