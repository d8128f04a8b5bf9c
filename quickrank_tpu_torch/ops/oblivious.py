"""Traversal-free scoring of oblivious ensembles, the plain version of the
bit-OR kernel (counterpart of quickrank_tpu/ops/oblivious.py:
``score_oblivious`` and ``score_oblivious_binned``).

The reference compiles oblivious models into branch-free C,
``leafidx |= (v[fid] > thresh) << (m-1-i)`` per level plus a table lookup
(src/io/generate_oblivious.cc:306-312).  Here, per chunk of trees: gather
the T*D split columns, compare with the thresholds, fold the bits into leaf
indices ``[N, T]``, and look the leaf values up.  The trees are then added
one by one in tree order in plain float32, the terms being the rows of
``wleaf = leaf * weight`` (each rounded once): the order and the terms of
the CUDA kernel (``csrc/oblivious_score.cu``), which is therefore bitwise
equal to this on the card.  The JAX package contracts a one-hot against
``wleaf`` in a matmul, so its sum order differs: scores agree within float32
summation tolerance, leaf indices exactly.

Value space and bin space share one implementation; only the threshold
table differs (``thr`` against ``thr_bin``, exact either way).
"""

from __future__ import annotations

import torch

from quickrank_tpu_torch.trees.oblivious import ObliviousEnsemble

#: elements of the largest [N, trees * depth] intermediate
_CHUNK_ELEMS = 1 << 26


def leaf_index(data: torch.Tensor, fid: torch.Tensor,
               thr_table: torch.Tensor) -> torch.Tensor:
    """int64 [N, T]: ``sum_d [data[n, fid[t, d]] > thr_table[t, d]] <<
    (D-1-d)``.  A value equal to its threshold routes left (bit 0)."""
    T, D = fid.shape
    sel = data[:, fid.reshape(-1).long()].view(data.shape[0], T, D)
    shifts = torch.arange(D - 1, -1, -1, device=data.device)
    return ((sel > thr_table).long() << shifts).sum(dim=-1)


def _score_impl(data, thr_table, ens: ObliviousEnsemble, tree_chunk: int):
    N = data.shape[0]
    T, D = ens.fid.shape
    wleaf = ens.wleaf()
    acc = torch.zeros(N, dtype=torch.float32, device=data.device)
    chunk = tree_chunk if tree_chunk > 0 else max(1, _CHUNK_ELEMS // max(1, N * D))
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        idx = leaf_index(data, ens.fid[t0:t1], thr_table[t0:t1])
        v = wleaf[t0:t1].gather(1, idx.T).T  # [N, chunk]
        for k in range(t1 - t0):
            acc = acc + v[:, k]
    return acc


def score_oblivious(features: torch.Tensor, ens: ObliviousEnsemble,
                    tree_chunk: int = 0) -> torch.Tensor:
    """Weighted scores f32 [N] = sum_t w_t * leaf[t, leafidx(doc, t)], on any
    device.  ``tree_chunk`` (0 = sized from N) bounds the trees gathered at
    once; it does not change the result."""
    return _score_impl(features, ens.thr, ens, tree_chunk)


def score_oblivious_binned(binned: torch.Tensor, ens: ObliviousEnsemble,
                           tree_chunk: int = 0) -> torch.Tensor:
    """The same scorer in bin space: bit = ``bin > thr_bin``."""
    return _score_impl(binned, ens.thr_bin, ens, tree_chunk)
