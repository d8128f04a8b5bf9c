"""Pairwise LambdaRank gradients over padded per-query views (counterpart of
quickrank_tpu/ops/lambdas.py, after lambdamart.cc:62-152).

Per query, for every rank pair (j, k) with label_j > label_k and not both
beyond the metric cutoff:

    rho    = 1 / (1 + exp(s_j - s_k))          (lambdamart.cc:132-134)
    lambda_j += rho * |Delta_jk|,   lambda_k -= rho * |Delta_jk|
    w_j    += rho (1-rho) |Delta_jk|,  w_k    += the same

Delta is the metric's rank-space swap-delta matrix.  Outputs go back from
rank space to doc slots through the score sort's permutation.  Queries are
processed in chunks (a Python loop) so the live ``[chunk, D, D]`` or
``[chunk, cut, D]`` pair tensors stay bounded.  The pair sums go through
``metrics/core.py::query_sum``, so on the card a query's lambdas do not
depend on the chunk or the rank's block it is computed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from quickrank_tpu_torch.metrics import core


def _lambda_block_banded(scores, labels, slot_mask, nvalid, metric):
    """Cutoff-banded block for DCG/NDCG.  Swap deltas vanish when both ranks
    are beyond the cutoff (the reference's loop break,
    lambdamart.cc:124-126), so only the ``[cut, D]`` pair rows touching the
    cutoff are built.  Rows hold the (row label > col label) pairs; the
    (row label < col label) half stands for the transposed ``[D, cut]``
    block, by the symmetry of delta and sigmoid(-x) = 1 - sigmoid(x):

        lambda[r<cut]  = rowsum_G[r];   lambda[r>=cut] = -colsum_G[r]
        w[r<cut]       = rowsum_W[r];   w[r>=cut]      =  colsum_W[r]

    and 1/IDCG scales the sums once per query."""
    from quickrank_tpu_torch.metrics.metrics import Ndcg

    normalize = type(metric) is Ndcg
    order, sm, ss, sl = core.sort_by_score(scores, slot_mask, scores, labels)
    sl = torch.where(sm, sl, 0.0)

    D = scores.shape[-1]
    cut = min(metric.cutoff, D)
    disc = core.discounts(D, metric.cutoff, nvalid)
    g = torch.where(sm, torch.exp2(sl), 0.0)
    if normalize:
        idcg = core.ideal_dcg(sl, sm, nvalid, metric.cutoff)
        inv = torch.where(idcg > 0, 1.0 / torch.clamp(idcg, min=1e-30), 0.0)
    else:
        inv = torch.ones(scores.shape[:-1], dtype=scores.dtype, device=scores.device)

    row_sl, row_ss, row_sm = sl[..., :cut], ss[..., :cut], sm[..., :cut]
    delta = torch.abs(
        (disc[..., None, :] - disc[..., :cut, None])
        * (g[..., :cut, None] - g[..., None, :])
    )
    rho = torch.sigmoid(ss[..., None, :] - row_ss[..., :, None])
    rd = rho * delta
    valid = row_sm[..., :, None] & sm[..., None, :]
    gt = row_sl[..., :, None] > sl[..., None, :]
    lt = row_sl[..., :, None] < sl[..., None, :]
    G = (torch.where(gt & valid, rd, 0.0)
         - torch.where(lt & valid, delta - rd, 0.0))
    W = torch.where((gt | lt) & valid, rd * (1.0 - rho), 0.0)

    in_cut = torch.arange(D, device=scores.device) < cut
    lam_rank = torch.where(in_cut, F.pad(core.query_sum(G, -1), (0, D - cut)),
                           -core.query_sum(G, -2)) * inv[..., None]
    w_rank = torch.where(in_cut, F.pad(core.query_sum(W, -1), (0, D - cut)),
                         core.query_sum(W, -2)) * inv[..., None]
    lam, w = core.unsort_to_slots(order, lam_rank, w_rank)
    return torch.where(slot_mask, lam, 0.0), torch.where(slot_mask, w, 0.0)


def _lambda_block(scores, labels, slot_mask, nvalid, metric):
    """Full ``[Q, D, D]`` block for any metric: (lambdas, weights) in slot
    space."""
    order, sm, ss, sl = core.sort_by_score(scores, slot_mask, scores, labels)
    sl = torch.where(sm, sl, 0.0)
    delta = torch.abs(metric.delta_matrix(ss, sl, sm, nvalid))

    D = scores.shape[-1]
    cut = min(metric.cutoff, D)
    beyond = torch.arange(D, device=scores.device) >= cut
    pair_mask = (
        (sl[..., :, None] > sl[..., None, :])
        & sm[..., :, None] & sm[..., None, :]
        & ~(beyond[None, :, None] & beyond[None, None, :])
    )
    rho = torch.sigmoid(ss[..., None, :] - ss[..., :, None])
    m = torch.where(pair_mask, rho * delta, 0.0)
    mw = torch.where(pair_mask, rho * (1.0 - rho) * delta, 0.0)
    lam_rank = core.query_sum(m, -1) - core.query_sum(m, -2)
    w_rank = core.query_sum(mw, -1) + core.query_sum(mw, -2)
    lam, w = core.unsort_to_slots(order, lam_rank, w_rank)
    return torch.where(slot_mask, lam, 0.0), torch.where(slot_mask, w, 0.0)


def lambda_gradients(scores, labels, slot_mask, nvalid, metric,
                     query_chunk: Optional[int] = None):
    """(lambdas [Q, D], weights [Q, D]) in slot space from f32 [Q, D] scores
    and labels, bool slot mask and int32 nvalid.  ``query_chunk`` bounds the
    queries per pair block; by default about 45 MB per pair tensor, the JAX
    package's budget."""
    from quickrank_tpu_torch.metrics.metrics import Dcg, Ndcg

    Q, D = scores.shape
    cut = min(metric.cutoff, D)
    banded = type(metric) in (Dcg, Ndcg) and 3 * cut <= D
    block = _lambda_block_banded if banded else _lambda_block
    pair_elems = cut * D if banded else D * D
    if query_chunk is None:
        query_chunk = max(1, (45 << 20) // (4 * max(pair_elems, 1)))
    lams, ws = [], []
    for q0 in range(0, Q, query_chunk):
        sl = slice(q0, q0 + query_chunk)
        lam, w = block(scores[sl], labels[sl], slot_mask[sl], nvalid[sl], metric)
        lams.append(lam)
        ws.append(w)
    return torch.cat(lams), torch.cat(ws)
