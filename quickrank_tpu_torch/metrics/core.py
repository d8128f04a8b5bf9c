"""Batched IR-metric functions over padded per-query views (counterpart of
quickrank_tpu/metrics/core.py).

Every function works on ``[Q, D]`` score/label views with a boolean slot
mask, vectorized over queries.  Conventions match the reference:

  * gain(label)    = 2^label - 1                  (src/metric/ir/dcg.cc:35-39)
  * discount(rank) = 1 / log2(rank + 2), 0-based rank
  * a cutoff k truncates the discount vector
  * swap-delta ("jacobian") matrices are rank-space: entry [i, j] is the
    signed metric change when the docs at ranks i and j swap scores
    (include/metric/ir/metric.h:114-137).

Ranking sorts by descending score with ties in slot order, the key and tie
rule of the JAX package's ``sort_by_score`` (whose sort, like
``torch.sort``, counts -0.0 and +0.0 as equal).
"""

from __future__ import annotations

import torch

from quickrank_tpu_torch.ops import kernel_query_sum

NEG_INF = float("-inf")


def sort_by_score(scores, slot_mask, *extras):
    """One stable sort by descending score, padding slots last.

    Returns ``(order, sorted_mask, *sorted_extras)``: ``order[q, r]`` is
    the slot of the rank-r doc."""
    key = torch.where(slot_mask, -scores, torch.inf)
    _, order = torch.sort(key, dim=-1, stable=True)
    return (order, slot_mask.gather(-1, order),
            *(e.gather(-1, order) for e in extras))


def unsort_to_slots(order, *vals):
    """Rank-space arrays back to slot space: ``out[order[r]] = vals[r]``."""
    outs = tuple(torch.empty_like(v).scatter_(-1, order, v) for v in vals)
    return outs if len(vals) > 1 else outs[0]


def query_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over one axis of a per-query view.  On the CPU a float32 sum (the
    order the tests hold against XLA's).  On CUDA a float32 pairwise tree
    over the axis padded to a power of two (``ops/kernel_query_sum.py``, one
    launch): CUDA's own float32 reductions take their order from the
    tensor's shape and each row's alignment, so a query's sum would depend
    on which queries share its batch (its chunk, or its rank's block under
    query sharding); the tree's order depends on the axis length only."""
    if x.device.type == "cpu":
        return torch.sum(x, dim=dim)
    return kernel_query_sum.query_sum(x, dim)


def gains(labels):
    """2^label - 1 (exponential gain, dcg.cc:35-39)."""
    return torch.exp2(labels) - 1.0


def discounts(D: int, cutoff: int, nvalid):
    """``[Q, D]`` discount per rank: 1/log2(r+2) for r < min(cutoff,
    nvalid), else 0."""
    r = torch.arange(D, dtype=torch.float32, device=nvalid.device)
    disc = 1.0 / torch.log2(r + 2.0)
    valid = r[None, :] < torch.clamp(nvalid, max=cutoff)[:, None]
    return torch.where(valid, disc[None, :], 0.0)


def sorted_labels_by_score(scores, labels, slot_mask):
    order, sm, sl = sort_by_score(scores, slot_mask, labels)
    return torch.where(sm, sl, 0.0), sm, order


def dcg_from_sorted(sorted_labels, nvalid, cutoff: int):
    """DCG of a rank-ordered label matrix ``[Q, D]`` (dcg.cc:33-39)."""
    disc = discounts(sorted_labels.shape[-1], cutoff, nvalid)
    return query_sum(gains(sorted_labels) * disc)


def ideal_dcg(labels, slot_mask, nvalid, cutoff: int):
    """IDCG: DCG of the labels sorted descending (ndcg.cc:35-47)."""
    keyed = torch.where(slot_mask, labels, NEG_INF)
    sl = torch.sort(keyed, dim=-1, descending=True).values
    sl = torch.where(torch.isfinite(sl), sl, 0.0)
    return dcg_from_sorted(sl, nvalid, cutoff)


def dcg(scores, labels, slot_mask, nvalid, cutoff: int):
    sl, _, _ = sorted_labels_by_score(scores, labels, slot_mask)
    return dcg_from_sorted(sl, nvalid, cutoff)


def ndcg(scores, labels, slot_mask, nvalid, cutoff: int):
    """NDCG per query; 0 when IDCG == 0 (ndcg.cc:51-59)."""
    idcg = ideal_dcg(labels, slot_mask, nvalid, cutoff)
    d = dcg(scores, labels, slot_mask, nvalid, cutoff)
    return torch.where(idcg > 0, d / torch.clamp(idcg, min=1e-30), 0.0)


def _tie_groups(ss, sm):
    """[Q, D, D] bool: valid rank pairs with equal scores."""
    return (ss[..., :, None] == ss[..., None, :]) & sm[..., :, None] & sm[..., None, :]


def tndcg(scores, labels, slot_mask, nvalid, cutoff: int):
    """Tie-aware NDCG: gains averaged over tied-score groups
    (tndcg.cc:36-66)."""
    idcg = ideal_dcg(labels, slot_mask, nvalid, cutoff)
    _, sm, ss, sl = sort_by_score(
        scores, slot_mask, torch.where(slot_mask, scores, NEG_INF), labels
    )
    g = torch.where(sm, gains(sl), 0.0)
    same = _tie_groups(ss, sm)
    group_size = torch.clamp(same.sum(-1), min=1)
    avg_gain = query_sum(same * g[..., None, :]) / group_size
    disc = discounts(ss.shape[-1], cutoff, nvalid)
    t = query_sum(avg_gain * disc)
    return torch.where(idcg > 0, t / torch.clamp(idcg, min=1e-30), 0.0)


def average_precision(scores, labels, slot_mask, nvalid, cutoff: int):
    """AP@cutoff per query over score-ranked docs: the intended metric
    (labels in rank order), as the JAX package evaluates it; the reference's
    Map::evaluate_result_list reads labels in dataset order (map.cc:34-46)."""
    sl, sm, _ = sorted_labels_by_score(scores, labels, slot_mask)
    r = torch.arange(sl.shape[-1], dtype=torch.float32, device=sl.device)
    in_cut = (r[None, :] < torch.clamp(nvalid, max=cutoff)[:, None]) & sm
    rel = torch.where(in_cut & (sl > 0), 1.0, 0.0)
    relcount = torch.cumsum(rel, dim=-1)
    ap = query_sum(rel * relcount / (r[None, :] + 1.0))
    nrel = rel.sum(-1)
    return torch.where(nrel > 0, ap / torch.clamp(nrel, min=1.0), 0.0)


def rmse_sse(scores, labels, slot_mask, nvalid, cutoff: int):
    """Per-query sum of squared errors over the first min(cutoff, n) docs in
    dataset order (rmse.cc:34-43); the caller aggregates (rmse.cc:46-60)."""
    r = torch.arange(scores.shape[-1], device=scores.device)
    in_cut = (r[None, :] < torch.clamp(nvalid, max=cutoff)[:, None]) & slot_mask
    err = torch.where(in_cut, scores - labels, 0.0)
    return query_sum(err * err)


# ---------------------------------------------------------------------------
# Rank-space swap-delta matrices
# ---------------------------------------------------------------------------


def ndcg_delta_matrix(sorted_labels, sm, nvalid, cutoff: int, normalize: bool = True):
    """Signed ΔDCG (ΔNDCG when ``normalize``) for swapping ranks (i, j):
    ``(disc_j - disc_i) (2^l_i - 2^l_j) [/ idcg]`` (ndcg.cc:72-88,
    dcg.cc:66-80), symmetric in (i, j)."""
    g = torch.where(sm, torch.exp2(sorted_labels), 0.0)
    disc = discounts(sorted_labels.shape[-1], cutoff, nvalid)
    dd = disc[..., None, :] - disc[..., :, None]
    dg = g[..., :, None] - g[..., None, :]
    pair_ok = sm[..., :, None] & sm[..., None, :]
    delta = torch.where(pair_ok, dd * dg, 0.0)
    if normalize:
        idcg = ideal_dcg(sorted_labels, sm, nvalid, cutoff)
        safe = torch.clamp(idcg, min=1e-30)
        delta = torch.where((idcg > 0)[..., None, None],
                            delta / safe[..., None, None], 0.0)
    return delta


def _upper_mirrored(ok, delta):
    upper = torch.where(ok, delta, 0.0)
    return upper + upper.transpose(-1, -2)


def tndcg_delta_matrix(sorted_labels, sorted_scores, sm, nvalid, cutoff: int):
    """Tie-aware ΔTNDCG swap matrix (tndcg.cc:76-124): w_r is the mean of
    1/log2(k+2) over r's tie group, / idcg; Δ_ij = (w_j' - w_i)(2^l_i -
    2^l_j) with w_j' = 0 beyond the cutoff, for i < j within the cutoff."""
    D = sorted_labels.shape[-1]
    dev = sorted_labels.device
    g = torch.where(sm, torch.exp2(sorted_labels), 0.0)
    r = torch.arange(D, dtype=torch.float32, device=dev)
    disc_all = (1.0 / torch.log2(r + 2.0))[None, :] * sm
    ss = torch.where(sm, sorted_scores, NEG_INF)
    same = _tie_groups(ss, sm)
    gsize = torch.clamp(same.sum(-1), min=1)
    w = query_sum(same * disc_all[..., None, :]) / gsize

    idcg = ideal_dcg(sorted_labels, sm, nvalid, cutoff)
    safe = torch.clamp(idcg, min=1e-30)
    w = torch.where((idcg > 0)[..., None], w / safe[..., None], 0.0)

    in_cut = torch.arange(D, device=dev)[None, :] < torch.clamp(nvalid, max=cutoff)[:, None]
    w_j = torch.where(in_cut, w, 0.0)
    delta = (w_j[..., None, :] - w[..., :, None]) * (
        g[..., :, None] - g[..., None, :]
    )
    idx = torch.arange(D, device=dev)
    ok = ((idx[:, None] < idx[None, :])[None]
          & in_cut[..., :, None] & sm[..., :, None] & sm[..., None, :])
    return _upper_mirrored(ok, delta)


def map_delta_matrix(sorted_labels, sm, nvalid, cutoff: int):
    """Exact ΔAP swap matrix over binary relevance l = (label > 0).

    For i < j with l_i != l_j and diff = l_j - l_i:
        Δ = [ (rc_i + diff) l_j - rc_i l_i ] / (i+1)
          + diff * Σ_{i<k<j} l_k/(k+1)  -  rc_j diff / (j+1),   all / count

    The reference's Map::jacobian (map.cc:58-76) writes the middle term as
    Σ l_k (rc_k + diff)/(k+1), the new AP summands rather than their change,
    which is not the swap delta; like the JAX package, the port keeps the
    exact delta.  No cutoff, as in the reference."""
    D = sorted_labels.shape[-1]
    dev = sorted_labels.device
    l = torch.where(sm & (sorted_labels > 0), 1.0, 0.0)
    rc = torch.cumsum(l, dim=-1)
    count = rc[..., -1:]
    pos = torch.arange(D, dtype=torch.float32, device=dev) + 1.0
    Pl = torch.cumsum(l / pos, dim=-1)

    li, lj = l[..., :, None], l[..., None, :]
    diff = lj - li
    rci, rcj = rc[..., :, None], rc[..., None, :]
    posi, posj = pos[None, :, None], pos[None, None, :]
    mid = diff * (Pl[..., None, :] - Pl[..., :, None] - lj / posj)
    delta = ((rci + diff) * lj - rci * li) / posi + mid - rcj * diff / posj
    delta = delta / torch.clamp(count[..., None], min=1.0)

    idx = torch.arange(D, device=dev)
    ok = ((li != lj) & (idx[:, None] < idx[None, :])[None]
          & sm[..., :, None] & sm[..., None, :] & (count[..., None] > 0))
    return _upper_mirrored(ok, delta)
