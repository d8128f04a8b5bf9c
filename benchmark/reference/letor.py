"""Plain reference of the learning-to-rank arithmetic the training cells
check: threshold tables, bin ids, NDCG@k and the LambdaMART lambdas.

Written from the semantics of QuickRank (mart.cc:127-170 for the tables,
ndcg.cc for the metric, lambdamart.cc:62-152 for the lambdas), in plain
PyTorch at a dtype the caller picks: float64 for the reference, bfloat16
for the lower-precision control.  It imports nothing of the program.

Docs come query after query; ``counts`` holds each query's length.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)


class Layout:
    """The padded ``[Q, D]`` view of docs stored query after query."""

    def __init__(self, counts: np.ndarray, device):
        counts = np.asarray(counts, np.int64)
        self.counts = torch.as_tensor(counts, device=device)
        self.Q, self.D = len(counts), int(counts.max())
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        slot = np.arange(self.D)[None, :]
        self.mask = torch.as_tensor(slot < counts[:, None], device=device)
        index = np.where(slot < counts[:, None], starts[:, None] + slot, 0)
        self.index = torch.as_tensor(index, device=device)
        self.n = int(counts.sum())

    def pad(self, x: torch.Tensor, fill=0.0) -> torch.Tensor:
        return torch.where(self.mask, x[self.index], torch.as_tensor(fill, dtype=x.dtype,
                                                                   device=x.device))

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.n, dtype=x.dtype, device=x.device)
        out[self.index[self.mask]] = x[self.mask]
        return out


def thresholds(features: torch.Tensor, nthresholds: int):
    """Per-feature split points ``[F, B]`` (float32, FLT_MAX padded): the
    sorted distinct values when there are at most ``nthresholds`` of them,
    else ``nthresholds`` equi-width points from the minimum, computed in
    double; then FLT_MAX, the "everything" bin."""
    F = features.shape[1]
    rows = []
    for f in range(F):
        col = features[:, f]
        lo, hi = col.min(), col.max()
        uniq = None
        if nthresholds <= 0 or (lo == hi):
            uniq = torch.unique(col)
        else:
            few = torch.unique(col[: 4 * nthresholds])
            if few.numel() <= nthresholds:  # maybe few distinct values: look at all
                uniq = torch.unique(col)
                if uniq.numel() > nthresholds:
                    uniq = None
        if uniq is not None:
            th = uniq.float()
        else:
            step = (hi.double() - lo.double()).abs() / nthresholds
            th = (lo.double() + step * torch.arange(nthresholds, dtype=torch.float64,
                                                     device=col.device)).float()
        rows.append(torch.cat([th, th.new_tensor([FLT_MAX])]))
    B = max(len(r) for r in rows)
    out = torch.full((F, B), FLT_MAX, dtype=torch.float32, device=features.device)
    for f, r in enumerate(rows):
        out[f, : len(r)] = r
    return out


def bins(features: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Bin ids int32 ``[N, F]``: the smallest t with value <= table[f, t]."""
    out = torch.empty(features.shape, dtype=torch.int32, device=features.device)
    for f in range(features.shape[1]):
        out[:, f] = torch.searchsorted(table[f].contiguous(), features[:, f].contiguous(),
                                       out_int32=True)
    return out.clamp_(max=table.shape[1] - 1)


def _rank_order(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Slots by descending score, ties in slot order, padding last."""
    key = torch.where(mask, -scores.double(), torch.inf)
    return torch.sort(key, dim=-1, stable=True).indices


def _discounts(D: int, cutoff: int, n: torch.Tensor, dtype) -> torch.Tensor:
    r = torch.arange(D, device=n.device, dtype=torch.float64)
    disc = 1.0 / torch.log2(r + 2.0)
    return torch.where(r[None, :] < n.clamp(max=cutoff)[:, None], disc[None, :], 0.0).to(dtype)


def _ideal_dcg(labels: torch.Tensor, mask: torch.Tensor, n, cutoff: int, dtype):
    sl = torch.sort(torch.where(mask, labels, -1.0), dim=-1, descending=True).values
    gains = torch.where(sl >= 0, torch.exp2(sl.clamp(min=0).to(dtype)) - 1.0, 0.0)
    return (gains * _discounts(labels.shape[1], cutoff, n, dtype)).sum(-1)


def ndcg(scores: torch.Tensor, labels: torch.Tensor, lay: Layout, cutoff: int = 10,
         dtype=torch.float64) -> float:
    """Mean NDCG@cutoff over the queries (0 for a query with no relevant
    doc), of per-doc ``scores`` and ``labels``."""
    s, lab = lay.pad(scores), lay.pad(labels)
    order = _rank_order(s, lay.mask)
    sl = torch.where(lay.mask.gather(1, order), lab.gather(1, order), 0.0)
    disc = _discounts(lay.D, cutoff, lay.counts, dtype)
    dcg = ((torch.exp2(sl.to(dtype)) - 1.0) * disc).sum(-1)
    idcg = _ideal_dcg(lab, lay.mask, lay.counts, cutoff, dtype)
    per_query = torch.where(idcg > 0, dcg / torch.where(idcg > 0, idcg, 1.0), 0.0)
    return float(per_query.double().mean())


def lambdas(scores: torch.Tensor, labels: torch.Tensor, lay: Layout, cutoff: int = 10,
            dtype=torch.float64, chunk_pairs: int = 1 << 26,
            query_mask: torch.Tensor | None = None):
    """LambdaMART's (lambda, weight) per doc for NDCG@cutoff: over each
    query's rank pairs (i, j) with label_i > label_j and not both at or past
    the cutoff, with ``Delta = |(disc_i - disc_j)(2^l_i - 2^l_j)| / IDCG``
    and ``rho = 1 / (1 + exp(s_i - s_j))``: lambda_i += rho Delta,
    lambda_j -= rho Delta, and both weights += rho (1 - rho) Delta.
    ``query_mask`` keeps only the queries it marks (a planted fault)."""
    s, lab = lay.pad(scores).to(dtype), lay.pad(labels)
    lam_pad = torch.zeros((lay.Q, lay.D), dtype=dtype, device=s.device)
    w_pad = torch.zeros_like(lam_pad)
    step = max(1, chunk_pairs // (lay.D * lay.D))
    for q0 in range(0, lay.Q, step):
        q = slice(q0, q0 + step)
        mask = lay.mask[q]
        if query_mask is not None:
            mask = mask & query_mask[q, None]
        order = _rank_order(s[q], mask)
        ss = s[q].gather(1, order)
        sm = mask.gather(1, order)
        sl = torch.where(sm, lab[q].gather(1, order), 0.0)
        n = sm.sum(-1)
        disc = _discounts(lay.D, cutoff, n, dtype)
        idcg = _ideal_dcg(lab[q], mask, n, cutoff, dtype)
        inv = torch.where(idcg > 0, 1.0 / torch.where(idcg > 0, idcg, 1.0), 0.0)
        g = torch.exp2(sl.to(dtype))
        delta = ((disc[:, :, None] - disc[:, None, :]) * (g[:, :, None] - g[:, None, :])).abs()
        delta = delta * inv[:, None, None]
        r = torch.arange(lay.D, device=s.device)
        beyond = r >= cutoff
        pair = ((sl[:, :, None] > sl[:, None, :]) & sm[:, :, None] & sm[:, None, :]
                & ~(beyond[None, :, None] & beyond[None, None, :]))
        rho = 1.0 / (1.0 + torch.exp(ss[:, :, None] - ss[:, None, :]))
        m = torch.where(pair, rho * delta, 0.0)
        mw = torch.where(pair, rho * (1.0 - rho) * delta, 0.0)
        lam_rank = m.sum(-1) - m.sum(-2)
        w_rank = mw.sum(-1) + mw.sum(-2)
        lam_pad[q].scatter_(1, order, lam_rank)
        w_pad[q].scatter_(1, order, w_rank)
    lam_pad = torch.where(lay.mask, lam_pad, 0.0)
    w_pad = torch.where(lay.mask, w_pad, 0.0)
    return lay.unpad(lam_pad), lay.unpad(w_pad)
