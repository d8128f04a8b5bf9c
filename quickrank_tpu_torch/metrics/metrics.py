"""Metric classes and factory (counterpart of quickrank_tpu/metrics/
metrics.py, after include/metric/ir/* and metric_factory.h:20-37).

Each metric wraps the batched functions of :mod:`.core`:

  * ``evaluate_per_query(scores, labels, slot_mask, nvalid) -> [Q]``
  * ``evaluate_dataset(padded, scores_flat) -> float`` (mean over queries,
    metric.h:77-106; RMSE aggregates over instances)
  * ``delta_matrix(...) -> [Q, D, D]`` rank-space swap deltas, which the
    lambda gradients weight pairs with.

Dataset aggregation returns a (numerator, denominator) pair, which
``finalize`` turns into the metric.
"""

from __future__ import annotations

import torch

from quickrank_tpu_torch.data.dataset import PaddedDataset, gather_padded
from quickrank_tpu_torch.metrics import core
from quickrank_tpu_torch.types import NO_CUTOFF


class Metric:
    """Base IR metric with a cutoff (include/metric/ir/metric.h:43)."""

    NAME = "METRIC"
    #: larger is better for every metric (RMSE is negated to comply)
    HIGHER_IS_BETTER = True

    def __init__(self, cutoff: int = NO_CUTOFF):
        self.cutoff = int(cutoff) if cutoff and cutoff > 0 else NO_CUTOFF

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        raise NotImplementedError

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        """Signed metric change when ranks (i, j) swap; zero for a
        rank-insensitive metric."""
        D = sorted_labels.shape[-1]
        return torch.zeros(sorted_labels.shape[:-1] + (D, D),
                           dtype=torch.float32, device=sorted_labels.device)

    def aggregate(self, per_query, query_mask, num_docs_valid=None):
        """(numerator, denominator) with metric = finalize(num, den)."""
        s = torch.sum(torch.where(query_mask, per_query, 0.0))
        return s, query_mask.sum().float()

    def finalize(self, num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)

    def evaluate_padded(self, padded: PaddedDataset, scores_flat) -> torch.Tensor:
        """Dataset-level metric (mean over queries, metric.h:77-106) as a
        0-d tensor on the scores' device."""
        dev = scores_flat.device
        slot_mask = padded.slot_mask.to(dev)
        idx = padded.pad_index.to(dev)
        scores = gather_padded(scores_flat, idx, slot_mask)
        labels = gather_padded(padded.labels.to(dev), idx, slot_mask)
        pq = self.evaluate_per_query(scores, labels, slot_mask, padded.nvalid.to(dev))
        num, den = self.aggregate(pq, padded.query_mask.to(dev),
                                  padded.doc_mask.to(dev).sum())
        return self.finalize(num, den)

    def evaluate_dataset(self, padded: PaddedDataset, scores_flat) -> float:
        return float(self.evaluate_padded(padded, torch.as_tensor(scores_flat)))

    def __repr__(self):
        if self.cutoff != NO_CUTOFF:
            return f"{self.NAME}@{self.cutoff}"
        return self.NAME


class Dcg(Metric):
    NAME = "DCG"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.dcg(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.ndcg_delta_matrix(sorted_labels, sm, nvalid, self.cutoff,
                                      normalize=False)


class Ndcg(Dcg):
    NAME = "NDCG"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.ndcg(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.ndcg_delta_matrix(sorted_labels, sm, nvalid, self.cutoff,
                                      normalize=True)


class Tndcg(Ndcg):
    NAME = "TNDCG"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.tndcg(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.tndcg_delta_matrix(sorted_labels, sorted_scores, sm, nvalid,
                                       self.cutoff)


class Map(Metric):
    NAME = "MAP"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.average_precision(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.map_delta_matrix(sorted_labels, sm, nvalid, self.cutoff)


class Rmse(Metric):
    """Negated RMSE over instances, rank-insensitive (rmse.cc:24-70)."""

    NAME = "RMSE"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.rmse_sse(scores, labels, slot_mask, nvalid, self.cutoff)

    def aggregate(self, per_query, query_mask, num_docs_valid=None):
        s = torch.sum(torch.where(query_mask, per_query, 0.0))
        return s, num_docs_valid.float()

    def finalize(self, num, den):
        return -torch.sqrt(num / torch.clamp(den, min=1.0))


_METRICS = {m.NAME: m for m in (Dcg, Ndcg, Tndcg, Map, Rmse)}


def metric_factory(name: str, cutoff: int = NO_CUTOFF) -> Metric:
    """Uppercased-name lookup (include/metric/metric_factory.h:20-37);
    takes both ("NDCG", 10) and "NDCG@10"."""
    name = name.upper().strip()
    if "@" in name:
        name, _, k = name.partition("@")
        cutoff = int(k)
    if name not in _METRICS:
        raise ValueError(f"unknown metric {name!r}; known: {sorted(_METRICS)}")
    return _METRICS[name](cutoff)
