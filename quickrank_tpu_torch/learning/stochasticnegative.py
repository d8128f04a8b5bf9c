"""Stochastic negative sampling LambdaMART (counterpart of
quickrank_tpu/learning/stochasticnegative.py, after
src/learning/forests/stochasticnegative.cc:285-330): every iteration each
query keeps all its positive (label > 0) docs and a ``subsample`` fraction
(a count when > 1) of its negatives, drawn uniformly; the lambdas are
computed among the kept docs only (LambdaMart's query cleaning).

The reference's per-query sort and shuffle is a batched ranking by a random
key over the padded ``[Q, D]`` view.  The keys come from the iteration's
``torch.Generator`` (the learner's stream 2), so they cannot reproduce
``jax.random``'s; the rule they feed is the JAX package's.  They are one
draw over the data's ``[queries, longest query]`` view in global query
order (``StepData.query_keys``), so a rank of a query-sharded group keeps
its queries' rows of the one rank's draw, and everything else is per query.
"""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import scatter_flat
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.mart import StepData, TrainData


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """``rank`` with ``rank[..., order[..., i]] = i`` (``argsort(order)``)."""
    idx = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, idx.contiguous())


def sample_presence(sd: StepData, num_docs_padded: int, frac: float,
                    generator: torch.Generator) -> torch.Tensor:
    """Keep mask bool ``[N]``: every positive and, per query, the
    ``floor(frac * nneg)`` negatives (``min(int(frac), nneg)`` when frac > 1)
    of lowest uniform key (JAX stochasticnegative.py:27-50)."""
    mask = sd.slot_mask
    labels = sd.labels2d
    pos = (labels > 0) & mask
    neg = (labels <= 0) & mask
    keyed = torch.where(neg, sd.query_keys(generator), torch.inf)
    # rank of each negative inside its query, by its random key
    rank = inverse_permutation(torch.argsort(keyed, dim=-1, stable=True))
    nneg = neg.sum(dim=-1, keepdim=True)
    if frac > 1.0:
        k = torch.clamp(nneg, max=int(frac))
    else:
        k = torch.floor(nneg.to(torch.float32) * float(np.float32(frac))).to(torch.int64)
    keep = pos | (neg & (rank < k))
    return scatter_flat(keep.to(torch.float32), sd.pad_index, mask, num_docs_padded) > 0.5


class StochasticNegative(LambdaMart):
    NAME = "STOCHASTIC-NEGATIVE"

    def __init__(self, *args, subsample: float = 0.5, **kw):
        super().__init__(*args, subsample=1.0, **kw)
        # the reference reuses the subsample flag as the negative fraction;
        # the base class's uniform subsampling is off in favour of it
        self.negative_fraction = float(subsample)
        self._num_docs_padded = 0

    def _info_dict(self) -> dict:
        d = super()._info_dict()
        # the base class would write self.subsample (forced to 1.0) and lose
        # the negative fraction on save and --restart-train; the reference
        # stores it under the same reused flag
        d["subsample"] = self.negative_fraction
        return d

    def _post_init(self, tr: TrainData) -> None:
        self._num_docs_padded = tr.padded.num_docs_padded

    def _update_presence(self, m, tr, scores_tr, generator):
        if self.negative_fraction == 1.0:
            return None
        return sample_presence(tr.step, self._num_docs_padded, self.negative_fraction,
                               generator)
