"""Selective Gradient Boosting (SIGIR'18), LambdaMART with periodic
rank-aware negative sampling (counterpart of
quickrank_tpu/learning/selective.py, after
src/learning/forests/lambdamartselective.cc).

Every ``sampling_iterations`` boosting rounds each query keeps all its
positives plus (a) its top-scored negatives and (b) random extra negatives,
counted by the ``negative_strategy``:

  * RATIO: round(factor * #negatives)                      (lms.cc:119-121)
  * MUL:   round(factor * #positives), capped               (lms.cc:123-127)
  * POS:   factor * #negatives ranked above the last positive (lms.cc:129-157)

and the ``adaptive_strategy`` (NO, FIXED, RATIO, MIX; lms.cc:344-369)
modulates the two factors by ``adapt_factor``, the share of improving
iterations among the last ``normalization_factor`` (lms.cc:261-270).

The reference's per-query sorts are batched stable rankings over the padded
``[Q, D]`` view.  Counts are float32 products rounded half to even, as
``jnp.round`` rounds.  The random extras rank the remaining negatives by
keys from the iteration's ``torch.Generator`` (the learner's stream 2) in
place of ``jax.random``; with ``random_sampling_factor`` 0 there is no draw
and the masks are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import gather_padded, scatter_flat
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.mart import StepData, TrainData
from quickrank_tpu_torch.learning.stochasticnegative import inverse_permutation

NEGATIVE_STRATEGIES = ("RATIO", "MUL", "POS")
ADAPTIVE_STRATEGIES = ("NO", "FIXED", "RATIO", "MIX")


def _round_count(factor: float, count: torch.Tensor) -> torch.Tensor:
    """``round(float32(factor) * count)`` half to even, int64."""
    return torch.round(count.to(torch.float32) * float(np.float32(factor))).to(torch.int64)


def select_presence(scores_flat: torch.Tensor, sd: StepData, num_docs_padded: int,
                    strategy: str, rank_factor: float, random_factor: float,
                    generator: torch.Generator) -> torch.Tensor:
    """Keep mask bool ``[N]`` of one sampling round (JAX selective.py:31-103):
    every positive, the ``n_top`` best-scored negatives and ``n_rand`` more
    at random from the rest."""
    sm = sd.slot_mask
    labels = sd.labels2d
    scores = gather_padded(scores_flat, sd.pad_index, sm)
    pos = (labels > 0) & sm
    neg = (labels <= 0) & sm
    npos = pos.sum(dim=-1, keepdim=True)
    nneg = neg.sum(dim=-1, keepdim=True)

    # rank of each negative among the negatives, by descending score, ties
    # to the earlier slot
    keyed = torch.where(neg, scores, -torch.inf)
    neg_rank = inverse_permutation(torch.argsort(-keyed, dim=-1, stable=True))

    if strategy == "RATIO":
        n_top = _round_count(rank_factor, nneg)
        n_rand = _round_count(random_factor, nneg)
    elif strategy == "MUL":
        n_top = torch.minimum(_round_count(rank_factor, npos), nneg)
        n_rand = torch.minimum(_round_count(random_factor, npos), nneg)
    else:  # POS: the negatives ranked above the last positive
        all_rank = inverse_permutation(torch.argsort(
            -torch.where(sm, scores, -torch.inf), dim=-1, stable=True))
        last_pos = torch.where(pos, all_rank, -1).amax(dim=-1, keepdim=True)
        n_before = torch.clamp(last_pos + 1 - npos, min=0)
        n_before = torch.where(npos > 0, n_before, 0)
        n_top = torch.minimum(_round_count(rank_factor, n_before), nneg)
        n_rand = torch.minimum(_round_count(random_factor, n_before), nneg - n_top)
    n_rand = torch.minimum(n_rand, nneg - n_top)

    top_kept = neg & (neg_rank < n_top)
    # random extras among the remaining negatives
    rest = neg & ~top_kept
    r = torch.rand(sm.shape, generator=generator).to(sm.device)
    rrank = inverse_permutation(torch.argsort(torch.where(rest, r, torch.inf), dim=-1,
                                              stable=True))
    rand_kept = rest & (rrank < n_rand)

    keep = pos | top_kept | rand_kept
    return scatter_flat(keep.to(torch.float32), sd.pad_index, sm, num_docs_padded) > 0.5


class LambdaMartSelective(LambdaMart):
    NAME = "LAMBDAMART-SELECTIVE"
    _shardable = False  # ROADMAP.md §A item 10b

    def __init__(self, *args, sampling_iterations: int = 1, rank_sampling_factor: float = 1.0,
                 random_sampling_factor: float = 0.0, normalization_factor: float = 100,
                 adaptive_strategy: str = "NO", negative_strategy: str = "RATIO", **kw):
        super().__init__(*args, **kw)
        self.sampling_iterations = int(sampling_iterations)
        self.rank_sampling_factor = float(rank_sampling_factor)
        self.random_sampling_factor = float(random_sampling_factor)
        self.normalization_factor = float(normalization_factor)
        self.adaptive_strategy = adaptive_strategy.upper()
        self.negative_strategy = negative_strategy.upper()
        if self.adaptive_strategy not in ADAPTIVE_STRATEGIES:
            raise ValueError(f"unknown adaptive strategy {adaptive_strategy!r}")
        if self.negative_strategy not in NEGATIVE_STRATEGIES:
            raise ValueError(f"unknown negative strategy {negative_strategy!r}")
        self._improvements = None
        self._adapt_factor = 1.0
        self._cached_presence = None
        self._num_docs_padded = 0

    def _factors(self) -> tuple[float, float]:
        """The adaptive modulation of the (rank, random) factors
        (lms.cc:344-369)."""
        a = self._adapt_factor
        rk, rd = self.rank_sampling_factor, self.random_sampling_factor
        if self.adaptive_strategy == "NO":
            return rk, rd
        lo, hi = min(rk, rd), max(rk, rd)
        if self.adaptive_strategy == "FIXED":
            f = lo + (1 - a) * (hi - lo)
            return f, f
        if self.adaptive_strategy == "RATIO":
            s = rk + rd
            return s * a, s * (1 - a)
        f = lo + (1 - a) * (hi - lo)  # MIX
        return f * a, f * (1 - a)

    def _post_init(self, tr: TrainData) -> None:
        self._improvements = [True] * max(1, int(self.normalization_factor))
        self._num_docs_padded = tr.padded.num_docs_padded
        self._cached_presence = None

    def _update_presence(self, m, tr, scores_tr, generator):
        if not self.sampling_iterations or (
                self.rank_sampling_factor <= 0 and self.random_sampling_factor <= 0):
            return None
        if m > 0 and m % self.sampling_iterations == 0:
            rk, rd = self._factors()
            self._cached_presence = select_presence(
                scores_tr, tr.step, self._num_docs_padded, self.negative_strategy, rk, rd,
                generator)
        return self._cached_presence

    def _post_iteration(self, m: int, improved: bool) -> None:
        if self.adaptive_strategy != "NO" and self.normalization_factor > 0:
            w = self._improvements
            w[m % len(w)] = improved
            self._adapt_factor = float(np.mean(w))

    def _info_dict(self) -> dict:
        d = super()._info_dict()
        d.update({
            "sampling-iterations": self.sampling_iterations,
            "rank-sampling-factor": self.rank_sampling_factor,
            "random-sampling-factor": self.random_sampling_factor,
            "normalization-factor": self.normalization_factor,
            "adaptive-strategy": self.adaptive_strategy,
            "negative-strategy": self.negative_strategy,
        })
        return d

    @classmethod
    def _ctor_kwargs_from_info(cls, info) -> dict:
        g = cls._info_get
        d = super()._ctor_kwargs_from_info(info)
        d.update(
            sampling_iterations=g(info, "sampling-iterations", int, 1),
            rank_sampling_factor=g(info, "rank-sampling-factor", float, 1.0),
            random_sampling_factor=g(info, "random-sampling-factor", float, 0.0),
            normalization_factor=g(info, "normalization-factor", float, 100),
            adaptive_strategy=g(info, "adaptive-strategy", str, "NO"),
            negative_strategy=g(info, "negative-strategy", str, "RATIO"),
        )
        return d
