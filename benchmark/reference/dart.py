"""Plain reference of DART, LambdaMART with tree dropout (Rashmi &
Gilad-Bachrach, AISTATS 2015, arXiv:1505.01866), as hpclab/quickrank's
``src/learning/forests/dart.cc`` runs it with its defaults: the FIXED
schedule, UNIFORM sampling (or CONTR, the roulette by contribution) and
TREE normalization.  It builds on ``letor.py`` (bins, NDCG, lambdas) and
``trees.py`` (the best-first grower) and imports nothing of the program.

Iteration ``m`` (from 1) over a model of ``T = m - 1`` trees:

1. the dropout count, FIXED (dart.cc:1095-1181): ``rate_drop * T`` (or
   ``rate_drop`` itself when it is 1 or more and at most half of ``T``),
   capped at ``T // 2`` and rounded half away from zero, as C's round();
   none with probability ``skip_drop``;
2. the dropped set D (dart.cc:708-854): UNIFORM takes the first ``k`` live
   trees of a permutation of the model; CONTR draws ``k`` trees one at a
   time, each with probability proportional to its contribution (its mean
   |output| over the docs) among those not yet drawn;
3. the dropped trees' weighted outputs leave the scores;
4. the lambdas of those scores, and the best-first tree on them, whose
   output is its Newton step;
5. TREE normalization (dart.cc:856-942): with ``k = |D|`` and shrinkage
   ``s``, the new tree weighs ``s / (s + k)`` and each dropped tree's weight
   is scaled by ``k / (k + s)``; the scores take the dropped trees back at
   their new weights and the new tree at its own.  Without a drop the new
   tree weighs ``s``.

Departures from dart.cc:

* the draws come from numpy's ``default_rng(seed)`` and not from dart.cc's
  ``std::mt19937``: a uniform for ``skip_drop`` every iteration, a uniform
  for ``random_keep`` when trees drop, then the permutation (UNIFORM) or one
  ``choice`` a dropped tree (CONTR), in that order;
* no valid fold, early stop, rollback to the best iteration, compaction of
  zero-weighted trees (TREE never zeroes a weight) or periodic full rescore:
  the caller follows a fixed number of iterations and reads the weights
  after any of them (:func:`schedule`);
* the arithmetic is at the dtype the caller picks (float64 for the
  reference; dart.cc keeps double scores and float weights).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import letor, trees

SAMPLING = ("UNIFORM", "CONTR")


def dropout_count(rate_drop: float, model_size: int) -> int:
    """The FIXED schedule's count of trees to drop from ``model_size``."""
    if model_size <= 0:
        return 0
    if rate_drop >= 1:
        x = rate_drop if rate_drop * 2 <= model_size else 0.0
    else:
        x = rate_drop * model_size
    return int(math.floor(min(x, model_size // 2) + 0.5))


def draw_dropped(rng: np.random.Generator, weights, contributions, k: int,
                 sample_type: str = "UNIFORM") -> list:
    """The dropped set: ``k`` slots of the model, in the order drawn."""
    T = len(weights)
    if sample_type == "UNIFORM":
        return [int(i) for i in rng.permutation(T) if weights[i] > 0][:k]
    base = np.where(np.asarray(weights) > 0, np.asarray(contributions[:T], np.float64), 0.0)
    avail, chosen = base > 0, []
    for _ in range(k):
        if not avail.any():
            break
        p = np.where(avail, base, 0.0)
        if p.sum() <= 0:
            p = avail.astype(np.float64)
        i = int(rng.choice(T, p=p / p.sum()))
        chosen.append(i)
        avail[i] = False
    return chosen


def _draw(rng, weights, contributions, rate_drop, skip_drop, sample_type) -> list:
    """One iteration's draws, in the program's order."""
    skip = rng.random() <= skip_drop
    k = 0 if skip else dropout_count(rate_drop, len(weights))
    if k == 0:
        return []
    rng.random()  # X-DART's random_keep draw, made whether or not it is used
    return draw_dropped(rng, weights, contributions, k, sample_type)


def _restore(weights: list, dropped: list, shrinkage: float):
    """TREE normalization: (the new tree's weight, the dropped trees'
    factor); the dropped weights in ``weights`` are scaled in place."""
    k = len(dropped)
    if not k:
        return shrinkage, 1.0
    factor = k / (k + shrinkage)
    for i in dropped:
        weights[i] *= factor
    return shrinkage / (shrinkage + k), factor


def schedule(iterations: int, rate_drop: float, skip_drop: float, seed: int,
             shrinkage: float):
    """UNIFORM sampling's dropped sets and weights, which depend on the
    draws alone: (the dropped set of each of ``iterations`` iterations, the
    weights of the trees after the last)."""
    rng = np.random.default_rng(seed)
    weights, sets = [], []
    for _ in range(iterations):
        dropped = _draw(rng, weights, None, rate_drop, skip_drop, "UNIFORM")
        w_new, _ = _restore(weights, dropped, shrinkage)
        weights.append(w_new)
        sets.append(dropped)
    return sets, weights


def run(bin_ids: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
        lay: letor.Layout, iterations: int, *, nleaves: int, min_leaf_support: int,
        shrinkage: float, rate_drop: float, skip_drop: float, seed: int,
        sample_type: str = "UNIFORM", cutoff: int = 10, dtype=torch.float64,
        fault: str = "") -> dict:
    """``iterations`` DART iterations on the bin ids of the train fold:
    ``out`` (each tree's per-doc output, float64), ``node`` (each tree's leaf
    of each doc), ``fit`` (each iteration's lambdas and weights, those the
    tree was grown on), ``ndcg`` (train NDCG@cutoff after each iteration),
    ``dropped`` (each iteration's dropped set) and ``weights`` (the trees'
    weights after the last iteration).  ``fault``
    plants one of the check's faults: ``half`` leaves out every other
    query's lambdas, ``altered`` scales the first tree's outputs by 1.01,
    ``unchanged`` adds nothing to the scores, ``undropped`` leaves the
    dropped trees in the scores (the delta left out)."""
    if sample_type not in SAMPLING:
        raise ValueError(f"the reference samples {SAMPLING}, not {sample_type!r}")
    rng = np.random.default_rng(seed)
    dev = bin_ids.device
    scores = torch.zeros(lay.n, dtype=dtype, device=dev)
    qmask = torch.arange(lay.Q, device=dev) % 2 == 0 if fault == "half" else None
    out, nodes, fits, ndcg, sets, weights, contributions = [], [], [], [], [], [], []
    for m in range(iterations):
        dropped = _draw(rng, weights, contributions, rate_drop, skip_drop, sample_type)
        delta = torch.zeros_like(scores)
        if dropped and fault != "undropped":
            for i in dropped:
                delta = delta + (weights[i] * out[i]).to(dtype)
        s_drop = scores - delta
        lam, w = letor.lambdas(s_drop, labels, lay, cutoff, dtype, query_mask=qmask)
        tree = trees.grow_best_first(bin_ids, table, lam, w, nleaves, min_leaf_support)
        step = tree["leaf_value"][tree["node"]]
        if fault == "altered" and m == 0:
            step = step * 1.01
        if fault == "unchanged":
            step = torch.zeros_like(step)
        w_new, factor = _restore(weights, dropped, shrinkage)
        scores = s_drop + (factor * delta + w_new * step).to(dtype)
        weights.append(w_new)
        out.append(step.double())
        nodes.append(tree["node"])
        fits.append((lam, w))
        contributions.append(float(step.double().abs().mean()))
        sets.append(dropped)
        ndcg.append(letor.ndcg(scores, labels, lay, cutoff, dtype))
    return dict(out=out, node=nodes, fit=fits, ndcg=ndcg, dropped=sets, weights=weights)
