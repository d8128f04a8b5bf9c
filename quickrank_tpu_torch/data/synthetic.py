"""Deterministic synthetic LETOR-style data (counterpart of
quickrank_tpu/data/synthetic.py: the same numpy draws, so one seed gives the
same dataset in both packages).

A seeded, tree-learnable ranking problem with graded labels 0..4 skewed
toward 0, ~116 docs per query in [38, 232) and 136 features by default,
roughly the statistics of MSLR-WEB30K.
"""

from __future__ import annotations

import numpy as np

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.types import FEATURE_DTYPE, LABEL_DTYPE


def make_ranking_dataset(
    num_queries: int = 43,
    avg_docs_per_query: int = 116,
    num_features: int = 136,
    seed: int = 0,
    label_grades: int = 5,
    noise: float = 0.35,
) -> Dataset:
    rng = np.random.default_rng(seed)
    counts = rng.integers(
        max(8, avg_docs_per_query // 3),
        avg_docs_per_query * 2,
        size=num_queries,
    )
    n = int(counts.sum())
    feats = rng.normal(size=(n, num_features)).astype(np.float64)

    # per-query shift on the informative features: relevance is driven by
    # the within-query contrast, as with real query-document features
    k = min(8, num_features)
    qid_of_doc = np.repeat(np.arange(num_queries), counts)
    qshift = rng.normal(scale=0.5, size=(num_queries, k))
    feats[:, :k] += qshift[qid_of_doc]

    # ground-truth utility: monotone + threshold interactions on the first
    # few features (wrapped when the feature space is tiny)
    c = lambda i: feats[:, i % num_features]  # noqa: E731
    u = (
        1.2 * c(0)
        + 0.9 * np.tanh(c(1))
        + 0.8 * (c(2) > 0.3) * c(3)
        + 0.6 * (c(4) > 0.0) * (c(5) > 0.0)
        + 0.4 * np.abs(c(6))
        - 0.5 * (c(7) < -0.5)
    )
    u = u + rng.normal(scale=noise * u.std(), size=n)

    # graded labels via skewed per-query quantiles
    labels = np.zeros(n, dtype=LABEL_DTYPE)
    qcuts = [0.55, 0.75, 0.88, 0.97]
    start = 0
    for q in range(num_queries):
        stop = start + counts[q]
        uq = u[start:stop]
        cuts = np.quantile(uq, qcuts)
        grade = np.searchsorted(cuts, uq, side="right")
        labels[start:stop] = np.minimum(grade, label_grades - 1)
        start = stop

    # a few redundant/correlated columns
    if num_features >= 10:
        feats[:, 8] = feats[:, 0] * 0.5 + rng.normal(scale=0.1, size=n)
        feats[:, 9] = np.where(feats[:, 1] > 0, 1.0, 0.0)

    qids = np.repeat(np.arange(1, num_queries + 1), counts)
    return Dataset.from_arrays(
        feats.astype(FEATURE_DTYPE), labels, qids, name=f"synthetic-{seed}"
    )


def make_train_valid_test(num_queries=(64, 24, 24), seed: int = 7, **kw):
    """Three disjoint splits drawn from the same generator process."""
    train = make_ranking_dataset(num_queries=num_queries[0], seed=seed, **kw)
    valid = make_ranking_dataset(num_queries=num_queries[1], seed=seed + 1, **kw)
    test = make_ranking_dataset(num_queries=num_queries[2], seed=seed + 2, **kw)
    return train, valid, test
