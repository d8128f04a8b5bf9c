"""K1's bin-space entry (``csrc/qs_score.cu``, ``qs_score_kernel<unsigned
char>``) as DART launches it: one launch scores ``rows`` docs of the u8
wire over ``trees`` trees (a dropped set, or the live model in a full
rescore).  Each doc's u8 bin id of each real feature read once, its score
written once, each tree's nodes ({feature, threshold} a split) and leaf
values read once; ``rows * trees * (log2(leaves) + 4)`` operations: the
least mean leaf depth of a tree of ``leaves`` leaves (the dropped trees are
not kept to measure theirs) and QuickScorer's exit, as ``k1.py`` counts
it."""

import math

from benchmark.roofline import least_seconds


def seconds(rows: int, features: int, trees: int, leaves: int) -> float:
    tables = trees * ((leaves - 1) * 8 + leaves * 4)
    ops = rows * trees * (math.log2(leaves) + 4)
    return least_seconds(rows * features + rows * 4 + tables, ops)


def delta_seconds(docs: int, valid_docs: int, features: int, leaves: int, trees: int) -> float:
    """One iteration's dropped-set delta over ``trees`` trees: a launch on
    each fold; none without a drop."""
    if trees <= 0:
        return 0.0
    return seconds(docs, features, trees, leaves) + seconds(valid_docs, features, trees, leaves)


def job_seconds(docs: int, valid_docs: int, features: int, leaves: int, drop_counts,
                rescored) -> float:
    """A job's launches: each iteration's delta over its ``drop_counts``
    trees, and a full rescore of both folds at each iteration ``m`` of
    ``rescored`` (1-based), over its ``m`` live trees."""
    return (sum(delta_seconds(docs, valid_docs, features, leaves, k) for k in drop_counts)
            + sum(delta_seconds(docs, valid_docs, features, leaves, m) for m in rescored))
