"""K1, the QuickScorer (``csrc/qs_score.cu``), one batch: the float32
features read once, the scores written once, each tree's nodes ({feature,
threshold} a split) and leaf values read once; ``N * sum_t(mean leaf depth
of t + 4)`` operations (a compare a level, and the bit-vector AND, leaf
lookup and add of QuickScorer's exit)."""

from benchmark.roofline import least_seconds


def seconds(rows: int, features: int, trees: int, leaves: int, mean_leaf_depth) -> float:
    tables = trees * ((leaves - 1) * 8 + leaves * 4)
    ops = rows * float(sum(d + 4 for d in mean_leaf_depth))
    return least_seconds(rows * features * 4 + rows * 4 + tables, ops)
