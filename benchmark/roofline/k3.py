"""K3, the oblivious bit-OR scorer (``csrc/oblivious_score.cu``), one batch:
the float32 features read once, the scores written once, the level tables
(D {feature, threshold} pairs and 2^D leaf values a tree) read once; ``N *
T * (D + 1)`` operations (D compares and one leaf add a tree and doc)."""

from benchmark.roofline import least_seconds


def seconds(rows: int, features: int, trees: int, depth: int) -> float:
    tables = trees * (depth * 8 + (2 ** depth) * 4)
    return least_seconds(rows * features * 4 + rows * 4 + tables, rows * trees * (depth + 1))
