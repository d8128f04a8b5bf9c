"""One boosting iteration's least work, the same whatever grows the tree:
one lambda pass over every query's doc pairs (scores, labels and the two
outputs moved once, ``PAIR_OPS`` operations a pair) and ``log2(leaves)``
full histogram passes (each doc's u8 bin id of each real feature and its
three float32 channels read once)."""

import math

from benchmark.roofline import least_seconds

#: a pair's score difference, exponential, sigmoid, swap delta and the two
#: lambda and weight updates
PAIR_OPS = 12


def seconds(docs: int, features: int, pairs: int, leaves: int, channels: int = 3) -> float:
    passes = math.ceil(math.log2(leaves))
    moved = docs * 4 * 4 + passes * (docs * features + docs * channels * 4)
    ops = pairs * PAIR_OPS + passes * docs * features * channels
    return least_seconds(moved, ops)
