"""K4, the node histogram (``csrc/histogram.cu``), one pass of an oblivious
level over every doc: each doc's u8 bin id of each real feature read once,
its node id (from the second level on) and its ``channels`` float32 values
read once, and the int64 sums of every (node, real feature, bin, channel)
written once; one add a doc, feature and channel."""

from benchmark.roofline import least_seconds


def seconds(docs: int, features: int, bins: int, nodes: int, channels: int = 2) -> float:
    read = docs * features + docs * channels * 4 + (docs * 4 if nodes > 1 else 0)
    written = nodes * features * bins * channels * 8
    return least_seconds(read + written, docs * features * channels)


def tree_seconds(docs: int, features: int, bins: int, depth: int, channels: int = 2) -> float:
    """The K4 passes of one oblivious tree: a pass a level, over 2^level nodes."""
    return sum(seconds(docs, features, bins, 2 ** d, channels) for d in range(depth))
