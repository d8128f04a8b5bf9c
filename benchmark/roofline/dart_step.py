"""One DART iteration's least work: a boosting iteration's
(``train_step.py``: the lambda pass and the histogram passes) and the mean
over the iterations of the dropped-set delta's (``k1_delta.py``: K1's
bin-space entry over the dropped trees, on the train and the valid fold)."""

from benchmark.roofline import k1_delta, train_step


def seconds(docs: int, valid_docs: int, features: int, pairs: int, leaves: int,
            drop_counts: dict) -> float:
    """``drop_counts`` maps a number of dropped trees to the iterations
    that dropped that many."""
    iterations = sum(drop_counts.values())
    delta = sum(n * k1_delta.delta_seconds(docs, valid_docs, features, leaves, k)
                for k, n in drop_counts.items())
    return train_step.seconds(docs, features, pairs, leaves) + delta / max(iterations, 1)
