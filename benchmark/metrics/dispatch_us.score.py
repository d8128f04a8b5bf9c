"""The median host time, in microseconds, of one call of the program's
scorer (its ``qr.score.dispatch`` span: the input checks and the launch)
over the traced batches."""

import numpy as np

from benchmark.metrics import _spans


def read(ctx):
    calls = _spans.spans(ctx, "qr.score.dispatch")
    return float(np.median([(e - s) * 1e-3 for s, e, _ in calls])) if calls else None
