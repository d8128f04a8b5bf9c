"""The median device gap, in microseconds, between consecutive scoring
kernels (K1 or K3) in the traced stretch: the copy of the scores and the
host's dispatch between one batch's kernel and the next."""

import numpy as np

from benchmark.metrics import _scoring


def read(ctx):
    ks = _scoring.launches(ctx)
    if len(ks) < 2:
        return None
    return float(np.median([(b[0] - a[1]) * 1e-3 for a, b in zip(ks, ks[1:])]))
