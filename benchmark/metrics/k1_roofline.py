"""K1's share of its roofline in the traced stretch: one batch's least
time (``roofline/k1.py``) over K1's mean device time a launch."""

from benchmark.metrics import _scoring


def read(ctx):
    ks = _scoring.launches(ctx, "k1")
    if not ks:
        return None
    took = sum(e - s for s, e, _ in ks) * 1e-9 / len(ks)
    return 100.0 * _scoring.batch_seconds(ctx) / took
