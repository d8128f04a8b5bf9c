"""Seconds of a ``learn`` job from its entry to its first boosting
iteration (the program's ``qr.learn.init`` span: the valid fold's binning
and upload, the ensemble's allocation), over the traced jobs."""

from benchmark.metrics import _spans


def read(ctx):
    init = _spans.spans(ctx, "qr.learn.init")
    return _spans.total_ns(init) * 1e-9 / len(init) if init else None
