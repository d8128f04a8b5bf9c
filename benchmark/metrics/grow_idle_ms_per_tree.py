"""Milliseconds a tree in which the device sat idle while the grower ran:
the overlap of the traced stretch's idle gaps (no kernel and no copy on the
device) with the program's ``qr.grow`` spans, over the traced job's
trees."""

from benchmark.metrics import _spans


def read(ctx):
    grow = _spans.spans(ctx, "qr.grow")
    if not grow:
        return None
    return _spans.per_tree_ms(ctx, _spans.overlap_ns(ctx.trace.gaps, grow))
