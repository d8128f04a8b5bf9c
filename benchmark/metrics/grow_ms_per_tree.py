"""Host milliseconds a tree of the grower's own work: the program's
``qr.grow`` spans less the part their ``qr.grow.readback`` spans (the host
waiting for a split decision) cover, over the traced job's trees."""

from benchmark.metrics import _spans


def read(ctx):
    grow = _spans.spans(ctx, "qr.grow")
    if not grow:
        return None
    waits = _spans.spans(ctx, "qr.grow.readback")
    return _spans.per_tree_ms(ctx, _spans.total_ns(grow) - _spans.overlap_ns(grow, waits))
