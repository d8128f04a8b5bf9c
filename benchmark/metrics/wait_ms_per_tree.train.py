"""Host milliseconds a tree blocked on the card's results: the total length
of the program's ``*.readback`` spans (each split decision, each
iteration's metrics), over the traced job's trees."""

from benchmark.metrics import _spans


def read(ctx):
    if not _spans.spans(ctx, "qr.boost.iter"):
        return None
    return _spans.per_tree_ms(ctx, _spans.total_ns(_spans.spans(ctx, suffix=".readback")))
