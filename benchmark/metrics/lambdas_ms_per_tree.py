"""Host milliseconds a tree of the lambda pass (the self time of the
program's ``qr.boost.lambdas`` spans: their length less what program spans
inside them cover), over the traced job's trees."""

from benchmark.metrics import _spans


def read(ctx):
    lam = _spans.spans(ctx, "qr.boost.lambdas")
    if not lam:
        return None
    children = _spans.inside(lam, _spans.spans(ctx))
    return _spans.per_tree_ms(ctx, _spans.total_ns(lam) - _spans.overlap_ns(lam, children))
