"""What the scoring readers share: the scoring kernels' launches in the
trace and one batch's least time (``roofline/k1.py``, ``roofline/k3.py``)."""

from benchmark.roofline import k1, k3

KERNELS = {"k3": r"oblivious_(depth|deep)_kernel", "k1": r"qs_score(_wide)?_kernel"}


def launches(ctx, kernel=None):
    pattern = KERNELS[kernel] if kernel else "|".join(KERNELS.values())
    return ctx.trace.kernels(pattern) if ctx.trace is not None else []


def batch_seconds(ctx) -> float:
    w = ctx.work
    if "depth" in w:
        return k3.seconds(w["rows"], w["features"], w["trees"], w["depth"])
    return k1.seconds(w["rows"], w["features"], w["trees"], w["leaves"], w["mean_leaf_depth"])
