"""K4's share of its roofline in the traced oblivious job: the least time
of the K4 passes (a pass a level over every doc, ``roofline/k4.py``) over
their device time.  K4's passes read the u8 wire, so they are the
``histogram_kernel`` launches on ``unsigned char`` ids (K5's leaf sums read
int32 slot ids); the wide-bin path is not taken at 256 bins."""

from benchmark.roofline import k4

PASSES = r"histogram_kernel<unsigned char"


def read(ctx):
    if ctx.trace is None or not ctx.traced.get("trees") or not ctx.work.get("depth"):
        return None
    took = ctx.trace.kernel_seconds(PASSES)
    if took <= 0:
        return None
    w = ctx.work
    least = k4.tree_seconds(w["docs"], w["features"], w["bins"], w["depth"]) * ctx.traced["trees"]
    return 100.0 * least / took
