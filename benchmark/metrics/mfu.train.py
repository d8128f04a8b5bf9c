"""The whole boosting iteration's share of the device's peak: one tree's
least work (``roofline/train_step.py``: the lambda pass over every doc pair
and log2(leaves) full histogram passes, fixed by the shapes) over the
measured ``s_per_tree``, in percent."""

from benchmark.roofline import train_step


def read(ctx):
    w = ctx.window
    if not ctx.cuda or not w.get("trees"):
        return None
    k = ctx.work
    least = train_step.seconds(k["docs"], k["features"], k["pairs"], k["leaves"])
    return 100.0 * least / (w["wall_s"] / w["trees"])
