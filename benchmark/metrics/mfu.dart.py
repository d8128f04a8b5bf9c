"""The whole DART iteration's share of the device's peak: one iteration's
least work (``roofline/dart_step.py``: a boosting iteration's and the mean
dropped-set delta's over the window's iterations) over the measured
``s_per_tree``, in percent."""

from benchmark.roofline import dart_step


def read(ctx):
    w = ctx.window
    if not ctx.cuda or not w.get("trees") or "drop_counts" not in w:
        return None
    k = ctx.work
    least = dart_step.seconds(k["docs"], k["valid_docs"], k["features"], k["pairs"],
                              k["leaves"], w["drop_counts"])
    return 100.0 * least / (w["wall_s"] / w["trees"])
