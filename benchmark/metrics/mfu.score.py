"""The whole scoring loop's share of the device's peak: the least time of
every batch of the measured window (K1's or K3's roofline) over the
window's wall time, in percent."""

from benchmark.metrics import _scoring


def read(ctx):
    w = ctx.window
    if not ctx.cuda or not w.get("batches"):
        return None
    return 100.0 * _scoring.batch_seconds(ctx) * w["batches"] / w["wall_s"]
