"""The share of their roofline of the traced DART job's K1 launches on the
u8 wire (the dropped-set deltas and the full rescores): their least time
(``roofline/k1_delta.py``, from each launch's trees and docs, counted from
the job's history) over their device time."""

from benchmark.roofline import k1_delta

LAUNCHES = r"qs_score(_wide)?_kernel<unsigned char, \w+, false>"


def read(ctx):
    t = ctx.traced or {}
    if ctx.trace is None or "drop_counts" not in t:
        return None
    took = ctx.trace.kernel_seconds(LAUNCHES)
    if took <= 0:
        return None
    w = ctx.work
    least = k1_delta.job_seconds(w["docs"], w["valid_docs"], w["features"], w["leaves"],
                                 t["drop_counts"], t["rescored"])
    return 100.0 * least / took
