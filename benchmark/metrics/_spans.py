"""What the span readers share: the program's spans (``qr.*``, opened by
``quickrank_tpu_torch/utils/profiling.py::span``) among the host events of
the traced stretch, on the profiler's clock, and the interval sums over
them.  A program without spans gives empty lists, and its readers ``None``."""

PREFIX = "qr."


def spans(ctx, name: str = "", suffix: str = ""):
    """The program's spans ``(start_ns, end_ns, name)`` in start order: those
    named ``name``, or whose name ends in ``suffix``, or all of them."""
    if ctx.trace is None:
        return []
    return [c for c in ctx.trace.cpu if c[2].startswith(PREFIX)
            and (not name or c[2] == name) and c[2].endswith(suffix)]


def total_ns(intervals) -> int:
    return sum(iv[1] - iv[0] for iv in intervals)


def union(intervals):
    """The union of intervals ``(start, end, ...)`` as disjoint ``[start,
    end]`` pairs in order."""
    out = []
    for iv in sorted(intervals):
        s, e = iv[0], iv[1]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_ns(a, b) -> int:
    """Length of the intersection of the unions of ``a`` and ``b``."""
    a, b = union(a), union(b)
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def inside(outer, intervals):
    """Those of ``intervals`` that lie within one interval of ``outer``
    (``outer``'s own members left out)."""
    own = {tuple(o) for o in outer}
    return [iv for iv in intervals if tuple(iv) not in own
            and any(o[0] <= iv[0] and iv[1] <= o[1] for o in outer)]


def per_tree_ms(ctx, ns):
    """``ns`` nanoseconds over the traced job's trees, in milliseconds; None
    without spans to read or trees to count."""
    trees = (ctx.traced or {}).get("trees")
    return ns * 1e-6 / trees if trees and ns is not None else None
