"""A traced stretch of a run, reduced to what the per-layer readers need.

``capture`` runs a function under ``torch.profiler`` (host operators and the
card's kernels and copies) inside a ``bench.window`` span, and ``Trace``
reads the profiler's events in memory: the window's length, the union of
device intervals in it (busy time), device time by kernel name, and the idle
gaps, each named by the innermost host operation open at its middle.
Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

WINDOW = "bench.window"


def _ns(ev, attr):
    fn = getattr(ev, attr + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, attr + "_us")() * 1000)


class Trace:
    def __init__(self, events):
        cpu, dev, window = [], [], None
        for ev in events:
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            name = ev.name()
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if str(ev.device_type()).endswith("CUDA"):
                # a span's copy on the device timeline is no device work
                if not annotation and name != WINDOW:
                    dev.append((start, end, name))
            elif name == WINDOW:
                window = (start, end)
            else:
                cpu.append((start, end, name))
        if window is None:
            raise RuntimeError("the trace holds no bench.window span")
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.device = sorted((max(s, self.t0), min(e, self.t1), n) for s, e, n in dev
                             if e > self.t0 and s < self.t1)
        self.cpu = sorted(cpu)
        self._cpu_starts = [c[0] for c in self.cpu]
        self.busy, self.gaps = self._union()
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-9

    def _union(self):
        busy = []
        for s, e, _ in self.device:
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        return busy, gaps

    def kernels(self, pattern: str):
        """Device intervals ``(start_ns, end_ns, name)`` whose name matches
        the regular expression ``pattern``, in start order."""
        rx = re.compile(pattern)
        return [d for d in self.device if rx.search(d[2])]

    def kernel_seconds(self, pattern: str) -> float:
        return sum(e - s for s, e, _ in self.kernels(pattern)) * 1e-9

    def host_at(self, t: int) -> str:
        """The innermost host operation open at ``t`` (the latest-starting
        one that contains it)."""
        i = bisect.bisect_right(self._cpu_starts, t)
        for j in range(i - 1, max(i - 400, 0) - 1, -1):
            s, e, name = self.cpu[j]
            if e >= t:
                return name
        return "host (no operation)"

    def device_ops(self, top: int = 10):
        by = defaultdict(int)
        for s, e, name in self.device:
            by[_short(name)] += e - s
        return [[n, v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        by = defaultdict(int)
        for s, e in self.gaps:
            by[_short(self.host_at((s + e) // 2))] += e - s
        return [[n, v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _short(name: str, limit: int = 96) -> str:
    """A kernel's or operator's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")") and "(" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0 and name[i - 1] not in " (":
                    name = name[:i]
                break
    return name[:limit]


def capture(fn):
    """Run ``fn()`` under the profiler; returns ``(fn's result, Trace)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, Trace(prof.profiler.kineto_results.events())
