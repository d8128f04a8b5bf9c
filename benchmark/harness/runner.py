"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check, and the result line's fields.

``run`` takes the device to drive; ``benchmark/run.py`` gives it the card
after checking there is one.  On the CPU (the tests) the program runs its
plain versions, and the result carries no device-sourced metric: none is
read from a CPU run.
"""

from __future__ import annotations

import os
import sys
import time
import types

import torch

from benchmark.harness import cell as cells
from benchmark.harness.trace import capture
from benchmark.harness.train_jobs import CheckError

_T_IMPORT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (from /proc; else since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def log(*parts):
    print("#", *parts, file=sys.stderr, flush=True)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    """The result line's fields (``checks`` last) of one run of ``cell``."""
    cuda = torch.device(device).type == "cuda"
    loop = cell.loop(seed, device)
    loop.setup()
    setup_s = process_age()
    log("setup", loop.setup_info, f"setup_s {setup_s!r}")
    win = loop.window(seconds)
    log("window", {k: v for k, v in win.items() if k != "batch_ms"})
    traced, tr = None, None
    if trace:
        traced, tr = capture(loop.traced)
        if not cuda:
            tr = None  # a CPU trace holds no device time
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = types.SimpleNamespace(config=cell.config, traffic=cell.traffic,
                                setup=dict(loop.setup_info, setup_s=setup_s), window=win,
                                trace=tr, traced=traced, work=loop.work(), cuda=cuda)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        if m["source"] == "device_trace" and not cuda:
            continue
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    loop.release()
    t = time.perf_counter()
    try:
        numbers = loop.check()
        error = None
    except CheckError as e:
        numbers, error = {k: float("inf") for k in cell.limits}, str(e)
    log("check", f"{time.perf_counter() - t:.3f} s")
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    correct = error is None and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    if error:
        log("check failed:", error)
    result["checks"] = checks
    return result
