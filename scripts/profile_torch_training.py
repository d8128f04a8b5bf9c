#!/usr/bin/env python3
"""Profile LambdaMART training of quickrank_tpu_torch on one CUDA card.

Trains on MSLR-shaped synthetic data (data/synthetic.py: query lengths in
[38, 232), 136 features) under ``torch.profiler`` and reports, for the
boosting iterations after the first ``--skip``: wall seconds per tree, the
device's busy and idle share (union of kernel intervals over the iteration
window), the ms of each iteration's gradients (lambdas; CUDA events around
the learner's ``_gradients``), and device time by kernel name.  One warm-up run
first builds the kernels.  ``--f32-query-sums`` sums the lambdas' pairs and
the metrics' per-query terms with ``torch.sum`` instead of
``metrics/core.py::query_sum``'s fixed-order kernel, to price the latter.

Run from the repository root:
    python scripts/profile_torch_training.py --queries 19000 --growth best
    python scripts/profile_torch_training.py --growth best --cluster on
    python scripts/profile_torch_training.py --f32-query-sums [--metric MAP@10]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def busy_share(events, windows):
    """Sum over ``windows`` of the union of the device's work intervals
    (kernels, copies, fills) inside each window, and the windows' total
    length (both in microseconds).  The device-side copies of
    ``record_function`` ranges and the profiler's own buffer requests are
    not work."""
    from torch.autograd import DeviceType

    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and e.name != "boost_iteration"
                     and not e.name.startswith("Activity Buffer"))
    busy = total = 0.0
    for w0, w1 in windows:
        total += w1 - w0
        cur0 = cur1 = None
        for a, b in kernels:
            a, b = max(a, w0), min(b, w1)
            if a >= b:
                continue
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            busy += cur1 - cur0
    return busy, total


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--queries", type=int, default=19000)
    p.add_argument("--growth", default="best",
                   choices=["best", "level", "bestk", "oblivious"],
                   help="grower; 'oblivious' trains ObliviousLambdaMart of depth 4")
    p.add_argument("--split-pack", type=int, default=4, help="splits a round for bestk")
    p.add_argument("--cluster", default="off", choices=["on", "off"],
                   help="best-first growth over the node-clustered work buffer")
    p.add_argument("--trees", type=int, default=6)
    p.add_argument("--skip", type=int, default=2, help="iterations left out of the window")
    p.add_argument("--trace", help="write a chrome trace here")
    p.add_argument("--metric", default="NDCG@10",
                   help="training metric (metric_factory's names; e.g. MAP@10 for the "
                        "[chunk, D, D] pair tensors, NDCG@10 for the banded ones)")
    p.add_argument("--f32-query-sums", action="store_true",
                   help="per-query sums by torch.sum, not query_sum's fixed-order kernel")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
    from quickrank_tpu_torch.learning.mart import Mart
    from quickrank_tpu_torch.metrics import core
    from quickrank_tpu_torch.metrics.metrics import metric_factory
    from quickrank_tpu_torch.trees import grow

    if args.f32_query_sums:
        core.query_sum = lambda x, dim=-1: torch.sum(x, dim=dim)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ds = make_ranking_dataset(num_queries=args.queries, seed=11)
    if args.growth == "oblivious":
        def make(ntrees):
            return ObliviousLambdaMart(ntrees=ntrees, treedepth=4, nthresholds=255, seed=1)
    else:
        def make(ntrees):
            return LambdaMart(ntrees=ntrees, nleaves=16, nthresholds=255, seed=1,
                              growth=args.growth, split_pack=args.split_pack,
                              cluster=args.cluster,
                              max_depth=4 if args.growth == "level" else 0)
    metric = metric_factory(args.metric)
    make(2).learn(ds, None, metric, verbose=False, device="cuda")

    windows = []
    step = Mart._step

    def timed_step(self, *a, **k):
        t0 = time.perf_counter()
        with torch.profiler.record_function("boost_iteration"):
            out = step(self, *a, **k)
            float(out[2])  # the host reads the metric each iteration
        windows.append((t0, time.perf_counter()))
        return out

    grad_events = []
    learner_cls = type(make(1))
    gradients = learner_cls._gradients

    def timed_gradients(self, *a, **k):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = gradients(self, *a, **k)
        ev[1].record()
        grad_events.append(ev)
        return out

    Mart._step = timed_step
    learner_cls._gradients = timed_gradients
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lm = make(args.trees)
        grow.HOST_SYNCS = 0
        lm.learn(ds, None, metric, verbose=False, device="cuda")
    Mart._step = step
    learner_cls._gradients = gradients
    torch.cuda.synchronize()
    gradient_ms = [round(a.elapsed_time(b), 4) for a, b in grad_events[args.skip:]]
    events = prof.events()
    marks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "boost_iteration")
    steady = marks[args.skip:]
    busy, total = busy_share(events, steady)
    splits = (~lm.ensemble.is_leaf).sum(dim=1).tolist()
    per_tree = [round(b - a, 6) for a, b in windows[args.skip:]]
    print(card)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "growth": args.growth, "cluster": args.cluster, "docs": ds.num_docs,
        "metric": args.metric,
        "query_sums": "torch.sum" if args.f32_query_sums else "query_sum (fixed-order kernel)",
        "gradient_ms": gradient_ms,
        "queries": ds.num_queries,
        "seconds_per_tree": per_tree, "splits_per_tree": splits,
        "host_syncs_per_tree": grow.HOST_SYNCS / args.trees,
        "device_busy_share": busy / total if total else None,
        "device_idle_share": 1 - busy / total if total else None,
        "window_us": total, "busy_us": busy, "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
