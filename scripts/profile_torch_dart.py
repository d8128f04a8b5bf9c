#!/usr/bin/env python3
"""Profile DART training of quickrank_tpu_torch on one CUDA card.

Trains DART (LambdaMART with tree dropout) on MSLR-shaped synthetic data
(data/synthetic.py: query lengths in [38, 232), 136 features) with a valid
fold, under ``torch.profiler``, and reports for the iterations after the
first ``--skip``: wall seconds per iteration, the device's busy and idle
share over the program's ``qr.boost.iter`` spans, device time by kernel,
and the host ms an iteration of each of the program's spans inside the
iteration (self time: less the program spans inside it), such as
``qr.dart.drop`` (the dropout draws and the delta's launches),
``qr.boost.lambdas``, ``qr.grow``, ``qr.dart.restore``, ``qr.boost.metrics``,
``qr.boost.readback`` and ``qr.dart.rescore``.  One short warm-up run first
builds the kernels.

Run from the repository root:
    python scripts/profile_torch_dart.py --queries 19000 --trees 40
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--queries", type=int, default=19000)
    p.add_argument("--valid-queries", type=int, default=2000)
    p.add_argument("--trees", type=int, default=40)
    p.add_argument("--skip", type=int, default=10, help="iterations left out of the window")
    p.add_argument("--rate-drop", type=float, default=0.1)
    p.add_argument("--sample-type", default="UNIFORM")
    p.add_argument("--normalize-type", default="TREE")
    p.add_argument("--trace", help="write a chrome trace here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_dart: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "scripts"))
    from profile_torch_training import busy_share
    from torch.autograd import DeviceType

    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning.dart import Dart
    from quickrank_tpu_torch.metrics import Ndcg

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    train = make_ranking_dataset(num_queries=args.queries, seed=11)
    valid = make_ranking_dataset(num_queries=args.valid_queries, seed=12)

    def make(ntrees):
        return Dart(ntrees=ntrees, nleaves=16, nthresholds=255, seed=1, esr=0,
                    rate_drop=args.rate_drop, sample_type=args.sample_type,
                    normalize_type=args.normalize_type)

    make(3).learn(train, valid, Ndcg(10), verbose=False, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        hist = make(args.trees).learn(train, valid, Ndcg(10), verbose=False, device="cuda")
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.name.startswith("qr.") and e.device_type == DeviceType.CPU)
    steady = [(s, e) for s, e, n in spans if n == "qr.boost.iter"][args.skip:]
    busy, total = busy_share(events, steady)
    # each span's self time: its length less that of the spans directly inside
    # it (spans nest: a stack in start order finds each one's parent)
    per_section: dict = {}
    stack: list = []
    for s0, s1, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s0:
            stack.pop()
        inside = any(w0 <= s0 and s1 <= w1 for w0, w1 in steady)
        if stack and stack[-1][3]:
            per_section[stack[-1][2]] -= s1 - s0
        if inside and n != "qr.boost.iter":
            per_section[n] = per_section.get(n, 0.0) + s1 - s0
        stack.append((s0, s1, n, inside and n != "qr.boost.iter"))
    per_section = {n: v / 1e3 / max(len(steady), 1) for n, v in sorted(per_section.items())}
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and any(k in e.key for k in ("qs_score", "histogram", "split_scan", "node_stats")):
            kernels[e.key[:60]] = {"count": e.count, "device_ms_total": t / 1e3}
    print(card)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    it = hist["iter_seconds"][args.skip:]
    print(json.dumps({
        "docs": train.num_docs, "queries": train.num_queries, "trees": args.trees,
        "rate_drop": args.rate_drop, "sample_type": args.sample_type,
        "normalize_type": args.normalize_type,
        "seconds_per_iteration": [round(x, 6) for x in it],
        "median_seconds_per_iteration": sorted(it)[len(it) // 2],
        "dropped_per_iteration": hist["dropped_per_iter"][args.skip:],
        "delta_ms": [round(x, 4) for x in hist["delta_ms"][-len(it):]],
        "host_ms_per_iteration_by_span": per_section,
        "rescored": hist["rescored"],
        "device_busy_share": busy / total if total else None,
        "device_idle_share": 1 - busy / total if total else None,
        "window_us": total, "busy_us": busy, "windows": len(steady), "kernels": kernels,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
