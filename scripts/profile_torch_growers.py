#!/usr/bin/env python3
"""Seconds per tree of every grower of quickrank_tpu_torch on one CUDA card,
and the time of one plain-histogram (K5) call, for comparing two checkouts of
the repository in one call on one card.

Trains LambdaMART (level-wise depth 4, best-k with split_pack 4, best-first;
16 leaves) and ObliviousLambdaMART (depth 4) on MSLR-shaped synthetic data
(data/synthetic.py: query lengths in [38, 232), 136 features, 255
thresholds) with no profiler and no valid fold, and prints the host-clock
seconds of every boosting iteration and their median from the third on.
Then K5 as a tree's leaf values call it (``kernel_histogram.histogram`` on
2,558,976 docs, 32 slots, 2 channels): ms a call between CUDA events over 200
calls, the host's time to enqueue a call, and the device time of each of its
kernels from ``torch.profiler`` (the call is four small launches, so on a slow
host the first figure is the second).  ``--repo`` names the checkout whose package is imported, so the same script
times a parent commit unpacked beside the working tree:

    python scripts/profile_torch_growers.py --repo build/parent
    python scripts/profile_torch_growers.py
    python scripts/profile_torch_growers.py
    python scripts/profile_torch_growers.py --repo build/parent

Hosts differ by tens of percent in the time they take to launch a tree's
kernels, so only runs of one call compare.

``--save FILE`` writes each grower's ensemble tensors; ``--against FILE``
holds them bit for bit against a file that another checkout's run saved,
and exits 1 where any differs:

    python scripts/profile_torch_growers.py --repo build/parent --trees 100 --save p.pt
    python scripts/profile_torch_growers.py --trees 100 --against p.pt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys


def main() -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser()
    p.add_argument("--repo", default=here, help="checkout to import the package from")
    p.add_argument("--queries", type=int, default=19000)
    p.add_argument("--trees", type=int, default=8)
    p.add_argument("--growers", default="level@255,oblivious@255,bestk@255,best@255",
                   help="comma-separated growers to train; '' for K5 alone")
    p.add_argument("--save", default="", help="write each grower's ensemble tensors here")
    p.add_argument("--against", default="",
                   help="hold each grower's ensemble bit for bit against this --save file")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_growers: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.ops import kernel_histogram

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ds = make_ranking_dataset(num_queries=args.queries, seed=11)
    kw = dict(ntrees=args.trees, nthresholds=255, seed=1)
    growers = {
        "level@255": lambda: LambdaMart(nleaves=16, growth="level", max_depth=4, **kw),
        "oblivious@255": lambda: ObliviousLambdaMart(treedepth=4, **kw),
        "bestk@255": lambda: LambdaMart(nleaves=16, growth="bestk", split_pack=4, **kw),
        "best@255": lambda: LambdaMart(nleaves=16, growth="best", **kw),
    }
    report = {"repo": os.path.abspath(args.repo), "card": card, "docs": ds.num_docs,
              "queries": ds.num_queries, "growers": {}}
    wanted = [g for g in args.growers.split(",") if g]
    trees = {}
    for name, make in growers.items():
        if name not in wanted:
            continue
        for counter in kernel_histogram.LAUNCHES:
            kernel_histogram.LAUNCHES[counter] = 0
        model = make()
        hist = model.learn(ds, None, Ndcg(10), verbose=False, device="cuda")
        ens = model.ensemble
        trees[name] = {f.name: getattr(ens, f.name).cpu() for f in dataclasses.fields(ens)
                       if isinstance(getattr(ens, f.name), torch.Tensor)}
        it = [round(s, 6) for s in hist["iter_seconds"]]
        report["growers"][name] = {
            "seconds_per_tree": statistics.median(it[2:]), "iterations": it,
            "k4_launches_per_tree": kernel_histogram.LAUNCHES["node_histogram"] / len(it),
        }
        print(f"{name}: {report['growers'][name]['seconds_per_tree']:.4f} s/tree "
              f"(median of iterations 2+; all: {it})")
    report["k5"] = time_k5(torch, kernel_histogram)
    print(f"K5: {report['k5']}")
    if args.save:
        torch.save(trees, args.save)
    same = True
    if args.against:
        other = torch.load(args.against)
        for name, tensors in trees.items():
            theirs = other.get(name, {})
            diff = [k for k, v in tensors.items()  # bit for bit: dtype, shape and bytes
                    if k not in theirs or v.dtype != theirs[k].dtype
                    or v.shape != theirs[k].shape
                    or v.numpy().tobytes() != theirs[k].numpy().tobytes()]
            report["growers"][name]["bitwise_against"] = not diff
            same = same and not diff
            print(f"{name}: {len(tensors)} ensemble tensors against {args.against}: "
                  + ("equal bit for bit" if not diff else f"differ in {diff}"))
    print(json.dumps(report))
    return 0 if same else 1


def time_k5(torch, kernel_histogram, n=2558976, reps=200):
    """ms a call of K5 between CUDA events, the host's ms to enqueue a call,
    and each of its kernels' device microseconds a launch."""
    import time

    gen = torch.Generator().manual_seed(5)
    slots = torch.randint(0, 32, (n, 1), generator=gen, dtype=torch.int32).cuda()
    vals = torch.stack([torch.randn(n, generator=gen), torch.rand(n, generator=gen)],
                       dim=-1).contiguous().cuda()
    for _ in range(5):
        kernel_histogram.histogram(slots, vals, 32)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kernel_histogram.histogram(slots, vals, 32)
    stop.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kernel_histogram.histogram(slots, vals, 32)
    enqueue = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            kernel_histogram.histogram(slots, vals, 32)
        torch.cuda.synchronize()
    kernels = {e.key[:64]: round(e.device_time_total / e.count, 2)
               for e in prof.key_averages() if e.device_time_total > 0}
    return {"events_ms_per_call": round(start.elapsed_time(stop) / reps, 4),
            "host_enqueue_ms_per_call": round(enqueue, 4), "device_us_per_launch": kernels}


if __name__ == "__main__":
    sys.exit(main())
