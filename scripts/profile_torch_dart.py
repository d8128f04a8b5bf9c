#!/usr/bin/env python3
"""Profile DART training of quickrank_tpu_torch on one CUDA card.

Trains DART (LambdaMART with tree dropout) on MSLR-shaped synthetic data
(data/synthetic.py: query lengths in [38, 232), 136 features) with a valid
fold, under ``torch.profiler``, and reports for the iterations after the
first ``--skip``: wall seconds per iteration, the device's busy and idle
share over those iterations and device time by kernel (a run under the
profiler), and the time of the iteration's sections (the tree fit, the
dropped-set delta, the metric evaluations, the packed table's append, the
periodic rescore) per iteration, each ended by a synchronize (a second run,
without the profiler).  One short warm-up run first builds the kernels.

Run from the repository root:
    python scripts/profile_torch_dart.py --queries 19000 --trees 40
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time


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
    from quickrank_tpu_torch.learning import dart as dart_mod
    from quickrank_tpu_torch.metrics import Ndcg

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    train = make_ranking_dataset(num_queries=args.queries, seed=11)
    valid = make_ranking_dataset(num_queries=args.valid_queries, seed=12)

    def make(ntrees):
        return dart_mod.Dart(ntrees=ntrees, nleaves=16, nthresholds=255, seed=1, esr=0,
                             rate_drop=args.rate_drop, sample_type=args.sample_type,
                             normalize_type=args.normalize_type)

    make(3).learn(train, valid, Ndcg(10), verbose=False, device="cuda")

    # sections: seconds of each call by iteration; an iteration opens at its
    # dropout count, the first host step of the loop
    host = {}
    state = {"range": None, "m": -1, "sync": False}

    def section(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **k)
                if state["sync"]:
                    torch.cuda.synchronize()
            host.setdefault(name, {}).setdefault(state["m"], 0.0)
            host[name][state["m"]] += time.perf_counter() - t0
            return out
        return wrapped

    count = dart_mod.Dart._trees_to_dropout

    def open_iteration(self, *a, **k):
        if state["range"] is not None:
            state["range"].__exit__(None, None, None)
        state["m"] += 1
        state["range"] = torch.profiler.record_function("dart_iteration")
        state["range"].__enter__()
        return count(self, *a, **k)

    patched = {
        (dart_mod.Dart, "_trees_to_dropout"): open_iteration,
        (dart_mod.Dart, "_fit"): section("fit", dart_mod.Dart._fit),
        (dart_mod.DropTable, "delta"): section("delta", dart_mod.DropTable.delta),
        (dart_mod.DropTable, "append"): section("table_append", dart_mod.DropTable.append),
        (dart_mod, "eval_metric"): section("eval_metric", dart_mod.eval_metric),
        (dart_mod, "rescore_binned"): section("rescore", dart_mod.rescore_binned),
    }
    saved = {key: getattr(*key) for key in patched}

    def run(profile: bool):
        state.update(range=None, m=-1, sync=not profile)
        host.clear()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ctx = torch.profiler.profile(activities=acts) if profile else contextlib.nullcontext()
        for (obj, name), fn in patched.items():
            setattr(obj, name, fn)
        try:
            with ctx as prof:
                hist = make(args.trees).learn(train, valid, Ndcg(10), verbose=False,
                                              device="cuda")
                if state["range"] is not None:
                    state["range"].__exit__(None, None, None)
                torch.cuda.synchronize()
        finally:
            for (obj, name), fn in saved.items():
                setattr(obj, name, fn)
        return prof, hist

    prof, hist = run(profile=True)
    _, synced = run(profile=False)
    events = prof.events()
    # the host's ranges (the profiler also copies annotations to the device)
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == "dart_iteration" and e.device_type == DeviceType.CPU)
    steady = ranges[args.skip:]
    busy, total = busy_share(events, steady)
    iters = range(args.skip, args.trees)
    per_section = {name: sum(v.get(m, 0.0) for m in iters) / len(iters) * 1e3
                   for name, v in host.items()}
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and any(k in e.key for k in ("qs_score", "histogram", "absmax", "to_float")):
            kernels[e.key[:60]] = {"count": e.count, "device_ms_total": t / 1e3}
    print(card)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    it = hist["iter_seconds"][args.skip:]
    it_synced = synced["iter_seconds"][args.skip:]
    print(json.dumps({
        "docs": train.num_docs, "queries": train.num_queries, "trees": args.trees,
        "rate_drop": args.rate_drop, "sample_type": args.sample_type,
        "normalize_type": args.normalize_type,
        "seconds_per_iteration": [round(x, 6) for x in it],
        "median_seconds_per_iteration": sorted(it)[len(it) // 2],
        "dropped_per_iteration": hist["dropped_per_iter"][args.skip:],
        "delta_ms": [round(x, 4) for x in hist["delta_ms"][-len(it):]],
        "synchronized_median_seconds_per_iteration": sorted(it_synced)[len(it_synced) // 2],
        "synchronized_ms_per_iteration_by_section": per_section,
        "device_busy_share": busy / total if total else None,
        "device_idle_share": 1 - busy / total if total else None,
        "window_us": total, "busy_us": busy, "windows": len(steady), "kernels": kernels,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
