#!/usr/bin/env python3
"""Where one best-first tree's time goes on one CUDA card, section by section,
for the dataset-order grower (``trees/grow.py::fit_tree``) and the
node-clustered one (``trees/grow_cluster.py::fit_tree_clustered``).

Grows trees on MSLR-shaped synthetic data (data/synthetic.py: query lengths in
[38, 232), 136 features, 255 thresholds, 16 leaves) with pseudoresponses made
from a seed.  First each grower's seconds per tree as it runs (host clock
around a tree that ends in a synchronize).  Then the same trees with a
``torch.cuda.synchronize()`` before and after every call of a section's
function, so that a section's time is its host time plus its device time and
the sections add up; "rest" is what the grower does outside them (for the
clustered grower mostly the partition directives).  The synchronized total is
larger than the free-running one, where the device works while the host
launches.

Run from the repository root:
    python scripts/profile_torch_sections.py --queries 19000
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

SECTIONS = ("build_work_buffer", "_channels", "masked_histogram_t", "partition_rows",
            "descend_tree_binned", "_best_split", "set_deviance", "_finish_tree")


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--queries", type=int, default=19000)
    p.add_argument("--trees", type=int, default=5, help="trees timed per grower")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_sections: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.trees import grow, grow_cluster

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    td = TrainData.build(make_ranking_dataset(num_queries=args.queries, seed=11), 255)
    binned, mask = td.step.binned, td.step.doc_mask
    gen = torch.Generator().manual_seed(0)
    grad = (torch.randn(binned.shape[0], generator=gen) * 0.1).to(dev) + td.step.labels * 0.3
    thr = torch.from_numpy(td.thresholds)
    cfg = grow.GrowConfig(nleaves=16, num_bins=td.num_bins,
                          num_real_features=td.num_real_features)
    growers = {"dataset order": (grow, grow.fit_tree),
               "clustered": (grow_cluster, grow_cluster.fit_tree_clustered)}

    def trees(fit, n):
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fit(binned, grad, mask, thr, cfg)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    report = {"card": card, "docs": int(binned.shape[0]), "queries": args.queries}
    for name, (_, fit) in growers.items():
        trees(fit, 2)  # warm-up: builds the kernels
        report[name] = {"free_running_s_per_tree": [round(t, 6) for t in trees(fit, args.trees)]}

    acc, calls = collections.defaultdict(float), collections.Counter()

    def synced(fn, label):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[label] += time.perf_counter() - t0
            calls[label] += 1
            return out
        return wrapper

    for name, (module, fit) in growers.items():
        saved = {s: getattr(module, s) for s in SECTIONS if hasattr(module, s)}
        for s, fn in saved.items():
            setattr(module, s, synced(fn, s))
        try:
            acc.clear()
            calls.clear()
            total = sum(trees(fit, args.trees)) / args.trees
        finally:
            for s, fn in saved.items():
                setattr(module, s, fn)
        sections = {s: {"ms_per_tree": round(acc[s] / args.trees * 1e3, 3),
                        "calls_per_tree": calls[s] / args.trees} for s in acc}
        sections["rest"] = {"ms_per_tree": round(
            (total - sum(acc.values()) / args.trees) * 1e3, 3)}
        report[name].update(synchronized_s_per_tree=round(total, 6), sections=sections)

    print(card)
    for name in growers:
        r = report[name]
        print(f"{name}: free-running s/tree {r['free_running_s_per_tree']}, synchronized "
              f"{r['synchronized_s_per_tree']}")
        for s, v in sorted(r["sections"].items(), key=lambda kv: -kv[1]["ms_per_tree"]):
            per = f" over {v['calls_per_tree']:.0f} calls" if "calls_per_tree" in v else ""
            print(f"    {s}: {v['ms_per_tree']:.3f} ms/tree{per}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
