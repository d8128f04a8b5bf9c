#!/usr/bin/env python3
"""Where the time goes in the port's linear rankers and Cleaver on one CUDA card.

On MSLR-shaped synthetic data (data/synthetic.py: 19,000 train queries of
lengths in [38, 232), 136 features; 2,000 valid queries) it times, each
section ended by a synchronize (host clock):

  * CoordinateAscent feature steps (``--steps`` of them, features 0, 1,
    ...): ``X @ w`` in XLA's order, the metric of ``w``, the ``[22, N]``
    candidate matrix, and its metrics taken apart into the gather of the
    per-query view and ``evaluate_per_query`` (the sorts), chunk by chunk;
    the batch alone between CUDA events; and the device's idle share over
    the same steps under ``torch.profiler``;
  * ``X @ w`` in XLA's order against one float32 matmul (CUDA events): the
    rows whose bits differ, the largest gap between the two feature steps'
    candidate metrics, and the set QUALITY_LOSS prunes from a small model
    with either dot on the card beside the CPU's;
  * Cleaver (QUALITY_LOSS, half of 200 trees, a LineSearch of one iteration
    before and after pruning) on a random 200-tree, 16-leaf model: the
    per-tree score extraction (K1's partial entry and the host copy), the
    line search before pruning, the drop-one metrics, the line search after.

Prints one JSON line.  Run from the repository root:
    python scripts/profile_torch_linear.py [--queries 19000] [--steps 8]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def event_ms(fn, reps: int) -> float:
    """Mean ms a call between CUDA events, after one warm call."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def dot_order_cleaver(dev, metric) -> dict:
    """QUALITY_LOSS (rate 0.5) on a 12-tree, 16-leaf LambdaMART model of 40
    small queries (the ``gpu`` test's model): the pruned set and the train
    metric after pruning on the CPU, on the card, and on the card with
    ``Fold.dot`` replaced by one float32 matmul."""
    import copy

    import numpy as np
    import torch

    from quickrank_tpu_torch.data.synthetic import make_train_valid_test
    from quickrank_tpu_torch.learning import LambdaMart, linear
    from quickrank_tpu_torch.optimization import Cleaver

    train, valid, _ = make_train_valid_test(num_queries=(40, 12, 12), avg_docs_per_query=30,
                                            num_features=12)
    lm = LambdaMart(ntrees=12, nleaves=16, nthresholds=64, seed=1)
    lm.learn(train, None, metric, verbose=False, device="cpu")
    xla_dot = linear.Fold.dot
    runs = {}
    for label, device, dot in (("cpu", "cpu", xla_dot), ("card", dev, xla_dot),
                               ("card, one matmul", dev, lambda self, w: self.X @ torch.from_numpy(
                                   np.asarray(w, np.float32)).to(self.device))):
        linear.Fold.dot = dot
        try:
            info = Cleaver("QUALITY_LOSS", 0.5).optimize(copy.deepcopy(lm), train, valid, metric,
                                                         verbose=False, device=device)
        finally:
            linear.Fold.dot = xla_dot
        runs[label] = {"pruned": info["pruned"], "metric_after": info["metric_after"]}
    return runs


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--queries", type=int, default=19000)
    p.add_argument("--valid-queries", type=int, default=2000)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--trees", type=int, default=200)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_linear: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "scripts"))
    from profile_torch_training import busy_share

    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import linear
    from quickrank_tpu_torch.learning.mart import Mart
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.ops import _cuda
    from quickrank_tpu_torch.optimization import Cleaver, cleaver
    from quickrank_tpu_torch.trees.random_ensemble import random_bestfirst_ensemble

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    _cuda.library()  # the kernels are built before anything is timed
    train = make_ranking_dataset(num_queries=args.queries, seed=11)
    valid = make_ranking_dataset(num_queries=args.valid_queries, seed=12)
    metric = Ndcg(10)
    out = {"card": card, "docs": train.num_docs, "queries": train.num_queries}

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    fold, out["fold_build_ms"] = synced(lambda: linear.Fold(train, dev))
    Q, D = fold.slot_mask.shape
    out["padded_view"] = [Q, D]
    out["batch_size"] = fold.batch_size()
    F = train.num_features
    ca = linear.CoordinateAscent()
    w = np.full(F, np.float32(1.0 / F), np.float32)
    window = np.float32(10.0 / F)
    sections = {"dot": [], "current": [], "candidates": [], "gather": [], "per_query": [],
                "sum": [], "step": []}
    for i in range(args.steps):
        full, t = synced(lambda: fold.dot(w))
        sections["dot"].append(t)
        _, t = synced(lambda: fold.metric(metric, full))
        sections["current"].append(t)
        pts = linear.grid_points(w[i], window, ca.num_points)
        cands, t = synced(lambda: linear.feature_candidates(full, fold.column(i), w[i], pts))
        sections["candidates"].append(t)
        n = fold.batch_size()
        g = pq = s = 0.0
        for c0 in range(0, cands.shape[0], n):
            part = cands[c0:c0 + n]
            c = part.shape[0]
            (sm, view), t = synced(lambda: (fold.slot_mask.repeat(c, 1), torch.where(
                fold.slot_mask.repeat(c, 1), part[:, fold.pad_index].reshape(c * Q, D), 0.0)))
            g += t
            vals, t = synced(lambda: metric.evaluate_per_query(
                view, fold.labels2d.repeat(c, 1), sm, fold.nvalid.repeat(c)))
            pq += t
            _, t = synced(lambda: torch.where(fold.query_mask, vals.reshape(c, Q), 0.0)
                          .double().sum(-1))
            s += t
        sections["gather"].append(g)
        sections["per_query"].append(pq)
        sections["sum"].append(s)
        _, t = synced(lambda: ca.feature_step(fold, metric, w, i, window))
        sections["step"].append(t)
    out["ca_step_ms"] = {k: float(np.median(v)) for k, v in sections.items()}

    out["candidate_batch_ms"] = event_ms(lambda: fold.metrics(metric, cands), 5)

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            ca.feature_step(fold, metric, w, i, window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    cpu = [e for e in events if e.device_type.name == "CPU"]
    w0 = min(e.time_range.start for e in cpu)
    busy, total = busy_share(events, [(w0, w0 + wall * 1e6)])
    out["ca_profiled_steps"] = {"wall_s": wall, "idle_share": 1.0 - busy / max(total, 1.0)}
    # -- the dot's order: matvec_f32 (XLA's CPU order, so the CPU's bits)
    # against one float32 matmul, at this size and on a small model's Cleaver
    wt = torch.from_numpy(w).to(dev)
    out["dot_ms"] = {"matvec_f32": event_ms(lambda: fold.dot(w), 5),
                     "matmul_f32": event_ms(lambda: fold.X @ wt, 5)}
    xla, plain = fold.dot(w), fold.X @ wt
    out["dot_rows_differing"] = int((xla != plain).sum())
    pts = linear.grid_points(w[0], window, ca.num_points)
    step_metrics = [fold.metrics(metric, linear.feature_candidates(full, fold.column(0), w[0], pts))
                    .cpu().numpy() for full in (xla, plain)]
    fin = np.isfinite(step_metrics[0])
    out["dot_order_step_metric_gap"] = float(np.abs(step_metrics[0][fin]
                                                    - step_metrics[1][fin]).max())
    del fold, cands, full, xla, plain
    out["dot_order_cleaver"] = dot_order_cleaver(dev, metric)

    # -- Cleaver ---------------------------------------------------------------
    model = Mart(nleaves=16)
    model.ensemble = random_bestfirst_ensemble(args.trees, 16, F, seed=3)
    model.ensemble.weight[:] = 0.1
    cl = Cleaver("QUALITY_LOSS", 0.5, line_search=linear.LineSearch(max_iterations=1))
    torch.cuda.reset_peak_memory_stats()
    (ptrain, t_tr) = synced(lambda: Cleaver.partial_dataset(model, train, dev))
    (pvalid, t_va) = synced(lambda: Cleaver.partial_dataset(model, valid, dev))
    out["cleaver_extract_ms"] = {"train": t_tr, "valid": t_va}
    ev, out["cleaver_fold_build_ms"] = synced(lambda: cleaver._PartialEval(metric, ptrain, dev))
    wts = model.get_weights()
    base = ev.base(wts)
    _, out["cleaver_drop_one_ms"] = synced(lambda: ev.drop_one_metrics(base, wts, 0))
    info, t = synced(lambda: cl.optimize(model, train, valid, metric, verbose=False,
                                         ptrain=ptrain, pvalid=pvalid, device=dev))
    out["cleaver_optimize_s"] = t / 1e3
    out["cleaver_sections_s"] = {k: info[k] for k in ("pre_ls_seconds", "prune_seconds",
                                                      "post_ls_seconds")}
    out["cleaver_trees"] = [info["num_trees_before"], info["num_trees_after"]]
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
