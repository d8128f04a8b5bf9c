#!/usr/bin/env python3
"""Profile a RankBoost round of quickrank_tpu_torch on one CUDA card.

On MSLR-shaped synthetic data (data/synthetic.py, 19,000 train and 2,000
valid queries by default, 255 thresholds) it times the sections of a round,
each ended by a synchronize, over ``--rounds`` rounds after two warm-up
rounds: the factorized potentials (per-query recentering, exponentials, the
label-level scans), the potential histogram (the node-histogram kernel, K4,
with one channel), the suffix scan and argmax over (feature, bin), the host
read of (argmax, r, S), the weak ranker's apply with the train metric, and
the valid fold's update with its metric.  A second pass runs
``RankBoost.learn`` itself under ``torch.profiler`` and reports the device's
idle share between the round loop's first and last kernel, and device time
by kernel.

Run from the repository root:
    python scripts/profile_torch_rankboost.py [--queries 19000] [--rounds 20]
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--rounds", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_rankboost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    from torch.autograd import DeviceType

    from quickrank_tpu_torch.data.dataset import shard_and_pad
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import rankboost
    from quickrank_tpu_torch.learning.mart import TrainData, eval_metric
    from quickrank_tpu_torch.learning.rankboost import RankBoost
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.ops import _cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    _cuda.library()  # build the kernels before anything is timed
    train = make_ranking_dataset(num_queries=args.queries, seed=11)
    valid = make_ranking_dataset(num_queries=args.valid_queries, seed=12)
    dev = torch.device("cuda")
    metric = Ndcg(10)
    tr = TrainData.build(train, 255, device=dev)
    sd, B, F = tr.step, tr.num_bins, tr.num_real_features
    levels = tuple(float(x) for x in np.unique(train.labels))
    vpadded = rankboost._to_device(shard_and_pad(valid), dev)
    vX = torch.from_numpy(np.ascontiguousarray(vpadded.features)).to(dev)
    vscores = torch.zeros(vX.shape[0], dtype=torch.float64, device=dev)
    scores = torch.zeros(tr.padded.num_docs_padded, dtype=torch.float32, device=dev)

    sections = {k: [] for k in ("potentials", "k4_histogram", "scan_argmax", "host_read",
                                "apply_train_metric", "valid")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sections[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for r in range(args.rounds + 2):
        pi, S = timed("potentials", lambda: rankboost.potentials(scores, sd, levels))
        hist = timed("k4_histogram",
                     lambda: rankboost.potential_histogram(sd.binned, pi, sd.doc_mask, B, F))
        best, best_r = timed("scan_argmax", lambda: rankboost.best_weak_ranker(hist))
        best, r_best, _ = timed("host_read", lambda: torch.stack(
            [best.double(), best_r.double(), S.double()]).tolist())
        f_i, t_i = divmod(int(best), B)
        theta = float(tr.thresholds[f_i, t_i])
        alpha = np.float32(0.1)

        def apply():
            h = (sd.binned[:, f_i].to(torch.int32) > t_i).to(torch.float32) \
                * sd.doc_mask.to(torch.float32)
            s2 = scores + alpha * h
            return s2, eval_metric(metric, sd, s2)

        scores, m_tr = timed("apply_train_metric", apply)

        def valid_step():
            vscores.add_(float(alpha) * (vX[:, f_i] > theta).to(torch.float64))
            return torch.stack([m_tr, metric.evaluate_padded(vpadded, vscores.float())]).tolist()

        timed("valid", valid_step)
    by_section = {k: float(np.median(v[2:])) for k, v in sections.items()}

    RankBoost(ntrees=2, nthresholds=255).learn(train, valid, metric, verbose=False)  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        hist_run = RankBoost(ntrees=args.rounds, nthresholds=255).learn(
            train, valid, metric, verbose=False)
        torch.cuda.synchronize()
    events = prof.events()
    work = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("Activity Buffer"))
    k4 = [e for e in events if e.device_type == DeviceType.CUDA and "histogram" in e.name]
    busy = total = 0.0
    if k4:
        w0 = min(e.time_range.start for e in k4)
        w1 = max(b for _, b in work)
        total = w1 - w0
        cur0 = cur1 = None
        for a, b in work:
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
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t:
            kernels[e.key[:60]] = {"count": e.count, "device_ms_total": t / 1e3}
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms_total"])[:12])
    print(json.dumps({
        "docs": train.num_docs, "queries": train.num_queries, "label_levels": len(levels),
        "rounds": args.rounds,
        "synchronized_ms_per_round_by_section": by_section,
        "synchronized_ms_per_round": sum(by_section.values()),
        "learn_median_seconds_per_round": float(np.median(hist_run["iter_seconds"][1:])),
        "device_idle_share": 1 - busy / total if total else None,
        "window_us": total, "busy_us": busy, "kernels_by_device_time": top, "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
