"""quickscore: batch-scoring timer (counterpart of quickrank_tpu/quickscore.py
and the reference's ``quickscore`` binary, src/quickscore.cc:62-134).

Loads an SVML dataset and an XML model (any ported ranker: tree ensembles
through their kernels, linear models and RankBoost's weak rankers as a
float64 matrix-vector product, CustomLTR's fixed score),
scores every doc ``rounds`` times on the chosen device, and reports total, per-dataset and per-doc time.  On CUDA
the features are uploaded once, one warm-up call builds the kernels, and
the timed loop is bracketed by ``torch.cuda.synchronize()``.

Run: ``python -m quickrank_tpu_torch.quickscore -d data.svml -m model.xml -r 10``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quickscore-torch")
    p.add_argument("-d", "--dataset", required=True, help="SVML test set")
    p.add_argument("-m", "--model", required=True, help="XML model")
    p.add_argument("-r", "--rounds", type=int, default=10)
    p.add_argument("-s", "--scores", help="optional output scores file")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="scoring device; cuda without a CUDA device is an error")
    args = p.parse_args(argv)
    if args.rounds < 1:
        p.error("--rounds must be at least 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is available")
    device = torch.device(args.device)

    from quickrank_tpu_torch.data.svml import read_svml
    from quickrank_tpu_torch.learning.base import LTRAlgorithm

    ds = read_svml(args.dataset)
    model = LTRAlgorithm.load(args.model)
    print(
        f"#\t Dataset size: {ds.num_docs} x {ds.num_features} "
        f"(instances x features)"
    )
    print(
        f"#\t Num queries: {ds.num_queries} | Avg. len: "
        f"{ds.num_docs // max(ds.num_queries, 1)}"
    )
    path = {
        "perfect": "perfect-tree kernel (depth <= 5)",
        "qs": "QuickScorer kernel (any depth)",
        "oblivious": "oblivious bit-OR kernel",
        "linear": "linear model (X @ w in float64)",
        "rankboost": "RankBoost weak rankers (column gather, compare, float64 product)",
        "custom": "fixed score",
    }[model.scorer_path()]
    print(f"#\t Scorer path: {path} on {device.type}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn, X = model.device_scorer(ds, device)
    out = fn(X)  # warm-up: builds the kernels on first CUDA use
    sync()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        out = fn(X)
    sync()
    total = time.perf_counter() - t0
    scores = out.cpu().numpy()
    per_dataset = total / args.rounds
    per_doc = per_dataset / ds.num_docs
    print(f"       Total scoring time: {total:.6g} s.")
    print(f"Avg. Dataset scoring time: {per_dataset:.6g} s.")
    print(f"Avg.    Doc. scoring time: {per_doc:.6g} s.")
    if args.scores:
        np.savetxt(args.scores, scores, fmt="%.15g")
    return 0


if __name__ == "__main__":
    sys.exit(main())
