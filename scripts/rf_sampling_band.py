#!/usr/bin/env python3
"""RandomForest's test NDCG@10 band over seeds, in the JAX package and in the
port, on the CPU: do the port's feature draws cost quality against JAX's?

Neither package can reproduce the other's random draws (``jax.random``
against ``torch.Generator``), so the two are compared by the spread of their
quality over seeds.  Both train RandomForest with ``subsample`` and
``max_features`` below 1 on the same synthetic folds (``data/synthetic.py``,
the same numpy draws in both packages) and score the same test fold.  The
port also runs its node-clustered grower (``cluster="on"``).

Run from the repository root (it needs the JAX package, on the CPU):
``python scripts/rf_sampling_band.py [--queries 2000] [--trees 10] [--seeds 0 1 2]``.
Prints one JSON line: per package the per-seed NDCG@10, mean, min, max and
seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--leaves", type=int, default=16)
    ap.add_argument("--thresholds", type=int, default=64)
    ap.add_argument("--subsample", type=float, default=0.6)
    ap.add_argument("--max-features", type=float, default=0.5)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    from quickrank_tpu.data.synthetic import make_train_valid_test
    from quickrank_tpu.learning.randomforest import RandomForest as JaxRandomForest
    from quickrank_tpu.metrics import Ndcg as JaxNdcg
    from quickrank_tpu_torch.data.dataset import Dataset
    from quickrank_tpu_torch.learning import RandomForest
    from quickrank_tpu_torch.metrics import Ndcg

    q = args.queries
    train, valid, test = make_train_valid_test(num_queries=(q, q // 4, q // 4))
    port = [Dataset(d.features, d.labels, d.query_offsets, d.qids) for d in (train, valid, test)]
    kw = dict(ntrees=args.trees, nleaves=args.leaves, nthresholds=args.thresholds,
              subsample=args.subsample, max_features=args.max_features, esr=0)
    out = {"config": {**kw, "queries": [q, q // 4, q // 4], "docs": train.num_docs,
                      "features": train.num_features}}

    def band(name, run):
        vals, secs = [], []
        for seed in args.seeds:
            t0 = time.perf_counter()
            vals.append(run(seed))
            secs.append(time.perf_counter() - t0)
            print(f"# {name} seed {seed}: test NDCG@10 {vals[-1]:.6f} ({secs[-1]:.1f} s)",
                  file=sys.stderr)
        out[name] = {"ndcg10": vals, "mean": float(np.mean(vals)), "min": min(vals),
                     "max": max(vals), "seconds": secs}

    def run_jax(seed):
        m = JaxRandomForest(seed=seed, **kw)
        m.learn(train, valid, JaxNdcg(10), verbose=False)
        return float(m.evaluate(test, JaxNdcg(10)))

    def run_port(cluster):
        def run(seed):
            m = RandomForest(seed=seed, cluster=cluster, **kw)
            m.learn(port[0], port[1], Ndcg(10), verbose=False, device="cpu")
            return float(m.evaluate(port[2], Ndcg(10), device="cpu"))
        return run

    band("jax", run_jax)
    band("port", run_port("off"))
    band("port_cluster_on", run_port("on"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
