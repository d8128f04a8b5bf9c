#!/usr/bin/env python3
"""Smoke test of quickrank_tpu_torch on one CUDA card.

Builds the CUDA kernels from ``quickrank_tpu_torch/csrc``, holds each against
its plain PyTorch version at full width (131,072 docs x 136 features), drives
the scoring slice end to end through ``quickscore.main`` on an MSLR-shaped
SVML file and two XML models, shows through the wrappers' launch counters
that the slice ran the kernels, and times each kernel beside its plain
version.

Run from the repository root: ``python3 chip_smoke.py``.  It exits non-zero
on any failure, and without printing a result when no CUDA device is
present.  The line before the last is the per-kernel JSON report; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

N_DOCS = 1 << 17
N_FEATURES = 136
N_CHECK = 4096  # docs also scored by the CPU descent reference
QS_CASES = [(1000, 16, 5), (100, 64, 6), (20, 128, 7)]  # trees, leaves, seed
PERFECT_CASES = [(1000, 4, 0), (1000, 5, 0)]  # trees, depth, seed


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def ulp_diff(a, b):
    """(count of differing elements, max distance in float32 ulps)."""
    import numpy as np

    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = np.abs(ordered(a) - ordered(b))
    return int((d != 0).sum()), int(d.max()) if d.size else 0


def check_bitwise(name, got, want, n):
    """Bitwise, or at most 1 ulp on at most 0.1% of docs."""
    count, max_ulp = ulp_diff(got, want)
    print(f"  {name}: {count} of {n} docs differ, max {max_ulp} ulp")
    require(count == 0 or (max_ulp <= 1 and count <= n // 1000),
            f"{name}: {count} docs differ, max {max_ulp} ulp")


def time_ms(fn, reps, warm=1):
    """Mean ms per call between CUDA events, after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from quickrank_tpu_torch import quickscore
    from quickrank_tpu_torch.data.svml import read_svml, write_svml
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import LambdaMart
    from quickrank_tpu_torch.ops import _cuda, kernel_perfect, kernel_qs
    from quickrank_tpu_torch.ops.scoring import score_ensemble
    from quickrank_tpu_torch.trees.perfect import (
        ensemble_to_perfect,
        score_perfect,
        tree_depths,
    )
    from quickrank_tpu_torch.trees.qs import ensemble_to_qs, score_qs
    from quickrank_tpu_torch.trees.random_ensemble import (
        random_balanced_ensemble,
        random_bestfirst_ensemble,
    )

    # exact float32 products in every plain-version matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    log = _cuda.build(force=True)
    _cuda.library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rng = np.random.default_rng(1)
    X_host = rng.standard_normal((N_DOCS, N_FEATURES), dtype=np.float32)
    X = torch.from_numpy(X_host).to(dev)
    X_check = torch.from_numpy(X_host[:N_CHECK])

    def descent(ens):
        return score_ensemble(
            X_check, ens, max_depth=int(tree_depths(ens).max()) + 1
        ).numpy()

    # -- phase 1: QuickScorer kernel against its plain version --------------
    print("phase 1: qs_score against the plain version and the CPU descent")
    qs_err = 0.0
    qs_tables = {}
    for T, leaves, seed in QS_CASES:
        ens = random_bestfirst_ensemble(T, leaves, N_FEATURES, seed=seed)
        tables = ensemble_to_qs(ens).to(dev)
        qs_tables[(T, leaves)] = (ens, tables)
        got = kernel_qs.score_qs(X, tables).cpu().numpy()
        plain = score_qs(X, tables).cpu().numpy()
        require(got.shape == (N_DOCS,) and np.isfinite(got).all(),
                "qs_score: bad output")
        qs_err = max(qs_err, float(np.abs(got - plain).max()))
        check_bitwise(f"qs {T}x{leaves} vs plain on card", got, plain, N_DOCS)
        check_bitwise(f"qs {T}x{leaves} vs CPU descent", got[:N_CHECK],
                      descent(ens), N_CHECK)

    # -- phase 2: perfect kernel against its plain version ------------------
    print("phase 2: perfect_score against the plain version and the CPU descent")
    pf_err = 0.0
    pf_tables = {}
    for T, depth, seed in PERFECT_CASES:
        ens = random_balanced_ensemble(T, depth, N_FEATURES, seed=seed)
        pe = ensemble_to_perfect(ens).to(dev)
        pf_tables[(T, depth)] = (ens, pe)
        got = kernel_perfect.score_perfect(X, pe).cpu().numpy()
        plain = score_perfect(X, pe).cpu().numpy()
        require(got.shape == (N_DOCS,) and np.isfinite(got).all(),
                "perfect_score: bad output")
        pf_err = max(pf_err, float(np.abs(got - plain).max()))
        check_bitwise(f"perfect {T}xd{depth} vs plain on card", got, plain, N_DOCS)
        ref = descent(ens)
        err = float(np.abs(got[:N_CHECK] - ref).max())
        atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        print(f"  perfect {T}xd{depth} vs CPU descent: max abs err {err:.3g} "
              f"(atol {atol:.3g}, float32 sum vs Kahan)")
        require(err <= atol, f"perfect {T}xd{depth}: {err} > {atol}")

    # -- phase 3: the slice end to end through quickscore -------------------
    print("phase 3: quickscore end to end")
    with tempfile.TemporaryDirectory() as tmp:
        ds = make_ranking_dataset(num_queries=1000, avg_docs_per_query=116,
                                  num_features=N_FEATURES, seed=0)
        svml = os.path.join(tmp, "mslr-shaped.svml")
        t0 = time.perf_counter()
        write_svml(ds, svml)
        print(f"  wrote {ds.num_docs} docs x {ds.num_features} features, "
              f"{ds.num_queries} queries in {time.perf_counter() - t0:.2f} s")
        models = {
            "qs": qs_tables[(1000, 16)][0],
            "perfect": pf_tables[(1000, 4)][0],
        }
        for name, ens in models.items():
            m = LambdaMart()
            m.ensemble = ens
            m.save(os.path.join(tmp, f"{name}.xml"))
        kernel_qs.LAUNCHES = 0
        kernel_perfect.LAUNCHES = 0
        for name in models:
            rc = quickscore.main([
                "-d", svml, "-m", os.path.join(tmp, f"{name}.xml"),
                "--device", "cuda", "-r", "10",
                "-s", os.path.join(tmp, f"{name}.scores"),
            ])
            require(rc == 0, f"quickscore {name}: exit {rc}")
        launches = {"qs_score": kernel_qs.LAUNCHES,
                    "perfect_score": kernel_perfect.LAUNCHES}
        print(f"  launches during quickscore: {launches}")
        require(all(v > 0 for v in launches.values()),
                f"a kernel of the path was not launched: {launches}")
        Xd = torch.from_numpy(read_svml(svml).features).to(dev)
        plains = {
            "qs": score_qs(Xd, qs_tables[(1000, 16)][1]),
            "perfect": score_perfect(Xd, pf_tables[(1000, 4)][1]),
        }
        for name, plain in plains.items():
            got = np.loadtxt(os.path.join(tmp, f"{name}.scores")).astype(np.float32)
            plain = plain.cpu().numpy()
            require(got.shape == (ds.num_docs,) and np.isfinite(got).all(),
                    f"quickscore {name}: bad scores file")
            check_bitwise(f"quickscore {name} scores vs plain", got, plain,
                          ds.num_docs)

    # -- phase 4: times ------------------------------------------------------
    print(f"phase 4: ms per call at {N_DOCS} docs x {N_FEATURES} features "
          f"on {card}")
    times = {}
    for (T, leaves), (_, tables) in qs_tables.items():
        k = time_ms(lambda: kernel_qs.score_qs(X, tables), reps=20)
        p = time_ms(lambda: score_qs(X, tables), reps=3)
        times[("qs", T, leaves)] = (k, p)
        print(f"  qs {T}x{leaves} leaves: kernel {k:.4f} ms "
              f"({N_DOCS / k * 1e3:.4g} docs/s), plain {p:.4f} ms "
              f"({N_DOCS / p * 1e3:.4g} docs/s)")
    for (T, depth), (_, pe) in pf_tables.items():
        k = time_ms(lambda: kernel_perfect.score_perfect(X, pe), reps=20)
        p = time_ms(lambda: score_perfect(X, pe), reps=3)
        times[("perfect", T, depth)] = (k, p)
        print(f"  perfect {T}xd{depth}: kernel {k:.4f} ms "
              f"({N_DOCS / k * 1e3:.4g} docs/s), plain {p:.4f} ms "
              f"({N_DOCS / p * 1e3:.4g} docs/s)")

    report = {"kernels": [
        {"name": "qs_score", "route": "cuda",
         "source": "quickrank_tpu_torch/csrc/qs_score.cu",
         "replaces": "quickrank_tpu/ops/pallas_qs.py:100",
         "launches": launches["qs_score"], "max_abs_err": qs_err,
         "ms": times[("qs", 1000, 16)][0],
         "plain_ms": times[("qs", 1000, 16)][1]},
        {"name": "perfect_score", "route": "cuda",
         "source": "quickrank_tpu_torch/csrc/perfect_score.cu",
         "replaces": "quickrank_tpu/ops/pallas_perfect.py:102",
         "launches": launches["perfect_score"], "max_abs_err": pf_err,
         "ms": times[("perfect", 1000, 4)][0],
         "plain_ms": times[("perfect", 1000, 4)][1]},
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
