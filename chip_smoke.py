#!/usr/bin/env python3
"""Smoke test of quickrank_tpu_torch on one CUDA card.

Builds the CUDA kernels from ``quickrank_tpu_torch/csrc`` and holds each
against its plain PyTorch version at full width.  Scoring (phases 1-4): the
QuickScorer and perfect-tree kernels at 131,072 docs x 136 features, and the
scoring slice end to end through ``quickscore.main`` on an MSLR-shaped SVML
file and two XML models.  Training (phases 5-7): the histogram kernels on
the 2.56M-doc binned matrix of 19,000 MSLR-shaped queries, LambdaMART
trained on it with both growers (the carried scores held against the saved
model's kernel scores), and a short run on the card held against the same
run on the CPU.  The wrappers' launch counters show that each path ran its
kernels; every kernel is timed beside its plain version.

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
#: bench.py's training workload (bench.py:179-192): 19,000 queries of
#: lengths in [38, 232), ~2.56M docs x 136 features.  The data come from
#: data/synthetic.py, which draws the same query lengths and width with
#: learnable labels; bench.py's random labels give the level-wise grower
#: nothing to learn (single-doc outlier splits win), so train NDCG@10 need
#: not rise there.  Costs do not depend on the labels.
TRAIN_QUERIES = 19000
VALID_QUERIES = 2000
TRAIN_TREES = 8
CPU_QUERIES = 200  # phase 7: the card against the CPU
CPU_TREES = 5


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


def check_histogram(name, got, plain, exact, mass, terms, count_channels, rounding):
    """A histogram kernel's output against its plain version.

    Count channels equal.  Against the float64 evaluation of the plain
    version (``exact``), the kernel's own bound: per bin, t * r_c for the
    fixed-point rounding of its t values (``rounding`` r_c per output
    channel, ``kernel_histogram.rounding_error``), plus (2^-24 + 2^-52)
    |exact| for the conversion of the integer sum to float32 through
    float64, plus t * 2^-52 * sum|v| for the float64 evaluation itself.
    Against the float32 plain version, that bound plus the plain version's
    recursive summation bound, t * 2^-24 * sum|v|.  Returns the max abs
    error against the float32 plain version (its pad columns put every doc
    in bin 0, so that is mostly the plain version's own rounding)."""
    import torch

    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(torch.equal(got[..., count_channels], plain[..., count_channels]),
            f"{name}: count channel differs from the plain version")
    got = got.double()
    err32 = (got - plain.double()).abs()
    err64 = (got - exact).abs()
    bound64 = (terms * rounding.to(got.device)
               + (2.0 ** -24 + 2.0 ** -52) * exact.abs()
               + terms * 2.0 ** -52 * mass)
    bound32 = bound64 + terms * 2.0 ** -24 * mass
    print(f"  {name}: max abs err vs float32 plain {float(err32.max()):.4g} "
          f"(max {float((err32 / (bound32 + 1e-300)).max()):.3g} of its bound), "
          f"vs float64 plain {float(err64.max()):.4g} "
          f"(max {float((err64 / (bound64 + 1e-300)).max()):.3g} of its bound)")
    require(bool((err64 <= bound64).all()),
            f"{name}: outside the kernel's rounding bound (float64 plain)")
    require(bool((err32 <= bound32).all()),
            f"{name}: outside the float32 summation bound of the plain version")
    return float(err32.max())


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

    # -- phase 5: histogram kernels against their plain versions ----------
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.ops import kernel_histogram
    from quickrank_tpu_torch.ops.histogram import doc_channels

    t0 = time.perf_counter()
    train_ds = make_ranking_dataset(num_queries=TRAIN_QUERIES, seed=11)
    valid_ds = make_ranking_dataset(num_queries=VALID_QUERIES, seed=12)
    td = TrainData.build(train_ds, 255, device=dev)
    binned = td.step.binned
    N, W = binned.shape
    print(f"phase 5: histogram kernels against the plain versions on "
          f"{train_ds.num_docs} docs ({train_ds.num_queries} queries, padded to "
          f"{N}) x {W} u8 columns; data + binning "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cpu").manual_seed(5)
    g = torch.randn(N, generator=gen).to(dev)
    vt = doc_channels(g, td.step.doc_mask).T.contiguous()
    sub = td.step.doc_mask & (torch.rand(N, generator=gen).to(dev) < 0.5)
    pos_root = torch.where(td.step.doc_mask, 0, 1).to(torch.int32)
    pos_nodes = torch.randint(0, 16, (N,), generator=gen, dtype=torch.int32).to(dev)
    bins64 = (binned // 4).contiguous()  # a 64-bin matrix of the same shape
    hist_err = {"node_histogram": 0.0, "histogram": 0.0}
    k4_cases = [("256 bins, k=1 (root)", binned, 256, pos_root, 0, 1),
                ("64 bins, k=1 (half the docs)", bins64, 64,
                 torch.where(sub, 0, 1).to(torch.int32), 0, 1),
                ("256 bins, k=10, n0=3", binned, 256, pos_nodes, 3, 10),
                ("64 bins, k=10, n0=3", bins64, 64, pos_nodes, 3, 10)]
    k4_times = {}
    for label, b, nb, pos, n0, k in k4_cases:
        got = kernel_histogram.node_histogram(b, vt, pos, nb, n0, k)
        again = kernel_histogram.node_histogram(b, vt, pos, nb, n0, k)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"K4 {label}: two launches differ")
        plain = kernel_histogram.node_histogram_plain(b, vt, pos, nb, n0, k)
        vt64 = vt.double()
        exact, mass, terms = (
            kernel_histogram.node_histogram_plain(b, v, pos, nb, n0, k)
            for v in (vt64, vt64.abs(), torch.ones_like(vt64)))
        rounding = kernel_histogram.rounding_error(vt).repeat(k)
        hist_err["node_histogram"] = max(hist_err["node_histogram"], check_histogram(
            f"K4 {label}", got, plain, exact, mass, terms, slice(0, None, 3), rounding))
        k4_times[label] = (
            time_ms(lambda: kernel_histogram.node_histogram(b, vt, pos, nb, n0, k), reps=20),
            time_ms(lambda: kernel_histogram.node_histogram_plain(b, vt, pos, nb, n0, k),
                    reps=3),
        )
    slots = torch.randint(0, 32, (N, 1), generator=gen, dtype=torch.int32).to(dev)
    vals = torch.stack([g, torch.rand(N, generator=gen).to(dev)], dim=-1).contiguous()
    got = kernel_histogram.histogram(slots, vals, 32)
    again = kernel_histogram.histogram(slots, vals, 32)
    torch.cuda.synchronize()
    require(torch.equal(got, again), "K5: two launches differ")
    plain = kernel_histogram.histogram_plain(slots, vals, 32)
    v64 = vals.double()
    exact, mass, terms = (kernel_histogram.histogram_plain(slots, v, 32)
                          for v in (v64, v64.abs(), torch.ones_like(v64)))
    hist_err["histogram"] = check_histogram(
        "K5 32 slots, C=2", got, plain, exact, mass, terms, slice(0, 0),
        kernel_histogram.rounding_error(vals.T))
    k5_times = (time_ms(lambda: kernel_histogram.histogram(slots, vals, 32), reps=20),
                time_ms(lambda: kernel_histogram.histogram_plain(slots, vals, 32), reps=3))
    print(f"  ms per call on {card} (kernel / plain on the card):")
    for label, (k_ms, p_ms) in k4_times.items():
        print(f"    K4 {label}: {k_ms:.4f} / {p_ms:.4f}")
    print(f"    K5 32 slots, C=2: {k5_times[0]:.4f} / {k5_times[1]:.4f}")
    del td, binned, bins64, g, vt, sub, pos_root, pos_nodes, slots, vals

    # -- phase 6: LambdaMART training at full width, both growers ----------
    print(f"phase 6: LambdaMART, {TRAIN_TREES} trees, {train_ds.num_queries} train "
          f"+ {valid_ds.num_queries} valid queries, on {card}")
    from quickrank_tpu_torch.learning.base import LTRAlgorithm
    from quickrank_tpu_torch.metrics import Ndcg

    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    train_runs = {}
    for growth in ("best", "level"):
        lm = LambdaMart(ntrees=TRAIN_TREES, nleaves=16, nthresholds=255, growth=growth,
                        max_depth=4 if growth == "level" else 0, seed=1, esr=100)
        hist = lm.learn(train_ds, valid_ds, Ndcg(10), verbose=False, device="cuda")
        it = hist["iter_seconds"]
        per_tree = float(np.median(it[2:]))
        splits = (~lm.ensemble.is_leaf).sum(dim=1).tolist()
        train_runs[growth] = (lm, per_tree)
        print(f"  {growth}@255: {per_tree:.4f} s/tree (median of iterations 2+; "
              f"all: {[round(x, 4) for x in it]}), splits per tree {splits}, "
              f"init {hist['init_seconds']:.2f} s")
        print(f"    train NDCG@10 {[round(x, 5) for x in hist['train']]}")
        print(f"    valid NDCG@10 {[round(x, 5) for x in hist['valid']]}, best "
              f"iteration {lm.best_iteration}")
        require(hist["train"][-1] > hist["train"][0],
                f"{growth}: train NDCG@10 did not rise")
    train_launches = dict(kernel_histogram.LAUNCHES)
    print(f"  histogram kernel launches during training: {train_launches}")
    require(all(v > 0 for v in train_launches.values()),
            f"a histogram kernel of the training path was not launched: {train_launches}")
    with tempfile.TemporaryDirectory() as tmp:
        for growth, (lm, _) in train_runs.items():
            path = os.path.join(tmp, f"{growth}.xml")
            lm.save(path)
            model = LTRAlgorithm.load(path)
            scored = model.score_dataset(train_ds, device="cuda")
            carried = lm.train_scores[: train_ds.num_docs].cpu().numpy()
            require(scored.shape == carried.shape and np.isfinite(scored).all(),
                    f"{growth}: bad scores")
            kernel = {"qs": "K1", "perfect": "K2"}[model.scorer_path()]
            if model.scorer_path() == "qs":
                check_bitwise(f"{growth} carried scores vs {kernel} of the saved model",
                              scored, carried, train_ds.num_docs)
            else:  # float32 sum over trees against the Kahan carry
                err = float(np.abs(scored - carried).max())
                atol = 1e-5 * max(1.0, float(np.abs(carried).max()))
                count, max_ulp = ulp_diff(scored, carried)
                print(f"  {growth} carried scores vs {kernel} of the saved model: max "
                      f"abs err {err:.3g} (atol {atol:.3g}); {count} docs differ, "
                      f"max {max_ulp} ulp")
                require(err <= atol, f"{growth}: {err} > {atol}")

    # -- phase 7: the card against the CPU on a small fold -----------------
    print(f"phase 7: {CPU_TREES}-tree runs on {CPU_QUERIES} queries, card against CPU")
    small = make_ranking_dataset(num_queries=CPU_QUERIES, seed=13)
    for growth in ("best", "level"):
        runs = {}
        for device in ("cuda", "cpu"):
            lm = LambdaMart(ntrees=CPU_TREES, nleaves=16, nthresholds=255, growth=growth,
                            max_depth=4 if growth == "level" else 0, seed=1)
            runs[device] = (lm, lm.learn(small, None, Ndcg(10), verbose=False, device=device))
        (gpu_m, gpu_h), (cpu_m, cpu_h) = runs["cuda"], runs["cpu"]
        root = [(int(m.ensemble.feature[0, 0]), int(m.ensemble.threshold_bin[0, 0]))
                for m in (gpu_m, cpu_m)]
        diff = float(np.abs(np.array(gpu_h["train"]) - np.array(cpu_h["train"])).max())
        print(f"  {growth}: root split (feature, bin) card {root[0]}, cpu {root[1]}; "
              f"max train NDCG@10 difference {diff:.3g} over {CPU_TREES} iterations")
        require(root[0] == root[1], f"{growth}: root split differs")
        require(diff <= 1e-3, f"{growth}: train NDCG@10 differs by {diff}")

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
        {"name": "node_histogram", "route": "cuda",
         "source": "quickrank_tpu_torch/csrc/histogram.cu",
         "replaces": "quickrank_tpu/ops/pallas_histogram.py:183",
         "launches": train_launches["node_histogram"],
         "max_abs_err": hist_err["node_histogram"],
         "ms": k4_times["256 bins, k=1 (root)"][0],
         "plain_ms": k4_times["256 bins, k=1 (root)"][1]},
        {"name": "histogram", "route": "cuda",
         "source": "quickrank_tpu_torch/csrc/histogram.cu",
         "replaces": "quickrank_tpu/ops/pallas_histogram.py:278",
         "launches": train_launches["histogram"],
         "max_abs_err": hist_err["histogram"],
         "ms": k5_times[0], "plain_ms": k5_times[1]},
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
