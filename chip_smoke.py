#!/usr/bin/env python3
"""Smoke test of quickrank_tpu_torch on one CUDA card.

Builds the CUDA kernels from ``quickrank_tpu_torch/csrc`` and holds each
against its plain PyTorch version at full width.  Scoring (phases 1-4): the
QuickScorer and perfect-tree kernels at 131,072 docs x 136 features (both
also on rows too wide to stage in shared memory and on a doc count that ends
mid-block, the QuickScorer kernel on uint8 bin rows and on trees of 1,024 to
4,096 leaves, too wide for one block's shared memory), the perfect-tree
kernel timed beside the QuickScorer kernel on the same depth-4 ensemble, and
the scoring slice end to end through ``quickscore.main`` on an MSLR-shaped
SVML file and three XML models.  Training (phases 5-7): the histogram kernels on
the 2.56M-doc binned matrix of 19,000 MSLR-shaped queries (against their
plain versions and, bit for bit, against their fixed-point arithmetic in
plain PyTorch; a best-first-shaped pass over a scattered tenth of the docs
beside the same docs as a contiguous run), LambdaMART
trained on it with both growers (the carried scores held against the saved
model's kernel scores), and a short run on the card held against the same
run on the CPU.  The oblivious path (phases 8-12): the bit-OR scoring kernel
at 131,072 x 136 (1000 trees of depth 4 and other shapes, value and bin
space), ObliviousLambdaMART trained on the 19,000 queries, saved and served
through ``quickscore.main``, best-k growth beside best-first, a warm start
whose rescore rides the QuickScorer kernel on the bin matrix, and the
oblivious learner on the card against the CPU.  The node-clustered grower
(phases 13-16): the row-partition kernel on the 2,655,232 x 160 work buffer
under three directive sets, the clustered tree held against the
dataset-order tree, LambdaMART with ``cluster="on"`` beside ``cluster="off"``,
and the card against the CPU.  Phase 17 trains, saves and scores through the
quicklearn command line (``quickrank_tpu_torch.cli.main``) and holds its
scores against quickscore's.  DART (phases 18-22): the QuickScorer kernel's
partial entry (per-tree columns) at 131,072 x 136, on u8 bins and on trees
too wide for one block, DART trained for 200 trees on the 19,000 queries, its
dropped-set delta through the QuickScorer kernel on the u8 bin matrix, DART
on the card against the CPU, and quicklearn --algo DART with --detailed.
Post-learning optimisation (phases 23-26): CoordinateAscent and LineSearch
at full width (the candidate batch timed), both against the same runs on the
CPU, Cleaver pruning half of phase 19's DART model with a line search before
and after (its per-tree scores from K1's partial entry, the pruned model's
kernel scores held against ``partial @ weights``) and all eight strategies,
and quicklearn's optimization phase, COORDASC, --meta-algo METACLEAVER and
quickscore on the saved models.  The remaining learners (phases 27-30):
RankBoost for 50 rounds on the 19,000 queries (its potential histogram
through the node-histogram kernel, one round's held bit for bit against the
fixed-point reference, quickscore on the saved model), RankBoost and
LambdaMART-Selective on the card against the CPU, RandomForest, Selective
(RATIO, MUL, POS) and Stochastic-Negative at full width with their presence
rules checked on the card, and quicklearn for all five, with quickscore on
each saved model, the three C code generators (compiled and run) and
``--trace``.  Query-sharded training (phases 31-34): the histogram kernels'
group entry (int64 sums under a given fixed-point scale, and the conversion)
bitwise against its plain version, two halves of the bin matrix summed as
integers against one launch over all the docs, and K4's library call
(``index_add_``) timed; two gloo ranks sharing the card against a one-rank
group and the unsharded run for the four growers (spawned ranks,
``parallel/launch.py``); a one-rank NCCL group; and ``--num-shards`` in
quicklearn and quickscore, on data whose padded rows cross a power of two.
The rest of parallel training (phases 35-37): DART and X-DART, then
CoordinateAscent, LineSearch and Cleaver, each unsharded, as a one-rank
group and as two gloo ranks sharing the card, equal bit for bit; and
quicklearn's DART with the optimization phase under ``--num-shards 1``
saving the no-flag run's files.  Phase 6 also holds the fixed-order
per-query sum kernel (``csrc/query_sum.cu``, not a TPU kernel) against its
plain version and times it beside the float64 sum it replaced.  The
wrappers' launch counters show that each path ran its kernels; every kernel is timed beside
its plain version and its bound (the larger of bytes moved over the card's
memory rate and operations over its float32 rate).

Run from the repository root: ``python3 chip_smoke.py``.  It exits non-zero
on any failure, and without printing a result when no CUDA device is
present.  The line before the last is the per-kernel JSON report; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
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
#: trees, leaves, seed of trees too wide for one block's shared memory,
#: scored at N_WIDE_DOCS x N_FEATURES (K1's wide kernel)
QS_WIDE_CASES = [(4, 1024, 11), (4, 2048, 12), (4, 4096, 13)]
N_WIDE_DOCS = 8192
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
DART_TREES = 200  # phase 19: DART's full-width run
DART35_TREES = 12  # phase 35: DART under a group, three ways
#: phase 36: train and valid queries of the linear rankers and Cleaver under a
#: group (cut from 19,000 + 2,000, widths kept), and the trees Cleaver prunes
LINEAR36_QUERIES = (3000, 500)
CLEAVER36_TREES = 50
CPU_QUERIES = 200  # phases 7, 10, 12, 16, 21 and 24: the card against the CPU
LINEAR_EPOCHS = 2  # phase 23: CoordinateAscent epochs, LineSearch iterations
CLEAVER_RATE = 0.5  # phase 25: the share of the DART model's trees pruned
CPU_TREES = 5
T_START = 0.0  # perf_counter at the start of main(); phase headers print the time since
RANKBOOST_ROUNDS = 50  # phase 27: RankBoost's full-width run
#: a main() around a generated ``double ranker(float* v)``: reads "n f" and
#: n rows of f features from stdin, prints one score a row (phase 30)
CODEGEN_MAIN = """
#include <stdio.h>
#include <stdlib.h>
int main(void) {
    int n, f;
    if (scanf("%d %d", &n, &f) != 2) return 1;
    float *v = malloc(sizeof(float) * f);
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < f; ++j) if (scanf("%f", &v[j]) != 1) return 1;
        printf("%.10g\\n", ranker(v));
    }
    return 0;
}
"""
#: trees, depth, docs, features of the oblivious scoring shapes; the first
#: is the JAX package's headline workload (bench.py:74-86), the third ends
#: mid-block and has dead levels, and the rows of the last are too wide to
#: stage in shared memory
OBLIVIOUS_CASES = [(1000, 4, N_DOCS, N_FEATURES), (200, 6, N_DOCS, N_FEATURES),
                   (37, 3, 100003, N_FEATURES), (64, 4, 8192, 700)]
#: published peaks of one H100 SXM: HBM bytes/s, float32 operations/s
#: outside the tensor cores (integer compares and mask ANDs count at it too)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def phase(text: str) -> None:
    """Print a phase header, after the seconds since main() started."""
    print(f"[{time.perf_counter() - T_START:.1f} s] phase {text}")


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


def bound_ms(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of bytes moved (each input read once, each output written
    once) over the memory rate and operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def mean_leaf_depths(ens):
    """Mean depth of each live tree's leaves, float64 [T]."""
    import numpy as np

    left, right, is_leaf = (t.cpu().numpy() for t in (ens.left, ens.right, ens.is_leaf))
    means = []
    for t in range(int(ens.num_trees)):
        depths, stack = [], [(0, 0)]
        while stack:
            i, d = stack.pop()
            if is_leaf[t, i]:
                depths.append(d)
            else:
                stack += [(int(left[t, i]), d + 1), (int(right[t, i]), d + 1)]
        means.append(np.mean(depths))
    return np.asarray(means)


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

    global T_START
    T_START = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from quickrank_tpu_torch import quickscore
    from quickrank_tpu_torch.data.svml import read_svml, write_svml
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
    from quickrank_tpu_torch.ops import _cuda, kernel_oblivious, kernel_perfect, kernel_qs
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
        random_oblivious_ensemble,
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
        if "Compiling entry function" in line:  # the mangled name holds the template's types
            print("  ptxas:", line.split("'")[1])
        elif "registers" in line or "spill" in line:
            print("  ptxas:  ", line.strip())

    rng = np.random.default_rng(1)
    X_host = rng.standard_normal((N_DOCS, N_FEATURES), dtype=np.float32)
    X = torch.from_numpy(X_host).to(dev)
    X_check = torch.from_numpy(X_host[:N_CHECK])

    def descent(ens):
        return score_ensemble(
            X_check, ens, max_depth=int(tree_depths(ens).max()) + 1
        ).numpy()

    # -- phase 1: QuickScorer kernel against its plain version --------------
    phase("1: qs_score against the plain version and the CPU descent")
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

    # the kernel's other paths: rows too wide to stage in shared memory (read
    # from global memory), a doc count that ends mid-block, and uint8 bin rows
    # against bin-space tables (the warm-start rescore's form)
    rng_x = np.random.default_rng(21)
    ens_wide = random_bestfirst_ensemble(64, 16, 700, seed=8)
    X_wide = rng_x.standard_normal((8192, 700), dtype=np.float32)
    ens_bins = random_bestfirst_ensemble(1000, 16, N_FEATURES, seed=5)
    ens_bins.threshold_bin = torch.from_numpy(
        rng_x.integers(0, 255, size=tuple(ens_bins.threshold.shape)).astype(np.int32))
    bins_host = rng_x.integers(0, 256, size=(N_DOCS, N_FEATURES), dtype=np.uint8)
    # the same trees in value space, their thresholds the bin ids: the CPU
    # descent of these on the bins as float32 is the reference of the u8 entry
    ens_bins_value = dataclasses.replace(ens_bins, threshold=ens_bins.threshold_bin.float())
    qs_extra = {
        "64x16 at 8192 docs x 700 (unstaged)": (
            torch.from_numpy(X_wide).to(dev), ensemble_to_qs(ens_wide).to(dev),
            ens_wide, torch.from_numpy(X_wide[:N_CHECK])),
        "1000x16 at 100003 docs (ends mid-block)": (
            X[:100003], qs_tables[(1000, 16)][1], qs_tables[(1000, 16)][0], X_check),
        "1000x16 on u8 bins": (
            torch.from_numpy(bins_host).to(dev),
            ensemble_to_qs(ens_bins, space="bin").to(dev), ens_bins_value,
            torch.from_numpy(bins_host[:N_CHECK]).float()),
    }
    for label, (feats, tables, ens, feats_check) in qs_extra.items():
        got = kernel_qs.score_qs(feats, tables)
        torch.cuda.synchronize()
        plain = score_qs(feats, tables)
        require(got.shape == (feats.shape[0],) and bool(torch.isfinite(got).all()),
                f"qs_score {label}: bad output")
        qs_err = max(qs_err, float((got - plain).abs().max()))
        require(torch.equal(got, plain), f"qs {label}: kernel and plain version differ on "
                f"{int((got != plain).sum())} of {feats.shape[0]} docs")
        ref = score_ensemble(feats_check, ens, max_depth=int(tree_depths(ens).max()) + 1)
        require(torch.equal(got[:N_CHECK].cpu(), ref),
                f"qs {label}: differs from the CPU descent")
        print(f"  qs {label}: bitwise equal to the plain version and to the CPU descent")

    # trees whose records do not fit one block's shared memory (the wide
    # kernel streams each tree's records in tiles), in value space on float32
    # rows and in bin space on u8 rows, a few trees each
    qs_wide = {}
    for T, leaves, seed in QS_WIDE_CASES:
        ens = random_bestfirst_ensemble(T, leaves, N_FEATURES, seed=seed)
        ens.threshold_bin = torch.from_numpy(
            rng_x.integers(0, 255, size=tuple(ens.threshold.shape)).astype(np.int32))
        spaces = {
            "value": (X[:N_WIDE_DOCS], ens, X_check),
            "u8 bins": (torch.from_numpy(bins_host[:N_WIDE_DOCS]).to(dev),
                        dataclasses.replace(ens, threshold=ens.threshold_bin.float()),
                        torch.from_numpy(bins_host[:N_CHECK]).float()),
        }
        for space, (feats, ref_ens, feats_check) in spaces.items():
            tables = ensemble_to_qs(ens, space="bin" if space == "u8 bins" else "value").to(dev)
            got = kernel_qs.score_qs(feats, tables)
            torch.cuda.synchronize()
            plain = score_qs(feats, tables)
            label = f"{T}x{leaves} leaves at {N_WIDE_DOCS} docs, {space}"
            require(got.shape == (N_WIDE_DOCS,) and bool(torch.isfinite(got).all()),
                    f"qs_score {label}: bad output")
            qs_err = max(qs_err, float((got - plain).abs().max()))
            require(torch.equal(got, plain), f"qs {label}: kernel and plain version differ on "
                    f"{int((got != plain).sum())} of {N_WIDE_DOCS} docs")
            ref = score_ensemble(feats_check, ref_ens, max_depth=int(tree_depths(ens).max()) + 1)
            require(torch.equal(got[:N_CHECK].cpu(), ref),
                    f"qs {label}: differs from the CPU descent")
            print(f"  qs {label}: bitwise equal to the plain version and to the CPU descent")
            qs_wide[(leaves, space)] = (ens, tables, feats)

    # -- phase 2: perfect kernel against its plain version ------------------
    phase("2: perfect_score against the plain version and the CPU descent")
    pf_err = 0.0
    pf_tables = {}
    for T, depth, seed in PERFECT_CASES:
        ens = random_balanced_ensemble(T, depth, N_FEATURES, seed=seed)
        pf_tables[(T, depth)] = (ens, ensemble_to_perfect(ens).to(dev))
    # rows too wide to stage in shared memory (read from global memory) and a
    # doc count that ends mid-block
    ens_pf_wide = random_balanced_ensemble(1000, 4, 700, seed=9)
    pf_extra = {
        "1000xd4 at 8192 docs x 700 (unstaged)": (
            torch.from_numpy(X_wide).to(dev), ensemble_to_perfect(ens_pf_wide).to(dev),
            ens_pf_wide, torch.from_numpy(X_wide[:N_CHECK])),
        "1000xd4 at 100003 docs (ends mid-block)": (
            X[:100003], pf_tables[(1000, 4)][1], pf_tables[(1000, 4)][0], X_check),
    }
    pf_checks = {f"{T}xd{depth}": (X, pe, ens, X_check)
                 for (T, depth), (ens, pe) in pf_tables.items()}
    for label, (feats, pe, ens, feats_check) in {**pf_checks, **pf_extra}.items():
        got = kernel_perfect.score_perfect(feats, pe)
        torch.cuda.synchronize()
        plain = score_perfect(feats, pe)
        require(got.shape == (feats.shape[0],) and bool(torch.isfinite(got).all()),
                f"perfect_score {label}: bad output")
        pf_err = max(pf_err, float((got - plain).abs().max()))
        require(torch.equal(got, plain), f"perfect {label}: kernel and plain version differ "
                f"on {int((got != plain).sum())} of {feats.shape[0]} docs")
        ref = score_ensemble(feats_check, ens, max_depth=int(tree_depths(ens).max()) + 1).numpy()
        err = float(np.abs(got[:N_CHECK].cpu().numpy() - ref).max())
        atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        print(f"  perfect {label}: bitwise equal to the plain version; vs CPU descent max "
              f"abs err {err:.3g} (atol {atol:.3g}, float32 sum vs Kahan)")
        require(err <= atol, f"perfect {label}: {err} > {atol}")

    # -- phase 3: the slice end to end through quickscore -------------------
    phase("3: quickscore end to end")
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
        # a model of trees too wide for one block's shared memory, served
        # through K1's wide kernel
        ens_w, tables_w, _ = qs_wide[(2048, "value")]
        m = LambdaMart()
        m.ensemble = ens_w
        m.save(os.path.join(tmp, "wide.xml"))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = quickscore.main(["-d", svml, "-m", os.path.join(tmp, "wide.xml"),
                                  "--device", "cuda", "-r", "1",
                                  "-s", os.path.join(tmp, "wide.scores")])
        require(rc == 0, f"quickscore on the 2048-leaf model: exit {rc}")
        plains["wide"] = score_qs(Xd, tables_w)
        for name, plain in plains.items():
            got = np.loadtxt(os.path.join(tmp, f"{name}.scores")).astype(np.float32)
            plain = plain.cpu().numpy()
            require(got.shape == (ds.num_docs,) and np.isfinite(got).all(),
                    f"quickscore {name}: bad scores file")
            require(np.array_equal(got, plain),
                    f"quickscore {name}: scores file differs from the plain scorer on "
                    f"{int((got != plain).sum())} of {ds.num_docs} docs")
            print(f"  quickscore {name}: scores file bitwise the plain scorer's")

    # -- phase 4: times ------------------------------------------------------
    phase(f"4: ms per call at {N_DOCS} docs x {N_FEATURES} features "
          f"on {card}")
    times = {}
    for (T, leaves), (_, tables) in qs_tables.items():
        k = time_ms(lambda: kernel_qs.score_qs(X, tables), reps=20)
        p = time_ms(lambda: score_qs(X, tables), reps=3)
        times[("qs", T, leaves)] = (k, p)
        print(f"  qs {T}x{leaves} leaves: kernel {k:.4f} ms "
              f"({N_DOCS / k * 1e3:.4g} docs/s), plain {p:.4f} ms "
              f"({N_DOCS / p * 1e3:.4g} docs/s)")
    for label, (feats, tables, _, _) in qs_extra.items():
        k = time_ms(lambda: kernel_qs.score_qs(feats, tables), reps=20)
        p = time_ms(lambda: score_qs(feats, tables), reps=3)
        print(f"  qs {label}: kernel {k:.4f} ms ({feats.shape[0] / k * 1e3:.4g} docs/s), "
              f"plain {p:.4f} ms")
    del qs_extra
    for (T, depth), (_, pe) in pf_tables.items():
        k = time_ms(lambda: kernel_perfect.score_perfect(X, pe), reps=20)
        p = time_ms(lambda: score_perfect(X, pe), reps=3)
        times[("perfect", T, depth)] = (k, p)
        print(f"  perfect {T}xd{depth}: kernel {k:.4f} ms "
              f"({N_DOCS / k * 1e3:.4g} docs/s), plain {p:.4f} ms "
              f"({N_DOCS / p * 1e3:.4g} docs/s)")
    for label, (feats, pe, _, _) in pf_extra.items():
        k = time_ms(lambda: kernel_perfect.score_perfect(feats, pe), reps=20)
        p = time_ms(lambda: score_perfect(feats, pe), reps=3)
        print(f"  perfect {label}: kernel {k:.4f} ms ({feats.shape[0] / k * 1e3:.4g} docs/s), "
              f"plain {p:.4f} ms")
    del pf_extra
    # the bar K2 is held to: K1 on the same depth-4 ensemble, in this call
    e_pf, t_pf = pf_tables[(1000, 4)]
    t_pf_qs = ensemble_to_qs(e_pf).to(dev)
    require(torch.equal(kernel_qs.score_qs(X, t_pf_qs), score_qs(X, t_pf_qs)),
            "qs on the depth-4 ensemble: kernel and plain version differ")
    k2_ms = time_ms(lambda: kernel_perfect.score_perfect(X, t_pf), reps=20)
    k1_ms = time_ms(lambda: kernel_qs.score_qs(X, t_pf_qs), reps=20)
    print(f"  1000 balanced depth-4 trees at {N_DOCS} x {N_FEATURES}: perfect_score "
          f"{k2_ms:.4f} ms, qs_score {k1_ms:.4f} ms on the same ensemble "
          f"(perfect / qs {k2_ms / k1_ms:.3f})")
    require(k2_ms <= k1_ms, f"perfect_score {k2_ms:.4f} ms is slower than qs_score "
            f"{k1_ms:.4f} ms on the same ensemble")
    del t_pf_qs
    for (leaves, space), (e_w, t_w, feats) in qs_wide.items():
        k = time_ms(lambda: kernel_qs.score_qs(feats, t_w), reps=5)
        b = bound_ms(nbytes_of(feats, t_w.packed()) + N_WIDE_DOCS * 4,
                     N_WIDE_DOCS * float((mean_leaf_depths(e_w) + 4).sum()))
        times[("qs wide", leaves, space)] = (k, b)
        print(f"  qs {e_w.num_trees}x{leaves} leaves at {N_WIDE_DOCS} docs, {space}: kernel "
              f"{k:.4f} ms, bound {b[0]:.4f} ms by {b[1]}")
    del qs_wide

    e_qs, t_qs = qs_tables[(1000, 16)]
    qs_bound = bound_ms(
        nbytes_of(X, t_qs.packed()) + N_DOCS * 4,
        # what the function needs, not what QuickScorer does: per doc and
        # tree one compare a level of the path to a leaf (the trees' mean
        # leaf depth), and 4 for Kahan
        N_DOCS * float((mean_leaf_depths(e_qs) + 4).sum()))
    pf_bound = bound_ms(nbytes_of(X, t_pf.fid, t_pf.thr, t_pf.wleaf) + N_DOCS * 4,
                        N_DOCS * t_pf.fid.shape[0] * (t_pf.depth + 1))
    print(f"  bounds: qs 1000x16 {qs_bound[0]:.4f} ms by {qs_bound[1]}, perfect 1000xd4 "
          f"{pf_bound[0]:.4f} ms by {pf_bound[1]}")

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
    phase(f"5: histogram kernels against the plain versions on "
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
    vt2 = vt[:2].contiguous()
    k4_cases = [("256 bins, k=1 (root)", binned, vt, 256, pos_root, 0, 1),
                ("64 bins, k=1 (half the docs)", bins64, vt, 64,
                 torch.where(sub, 0, 1).to(torch.int32), 0, 1),
                ("256 bins, k=10, n0=3", binned, vt, 256, pos_nodes, 3, 10),
                ("64 bins, k=10, n0=3", bins64, vt, 64, pos_nodes, 3, 10),
                # the oblivious grower's levels: two channels, 8 and 16 nodes a
                # pass (32 KB and 64 KB of shared memory a feature at 256 bins)
                ("256 bins, C=2, k=8", binned, vt2, 256, pos_nodes, 0, 8),
                ("256 bins, C=2, k=16", binned, vt2, 256, pos_nodes, 0, 16)]
    # a best-first split's pass: the smaller child's docs, a tenth of all,
    # scattered over the matrix (0 in the node, 1 outside), and the same docs
    # gathered into a contiguous run, as the node-clustered layout holds them
    tenth = td.step.doc_mask & (torch.rand(N, generator=gen).to(dev) < 0.1)
    tenth_rows = tenth.nonzero()[:, 0]
    scattered, as_run = "256 bins, k=1, a tenth of the docs, scattered", \
        "256 bins, k=1, the same docs as a run"
    k4_cases += [
        (scattered, binned, vt, 256, torch.where(tenth, 0, 1).to(torch.int32), 0, 1),
        (as_run, binned[tenth_rows].contiguous(), vt[:, tenth_rows].contiguous(), 256,
         torch.zeros(tenth_rows.shape[0], dtype=torch.int32, device=dev), 0, 1)]
    k4_times = {}
    for label, b, v, nb, pos, n0, k in k4_cases:
        C = v.shape[0]
        got = kernel_histogram.node_histogram(b, v, pos, nb, n0, k)
        again = kernel_histogram.node_histogram(b, v, pos, nb, n0, k)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"K4 {label}: two launches differ")
        # the kernel's own arithmetic in plain torch: equal bit for bit
        fixed = kernel_histogram.node_histogram_fixed(b, v, pos, nb, n0, k)
        require(torch.equal(got, fixed), f"K4 {label}: differs from node_histogram_fixed "
                f"in {int((got != fixed).sum())} cells")
        plain = kernel_histogram.node_histogram_plain(b, v, pos, nb, n0, k)
        v64 = v.double()
        exact, mass, terms = (
            kernel_histogram.node_histogram_plain(b, x, pos, nb, n0, k)
            for x in (v64, v64.abs(), torch.ones_like(v64)))
        rounding = kernel_histogram.rounding_error(v).repeat(k)
        hist_err["node_histogram"] = max(hist_err["node_histogram"], check_histogram(
            f"K4 {label}", got, plain, exact, mass, terms, slice(0, None, C), rounding))
        k4_times[label] = (
            time_ms(lambda: kernel_histogram.node_histogram(b, v, pos, nb, n0, k), reps=20),
            time_ms(lambda: kernel_histogram.node_histogram_plain(b, v, pos, nb, n0, k),
                    reps=3),
        )
    n_root = int(td.step.doc_mask.sum())
    k4_bound = bound_ms(n_root * W + nbytes_of(vt, pos_root) + W * 256 * 3 * 4,
                        n_root * W * 3)  # one add per doc, feature and channel
    slots = torch.randint(0, 32, (N, 1), generator=gen, dtype=torch.int32).to(dev)
    vals = torch.stack([g, torch.rand(N, generator=gen).to(dev)], dim=-1).contiguous()
    got = kernel_histogram.histogram(slots, vals, 32)
    again = kernel_histogram.histogram(slots, vals, 32)
    torch.cuda.synchronize()
    require(torch.equal(got, again), "K5: two launches differ")
    require(torch.equal(got, kernel_histogram.node_histogram_fixed(
        slots, vals.T.contiguous(), None, 32, 0, 1)), "K5: differs from node_histogram_fixed")
    plain = kernel_histogram.histogram_plain(slots, vals, 32)
    v64 = vals.double()
    exact, mass, terms = (kernel_histogram.histogram_plain(slots, v, 32)
                          for v in (v64, v64.abs(), torch.ones_like(v64)))
    hist_err["histogram"] = check_histogram(
        "K5 32 slots, C=2", got, plain, exact, mass, terms, slice(0, 0),
        kernel_histogram.rounding_error(vals.T))
    k5_times = (time_ms(lambda: kernel_histogram.histogram(slots, vals, 32), reps=20),
                time_ms(lambda: kernel_histogram.histogram_plain(slots, vals, 32), reps=3))
    k5_bound = bound_ms(nbytes_of(slots, vals) + 32 * 2 * 4, N * 2)
    # the one PyTorch call that computes K5's function; timed, never used
    slot_ids = slots[:, 0].long()
    k5_library = time_ms(
        lambda: torch.zeros((32, 2), device=dev).index_add_(0, slot_ids, vals), reps=20)
    lib = torch.zeros((32, 2), device=dev).index_add_(0, slot_ids, vals)
    require(bool(((lib - got[0]).abs() <= 1e-4 * mass[0].float() + 1e-6).all()),
            "K5: index_add_ disagrees with the kernel")
    print(f"  ms per call on {card} (kernel / plain on the card):")
    for label, (k_ms, p_ms) in k4_times.items():
        print(f"    K4 {label}: {k_ms:.4f} / {p_ms:.4f}")
    print(f"    K5 32 slots, C=2: {k5_times[0]:.4f} / {k5_times[1]:.4f}; index_add_ "
          f"{k5_library:.4f}")
    print(f"  every K4 and K5 case equals node_histogram_fixed bit for bit; the scattered "
          f"tenth ({tenth_rows.shape[0]} docs) takes "
          f"{k4_times[scattered][0] / k4_times[as_run][0]:.2f}x the same docs as a run")
    print(f"  bounds: K4 root {k4_bound[0]:.4f} ms by {k4_bound[1]}, K5 {k5_bound[0]:.4f} "
          f"ms by {k5_bound[1]}")
    del td, binned, bins64, g, vt, vt2, sub, pos_root, pos_nodes, slots, vals, slot_ids
    del k4_cases, tenth, tenth_rows

    # -- phase 6: LambdaMART training at full width, both growers ----------
    phase(f"6: LambdaMART, {TRAIN_TREES} trees, {train_ds.num_queries} train "
          f"+ {valid_ds.num_queries} valid queries, on {card}")
    from quickrank_tpu_torch.learning.base import LTRAlgorithm
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.trees import grow

    from quickrank_tpu_torch.ops import kernel_query_sum

    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    kernel_query_sum.LAUNCHES = 0
    train_runs = {}

    def report_run(name, lm, hist):
        """s/tree (median of iterations 2+), splits and host syncs per tree."""
        it = hist["iter_seconds"]
        per_tree = float(np.median(it[2:]))
        splits = (~lm.ensemble.is_leaf).sum(dim=1).tolist()
        print(f"  {name}: {per_tree:.4f} s/tree (median of iterations 2+; "
              f"all: {[round(x, 4) for x in it]}), splits per tree {splits}, host syncs "
              f"per tree {grow.HOST_SYNCS / len(it):.2f}, init {hist['init_seconds']:.2f} s")
        return per_tree

    for growth in ("best", "level"):
        lm = LambdaMart(ntrees=TRAIN_TREES, nleaves=16, nthresholds=255, growth=growth,
                        max_depth=4 if growth == "level" else 0, seed=1, esr=100)
        grow.HOST_SYNCS = 0
        hist = lm.learn(train_ds, valid_ds, Ndcg(10), verbose=False)
        per_tree = report_run(f"{growth}@255", lm, hist)
        train_runs[growth] = (lm, per_tree)
        print(f"    train NDCG@10 {[round(x, 5) for x in hist['train']]}")
        print(f"    valid NDCG@10 {[round(x, 5) for x in hist['valid']]}, best "
              f"iteration {lm.best_iteration}")
        require(hist["train"][-1] > hist["train"][0],
                f"{growth}: train NDCG@10 did not rise")
    train_launches = dict(kernel_histogram.LAUNCHES)
    qsum_launches = kernel_query_sum.LAUNCHES
    print(f"  histogram kernel launches during training: {train_launches}; query_sum "
          f"{qsum_launches}")
    require(all(v > 0 for v in train_launches.values()),
            f"a histogram kernel of the training path was not launched: {train_launches}")
    require(qsum_launches > 0, "query_sum was not launched during training")

    # the fixed-order query sum (not a TPU kernel) at the shapes training gives
    # it: a metric's per-query DCG terms [Q, D] and the banded lambda pairs
    # [chunk, 10, D] summed over both axes; bitwise its plain version
    Q_, D_ = train_ds.num_queries, train_ds.max_docs_per_query
    g_ = torch.Generator(device=dev).manual_seed(6)
    qsum_cases = {f"[{Q_}, {D_}] dim -1 (a metric's terms)":
                  (torch.rand((Q_, D_), device=dev, generator=g_), -1)}
    chunk_ = max(1, (45 << 20) // (4 * 10 * D_))
    pairs_ = torch.randn((chunk_, 10, D_), device=dev, generator=g_)
    qsum_cases[f"[{chunk_}, 10, {D_}] dim -1 (lambda pairs)"] = (pairs_, -1)
    qsum_cases[f"[{chunk_}, 10, {D_}] dim -2 (lambda pairs)"] = (pairs_, -2)
    qsum_times = {}
    for label, (x_, dim_) in qsum_cases.items():
        got_ = kernel_query_sum.query_sum(x_, dim_)
        want_ = kernel_query_sum.pairwise_sum(x_, dim_)
        require(torch.equal(got_.view(torch.int32), want_.view(torch.int32)),
                f"query_sum {label}: not bitwise its plain version")
        f64_ = torch.sum(x_, dim=dim_, dtype=torch.float64).float()
        ms_ = time_ms(lambda: kernel_query_sum.query_sum(x_, dim_), reps=20)
        plain_ = time_ms(lambda: kernel_query_sum.pairwise_sum(x_, dim_), reps=3)
        f64_ms = time_ms(lambda: torch.sum(x_, dim=dim_, dtype=torch.float64).float(), reps=20)
        lib_ = time_ms(lambda: torch.sum(x_, dim=dim_), reps=20)
        L_ = x_.shape[dim_]
        bnd_ = bound_ms(nbytes_of(x_, got_), got_.numel() * (L_ - 1))
        qsum_times[label] = (ms_, plain_, f64_ms, lib_, bnd_,
                             float((got_.double() - f64_.double()).abs().max()))
        print(f"  query_sum {label}: bitwise its plain version; {ms_:.4f} ms (plain "
              f"{plain_:.4f}, the float64 sum it replaces {f64_ms:.4f}, torch.sum {lib_:.4f}; "
              f"bound {bnd_[0]:.4f} ms by {bnd_[1]}); max |kernel - float64 sum| "
              f"{qsum_times[label][5]:.3g}")
    del pairs_, qsum_cases, got_, want_, f64_
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
    phase(f"7: {CPU_TREES}-tree runs on {CPU_QUERIES} queries, card against CPU")
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


    # -- phase 8: the oblivious bit-OR kernel against its plain version ----
    phase("8: oblivious_score against the plain version and the CPU descent")
    from quickrank_tpu_torch.ops import oblivious as plain_oblivious
    from quickrank_tpu_torch.trees.oblivious import FLT_MAX, oblivious_to_tree
    from quickrank_tpu_torch.trees.structs import EnsembleTensors

    def descent_of_oblivious(obl, feats):
        """Compensated CPU descent of the perfect trees the level tables
        stand for, on the first N_CHECK docs."""
        ens = EnsembleTensors.empty(obl.num_trees, 2 * obl.num_leaves - 1)
        for t in range(obl.num_trees):
            ens.push(oblivious_to_tree(obl.fid[t], obl.thr[t], obl.thr_bin[t], obl.leaf[t]),
                     float(obl.weight[t]))
        return score_ensemble(feats[:N_CHECK], ens, max_depth=obl.depth + 1).numpy()

    obl_err = 0.0
    obl_times = {}
    obl_bound = None
    for T, depth, n_docs, n_feat in OBLIVIOUS_CASES:
        feats, obl = random_oblivious_ensemble(T, depth, n_feat, seed=0, num_docs=n_docs)
        if depth == 3:  # dead levels: the last level of every other tree, and tree 1
            obl.thr[::2, -1] = FLT_MAX
            obl.thr[1] = FLT_MAX
        Xo, obl_dev = torch.from_numpy(feats).to(dev), obl.to(dev)
        got = kernel_oblivious.score_oblivious(Xo, obl_dev)
        plain = plain_oblivious.score_oblivious(Xo, obl_dev)
        torch.cuda.synchronize()
        require(got.shape == (n_docs,) and bool(torch.isfinite(got).all()),
                "oblivious_score: bad output")
        require(torch.equal(got, plain), f"oblivious {T}xd{depth}: kernel and plain version "
                f"differ on {int((got != plain).sum())} of {n_docs} docs")
        obl_err = max(obl_err, float((got - plain).abs().max()))
        ref = descent_of_oblivious(obl, torch.from_numpy(feats))
        err = float(np.abs(got[:N_CHECK].cpu().numpy() - ref).max())
        atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        print(f"  oblivious {T}xd{depth} at {n_docs} docs x {n_feat}: bitwise equal to the plain version; "
              f"vs CPU descent max abs err {err:.3g} (atol {atol:.3g}, float32 sum vs Kahan)")
        require(err <= atol, f"oblivious {T}xd{depth}: {err} > {atol}")
        k = time_ms(lambda: kernel_oblivious.score_oblivious(Xo, obl_dev), reps=20)
        p = time_ms(lambda: plain_oblivious.score_oblivious(Xo, obl_dev), reps=3)
        obl_times[(T, depth)] = (k, p)
        bound = bound_ms(nbytes_of(Xo, obl_dev.fid, obl_dev.thr, obl_dev.leaf) + n_docs * 4,
                         n_docs * T * (depth + 1))  # a compare a level, one add
        obl_bound = obl_bound or bound
        print(f"    kernel {k:.4f} ms ({n_docs / k * 1e3:.4g} docs/s), plain {p:.4f} ms, "
              f"bound {bound[0]:.4f} ms by {bound[1]}")
    # bin space on u8: thresholds are bin ids, routing is bin > thr_bin
    rng8 = np.random.default_rng(8)
    bins = torch.from_numpy(rng8.integers(0, 256, size=(N_DOCS, N_FEATURES), dtype=np.uint8))
    _, obl = random_oblivious_ensemble(1000, 4, N_FEATURES, seed=0, num_docs=1)
    obl.thr_bin = torch.from_numpy(rng8.integers(0, 255, size=(1000, 4)).astype(np.int32))
    bins_dev, obl_dev = bins.to(dev), obl.to(dev)
    got = kernel_oblivious.score_oblivious(bins_dev, obl_dev)
    plain = plain_oblivious.score_oblivious_binned(bins_dev, obl_dev)
    require(torch.equal(got, plain), "oblivious bin space: kernel and plain version differ")
    k = time_ms(lambda: kernel_oblivious.score_oblivious(bins_dev, obl_dev), reps=20)
    print(f"  oblivious 1000xd4 on u8 bins: bitwise equal to the plain version; kernel "
          f"{k:.4f} ms")
    del Xo, bins_dev, obl_dev, got, plain

    # -- phase 9: the oblivious slice end to end at full width --------------
    phase(f"9: ObliviousLambdaMART depth 4, {TRAIN_TREES} trees, "
          f"{train_ds.num_queries} train + {valid_ds.num_queries} valid queries, saved and "
          f"served through quickscore, on {card}")
    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    grow.HOST_SYNCS = 0
    ol = ObliviousLambdaMart(ntrees=TRAIN_TREES, treedepth=4, nthresholds=255, seed=1,
                             esr=100)
    hist = ol.learn(train_ds, valid_ds, Ndcg(10), verbose=False)
    obl_launches = dict(kernel_histogram.LAUNCHES)
    obl_per_tree = report_run("oblivious@255 depth 4", ol, hist)
    print(f"    train NDCG@10 {[round(x, 5) for x in hist['train']]}")
    print(f"    valid NDCG@10 {[round(x, 5) for x in hist['valid']]}, best iteration "
          f"{ol.best_iteration}; histogram kernel launches {obl_launches}")
    require(hist["train"][-1] > hist["train"][0], "oblivious: train NDCG@10 did not rise")
    require(all(v > 0 for v in obl_launches.values()),
            f"a histogram kernel of the oblivious path was not launched: {obl_launches}")
    with tempfile.TemporaryDirectory() as tmp:
        path, svml = os.path.join(tmp, "obv.xml"), os.path.join(tmp, "serve.svml")
        ol.save(path)
        serve_ds = make_ranking_dataset(num_queries=1000, avg_docs_per_query=116,
                                        num_features=N_FEATURES, seed=0)
        write_svml(serve_ds, svml)
        kernel_oblivious.LAUNCHES = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = quickscore.main(["-d", svml, "-m", path, "--device", "cuda", "-r", "10",
                                  "-s", os.path.join(tmp, "obv.scores")])
        k3_launches = kernel_oblivious.LAUNCHES
        print("".join(f"    {line}\n" for line in out.getvalue().splitlines()), end="")
        require(rc == 0, f"quickscore on the oblivious model: exit {rc}")
        require("Scorer path: oblivious bit-OR kernel on cuda" in out.getvalue(),
                "quickscore did not take the oblivious path")
        print(f"  oblivious_score launches during quickscore: {k3_launches}")
        require(k3_launches > 0, "the oblivious kernel was not launched by quickscore")
        served = np.loadtxt(os.path.join(tmp, "obv.scores")).astype(np.float32)
        model = LTRAlgorithm.load(path)
        require(type(model) is ObliviousLambdaMart and model.scorer_path() == "oblivious",
                "the saved model did not load as an oblivious model")
        want = plain_oblivious.score_oblivious(
            torch.from_numpy(read_svml(svml).features).to(dev),
            model.oblivious_ensemble().to(dev)).cpu().numpy()
        require(served.shape == (serve_ds.num_docs,) and np.array_equal(served, want),
                "quickscore's oblivious scores differ from the plain version")
        scored = model.score_dataset(train_ds)
        carried = ol.train_scores[: train_ds.num_docs].cpu().numpy()
        err = float(np.abs(scored - carried).max())
        atol = 1e-5 * max(1.0, float(np.abs(carried).max()))
        print(f"  carried scores vs K3 of the saved model: max abs err {err:.3g} "
              f"(atol {atol:.3g}, float32 sum vs Kahan)")
        require(np.isfinite(scored).all() and err <= atol, f"oblivious: {err} > {atol}")

    # -- phase 10: best-k growth beside best-first --------------------------
    phase(f"10: LambdaMART bestk@255, split_pack 4, {TRAIN_TREES} trees at "
          f"{train_ds.num_queries} queries (best-first above: "
          f"{train_runs['best'][1]:.4f} s/tree)")
    grow.HOST_SYNCS = 0
    bk = LambdaMart(ntrees=TRAIN_TREES, nleaves=16, nthresholds=255, growth="bestk",
                    split_pack=4, seed=1, esr=100)
    hist = bk.learn(train_ds, valid_ds, Ndcg(10), verbose=False)
    bestk_per_tree = report_run("bestk@255 split_pack 4", bk, hist)
    print(f"    train NDCG@10 {[round(x, 5) for x in hist['train']]}")
    print(f"    valid NDCG@10 {[round(x, 5) for x in hist['valid']]}")
    require(hist["train"][-1] > hist["train"][0], "bestk: train NDCG@10 did not rise")
    pair = []
    for kw in (dict(growth="best"), dict(growth="bestk", split_pack=1)):
        lm = LambdaMart(ntrees=CPU_TREES, nleaves=16, nthresholds=255, seed=1, **kw)
        lm.learn(small, None, Ndcg(10), verbose=False)
        pair.append(lm.ensemble)
    same = all(torch.equal(getattr(pair[0], f), getattr(pair[1], f))
               for f in ("feature", "threshold", "threshold_bin", "left", "right",
                         "is_leaf", "leaf_value"))
    print(f"  split_pack 1 against best-first on the card, {CPU_TREES} trees at "
          f"{CPU_QUERIES} queries: trees equal: {same}")
    require(same, "bestk with split_pack 1 differs from best-first on the card")

    # -- phase 11: warm start, rescoring through K1 in bin space ------------
    phase(f"11: warm start at {train_ds.num_queries} queries, 4 trees and then 4 more")
    from quickrank_tpu_torch.learning.mart import rebin_ensemble, rescore_binned

    kw = dict(nleaves=16, nthresholds=255, seed=1)
    ws = LambdaMart(ntrees=4, **kw)
    ws.learn(train_ds, None, Ndcg(10), verbose=False)
    carried = ws.train_scores.clone()
    td = TrainData.build(train_ds, 255)
    kernel_qs.LAUNCHES = 0
    rebinned = rebin_ensemble(ws.ensemble, td.thresholds, force=True)
    rescored = rescore_binned(rebinned, td.step, ws._descend_depth())
    ms = time_ms(lambda: rescore_binned(ws.ensemble, td.step, ws._descend_depth()), reps=3)
    require(kernel_qs.LAUNCHES > 0, "the rescore did not launch the QuickScorer kernel")
    n_diff = int((rescored != carried).sum())
    print(f"  rescore of 4 trees on the u8 bin matrix {tuple(td.step.binned.shape)} through "
          f"qs_score: {n_diff} docs differ from the carried scores; {ms:.4f} ms with the "
          f"table build")
    require(n_diff == 0, "the warm-start rescore differs from the carried scores")
    # the u8 entry of the kernel against its own plain version, on the same
    # bin matrix and bin-space tables
    plain = score_qs(td.step.binned, ensemble_to_qs(rebinned, space="bin").to(dev))
    require(torch.equal(rescored, plain), "qs_score on u8 bins: kernel and plain version "
            f"differ on {int((rescored != plain).sum())} docs")
    print("  qs_score on the u8 bin matrix: bitwise equal to the plain version")
    del td, rescored, plain
    kernel_qs.LAUNCHES = 0
    ws.ntrees = TRAIN_TREES
    resumed = ws.learn(train_ds, None, Ndcg(10), verbose=False, warm_start=True)
    warm_launches = kernel_qs.LAUNCHES
    whole = LambdaMart(ntrees=TRAIN_TREES, **kw)
    straight = whole.learn(train_ds, None, Ndcg(10), verbose=False)
    diff = float(np.abs(np.array(resumed["train"]) - np.array(straight["train"][4:])).max())
    print(f"  resumed run: {len(resumed['train'])} new iterations, {ws.ensemble.num_trees} "
          f"trees, qs_score launches {warm_launches}; train NDCG@10 "
          f"{[round(x, 6) for x in resumed['train']]} against the uninterrupted run's "
          f"{[round(x, 6) for x in straight['train'][4:]]} (max difference {diff:.3g})")
    require(warm_launches > 0, "the warm start did not rescore through the QuickScorer kernel")
    require(ws.ensemble.num_trees == TRAIN_TREES and len(resumed["train"]) == 4,
            "the warm start did not continue from the model")
    require(diff <= 1e-4, f"warm start: train NDCG@10 differs by {diff}")

    # -- phase 12: the oblivious learner, card against CPU ------------------
    phase(f"12: ObliviousLambdaMART, {CPU_TREES} trees on {CPU_QUERIES} queries, card "
          f"against CPU")
    runs = {}
    for device in ("cuda", "cpu"):
        om = ObliviousLambdaMart(ntrees=CPU_TREES, treedepth=4, nthresholds=255, seed=1)
        runs[device] = (om, om.learn(small, None, Ndcg(10), verbose=False, device=device))
    (gpu_m, gpu_h), (cpu_m, cpu_h) = runs["cuda"], runs["cpu"]
    levels = [(m.oblivious_ensemble().fid[0].tolist(), m.oblivious_ensemble().thr_bin[0].tolist())
              for m in (gpu_m, cpu_m)]
    diff = float(np.abs(np.array(gpu_h["train"]) - np.array(cpu_h["train"])).max())
    print(f"  first tree's levels (features, bins): card {levels[0]}, cpu {levels[1]}; max "
          f"train NDCG@10 difference {diff:.3g} over {CPU_TREES} iterations")
    require(levels[0] == levels[1], "oblivious: the first tree's levels differ")
    require(diff <= 1e-3, f"oblivious: train NDCG@10 differs by {diff}")


    # -- phase 13: the row-partition kernel against its plain version -------
    from quickrank_tpu_torch.ops import kernel_partition
    from quickrank_tpu_torch.ops.histogram import masked_histogram_t
    from quickrank_tpu_torch.trees import grow_cluster

    td = TrainData.build(train_ds, 255)
    binned = td.step.binned
    N, W = binned.shape
    F_real = td.num_real_features
    cfg = grow.GrowConfig(nleaves=16, min_leaf_support=1, num_bins=256,
                          num_real_features=F_real)
    n_work = grow_cluster.work_rows(N, cfg.max_nodes)
    T_w = n_work // kernel_partition.TILE
    pos_col = W + grow_cluster._POS
    phase(f"13: partition_rows against the plain version on the {n_work} x {W} u8 "
          f"work buffer ({T_w} tiles) of {N} docs, on {card}")
    gen = torch.Generator(device="cpu").manual_seed(13)
    # integer pseudoresponses: every histogram sum is exact in the kernels'
    # fixed point, so the clustered and the dataset-order tree must be equal
    g_int = torch.randint(-8, 9, (N,), generator=gen).float().to(dev)
    thr_dev = torch.from_numpy(td.thresholds)

    def split_bits(data, fstar, tstar):
        """Routing bits of every row from per-tile (feature, bin) splits: what
        the kernel recomputes and the plain version is given."""
        tile = torch.arange(data.shape[0], device=dev) // kernel_partition.TILE
        left = data.gather(1, fstar[tile].long()[:, None])[:, 0].int() <= tstar[tile]
        return torch.where(data[:, pos_col] > 0, torch.where(left, 0, 1), 2).to(torch.int32)

    def check_partition(label, data, mode, dsta, dstb, sz, so, fstar, tstar):
        """Kernel against plain version, byte for byte; (kernel ms, plain ms,
        row-scatter ms, bound, largest byte difference)."""
        bit = split_bits(data, fstar, tstar)
        out = torch.empty_like(data)
        run = lambda: kernel_partition.partition_rows(  # noqa: E731
            data, None, mode, dsta, dstb, sz, so, pos_col, fstar=fstar, tstar=tstar, out=out)
        plain_fn = lambda: kernel_partition.partition_rows_plain(  # noqa: E731
            data, bit, mode, dsta, dstb, sz, so, pos_col)
        got, plain = run(), plain_fn()
        torch.cuda.synchronize()
        differs = got != plain
        n_diff = int(differs.any(dim=1).sum())
        byte_err = max(int((got[r:r + (1 << 20)].int() - plain[r:r + (1 << 20)].int())
                           .abs().max()) for r in range(0, n_work, 1 << 20))
        modes = torch.bincount(mode, minlength=3).tolist()
        live = int((got[:, pos_col] > 0).sum())
        print(f"  {label}: tiles copy/move/dead {modes}, {live} live rows out, {n_diff} rows "
              f"differ from the plain version, largest byte difference {byte_err}")
        require(n_diff == 0 and byte_err == 0, f"partition_rows {label}: {n_diff} rows differ")
        require(live == int(((mode[torch.arange(n_work, device=dev) // 1024] != 2)
                             & (data[:, pos_col] > 0)).sum()),
                f"partition_rows {label}: live rows were lost")
        k_ms = time_ms(run, reps=20)
        p_ms = time_ms(plain_fn, reps=3)
        # the nearest library figure: the row scatter alone, destinations given
        dest, _ = kernel_partition.row_destinations(data, bit, mode, dsta, dstb, sz, so,
                                                    pos_col)
        keep = (dest < n_work).nonzero()[:, 0]
        rows, dest = data[keep], dest[keep]
        s_ms = time_ms(lambda: out.index_copy_(0, dest, rows), reps=10)
        moved = int((mode == kernel_partition.MODE_MOVE).sum()) * kernel_partition.TILE
        bound = bound_ms(2 * nbytes_of(data) + nbytes_of(mode, dsta, dstb, sz, so, fstar, tstar),
                         2 * moved)  # a liveness test and a compare a moved row
        print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, row scatter alone "
              f"(index_copy_, destinations given) {s_ms:.4f} ms, bound {bound[0]:.4f} ms by "
              f"{bound[1]}")
        return k_ms, p_ms, s_ms, bound, byte_err

    full = lambda v: torch.full((T_w,), v, dtype=torch.int32, device=dev)  # noqa: E731
    # (a) and (b): the root split and a mid-tree split, taken from the grower
    captured = {}
    real_partition = grow_cluster.partition_rows

    def capture(data, bit, mode, dsta, dstb, sz, so, pc, fstar=None, tstar=None, out=None):
        k = len(captured)
        if k in (0, 7):
            captured[k] = (data.clone() if k else None, mode, dsta, dstb, sz, so, fstar, tstar)
        else:
            captured[k] = None
        return real_partition(data, bit, mode, dsta, dstb, sz, so, pc, fstar=fstar,
                              tstar=tstar, out=out)

    grow_cluster.partition_rows = capture
    try:
        ctree, cnode = grow_cluster.fit_tree_clustered(binned, g_int, td.step.doc_mask,
                                                       thr_dev, cfg)
    finally:
        grow_cluster.partition_rows = real_partition
    require(len(captured) == 15, f"the clustered tree took {len(captured)} splits, not 15")
    work0 = grow_cluster.build_work_buffer(binned, g_int, td.step.doc_mask, n_work)
    k6_runs = [check_partition("root split (every data tile MOVE)", work0, *captured[0][1:])]
    require(int((captured[0][1] == kernel_partition.MODE_MOVE).sum()) == N // 1024,
            "the root split does not move every data tile")
    mid = captured[7]
    k6_runs.append(check_partition("split 8 of the tree (from the grower)", *mid))

    # K4 as the clustered grower calls it (a row range of the work buffer,
    # f_used = the real features, payload bytes in the pad columns, channel
    # values rebuilt from the payload) against its plain version
    def hold_k4(label, rows, chan, mask):
        pos = torch.where(mask, 0, 1).to(torch.int32)
        got = masked_histogram_t(rows, chan, mask, 256, f_used=F_real)
        plain = kernel_histogram.node_histogram_plain(rows, chan, pos, 256, 0, 1, f_used=F_real)
        c64 = chan.double()
        exact, mass, terms = (
            kernel_histogram.node_histogram_plain(rows, x, pos, 256, 0, 1, f_used=F_real)
            for x in (c64, c64.abs(), torch.ones_like(c64)))
        require(got.shape == (F_real, 256, 3), f"K4 {label}: shape {tuple(got.shape)}")
        require(torch.equal(got, kernel_histogram.node_histogram_fixed(
            rows, chan, pos, 256, 0, 1, f_used=F_real)),
            f"K4 {label}: differs from node_histogram_fixed")
        hist_err["node_histogram"] = max(hist_err["node_histogram"], check_histogram(
            f"K4 {label}", got, plain, exact, mass, terms, slice(0, None, 3),
            kernel_histogram.rounding_error(chan)))
        return got

    chan_root, pos_r, live_r = grow_cluster._channels(work0[:N])
    hold_k4(f"clustered root ({N} rows, f_used={F_real})", work0[:N], chan_root,
            (pos_r == 0) & live_r)
    mid_data, mid_mode, fs, ts = mid[0], mid[1], int(mid[6][0]), int(mid[7][0])
    move_tiles = (mid_mode == kernel_partition.MODE_MOVE).nonzero()[:, 0]
    r0, r1 = int(move_tiles[0]) * 1024, (int(move_tiles[-1]) + 1) * 1024
    chan_t, _, live = grow_cluster._channels(mid_data)
    in_run = torch.zeros(n_work, dtype=torch.bool, device=dev)
    in_run[r0:r1] = True
    to_left = in_run & live & (mid_data[:, fs] <= ts)
    run_args = (mid_data[r0:r1], chan_t[:, r0:r1].contiguous(), to_left[r0:r1].contiguous())
    h_run = hold_k4(f"split 8's run ({r1 - r0} rows, f_used={F_real})", *run_args)
    # the same run with float gradients, where the fixed point does round
    g_f = torch.randn(r1 - r0, generator=gen).to(dev) * run_args[1][0]
    hold_k4("split 8's run, float gradients", run_args[0],
            torch.stack([run_args[1][0], g_f, g_f * g_f]), run_args[2])
    # K4 over the splitting node's run alone against K4 over the whole buffer;
    # integer gradients are exact in the fixed point at either launch's scale
    h_all = hold_k4(f"split 8 over the whole buffer ({n_work} rows)", mid_data, chan_t, to_left)
    require(torch.equal(h_run, h_all),
            "K4 over the run and over the whole buffer differ on integer gradients")
    k4_run_ms = time_ms(lambda: masked_histogram_t(*run_args, 256, f_used=F_real), reps=20)
    k4_all_ms = time_ms(lambda: masked_histogram_t(mid_data, chan_t, to_left, 256,
                                                   f_used=F_real), reps=20)
    print(f"  K4 for split 8's left child ({int(to_left.sum())} docs of a run of {r1 - r0} "
          f"rows): {k4_run_ms:.4f} ms over the run, {k4_all_ms:.4f} ms over the whole "
          f"buffer; the two histograms are equal")
    # (c) randomized: per-tile modes, splits and stamps, dead rows in MOVE tiles
    rnd = work0.clone()
    rnd[(torch.rand(n_work, generator=gen) < 0.1).to(dev), pos_col] = 0
    mode = torch.where(torch.arange(T_w) < N // 1024,
                       torch.randint(0, 3, (T_w,), generator=gen), 2).to(torch.int32).to(dev)
    fstar = torch.randint(0, F_real, (T_w,), generator=gen, dtype=torch.int32).to(dev)
    tstar = torch.randint(0, 256, (T_w,), generator=gen, dtype=torch.int32).to(dev)
    sz = torch.randint(1, 256, (T_w,), generator=gen, dtype=torch.int32).to(dev)
    so = torch.randint(1, 256, (T_w,), generator=gen, dtype=torch.int32).to(dev)
    bit = split_bits(rnd, fstar, tstar).view(T_w, 1024)
    is_move, is_copy = mode == kernel_partition.MODE_MOVE, mode == kernel_partition.MODE_COPY
    zc = torch.where(is_move, ((bit == 0).sum(dim=1) + 7) // 8 * 8, 0)
    oc = torch.where(is_move, ((bit == 1).sum(dim=1) + 7) // 8 * 8, 0)
    size = torch.where(is_copy, 1024, zc + oc)
    start = size.cumsum(0) - size  # every tile's rows follow the tile's before it
    require(int(size.sum()) <= n_work, "the randomized layout overruns the work buffer")
    k6_runs.append(check_partition(
        "randomized directives (dead rows in MOVE tiles)", rnd, mode, start.to(torch.int32),
        (start + zc).to(torch.int32), sz, so, fstar, tstar))
    k6_times, k6_err = k6_runs[0], max(r[4] for r in k6_runs)
    del captured, mid, mid_data, rnd, work0, chan_t, in_run, to_left, run_args, bit
    del chan_root, pos_r, live_r, h_run, h_all, g_f

    # -- phase 14: the clustered tree against the dataset-order tree ---------
    phase("14: fit_tree_clustered against fit_tree on the card, integer gradients")
    ptree, pnode = grow.fit_tree(binned, g_int, td.step.doc_mask, thr_dev, cfg)
    fields = ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf")
    bad = [f for f in fields if not torch.equal(getattr(ctree, f), getattr(ptree, f))]
    n_docs_diff = int((cnode != pnode).sum())
    print(f"  {int((~ctree.is_leaf).sum())} splits; node fields that differ: {bad or 'none'}; "
          f"docs routed to another node: {n_docs_diff} of {N}")
    require(not bad and n_docs_diff == 0, "the clustered tree differs from fit_tree's")
    del td, binned, g_int, ctree, cnode, ptree, pnode

    # -- phase 15: LambdaMART with the clustered layout beside dataset order -
    phase(f"15: LambdaMART cluster=on beside cluster=off, {TRAIN_TREES} trees at "
          f"{train_ds.num_queries} queries, on {card}")
    cluster_runs = {}
    for cluster in ("off", "on"):
        for counters in (kernel_histogram.LAUNCHES, kernel_partition.LAUNCHES):
            for name in counters:
                counters[name] = 0
        grow.HOST_SYNCS = 0
        lm = LambdaMart(ntrees=TRAIN_TREES, nleaves=16, nthresholds=255, seed=1, esr=100,
                        cluster=cluster)
        # no valid fold: no rollback, so all the trees stay to be compared
        hist = lm.learn(train_ds, None, Ndcg(10), verbose=False)
        per_tree = report_run(f"best@255 cluster={cluster}", lm, hist)
        counts = {**kernel_histogram.LAUNCHES, **kernel_partition.LAUNCHES}
        print(f"    kernel launches per tree: "
              f"{ {k: v / TRAIN_TREES for k, v in counts.items()} }")
        print(f"    train NDCG@10 {[round(x, 5) for x in hist['train']]}")
        cluster_runs[cluster] = (lm, hist, per_tree, counts)
    (off_m, off_h, off_s, _), (on_m, on_h, on_s, on_counts) = (cluster_runs["off"],
                                                              cluster_runs["on"])
    require(on_counts["partition_rows"] > 0 and on_counts["node_histogram"] > 0
            and on_counts["histogram"] > 0,
            f"a kernel of the clustered path was not launched: {on_counts}")
    require(cluster_runs["off"][3]["partition_rows"] == 0,
            "cluster=off launched the partition kernel")
    root = [(int(m.ensemble.feature[0, 0]), int(m.ensemble.threshold_bin[0, 0]))
            for m in (on_m, off_m)]
    diff = float(np.abs(np.array(on_h["train"]) - np.array(off_h["train"])).max())
    kept = min(on_m.ensemble.num_trees, off_m.ensemble.num_trees)
    require(kept == TRAIN_TREES, f"a run kept {kept} trees, not {TRAIN_TREES}")
    equal = sum(all(torch.equal(getattr(on_m.ensemble, f)[t], getattr(off_m.ensemble, f)[t])
                    for f in fields) for t in range(kept))
    print(f"  root split (feature, bin) on {root[0]}, off {root[1]}; max train NDCG@10 "
          f"difference {diff:.3g}; {equal} of the {kept} trees are equal node for node "
          f"(float gradients: reported, not required); s/tree on {on_s:.4f}, off {off_s:.4f} ({on_s / off_s:.2f}x)")
    require(root[0] == root[1], "cluster=on: the root split differs from cluster=off's")
    require(diff <= 1e-3, f"cluster=on: train NDCG@10 differs by {diff}")

    # -- phase 16: the clustered grower, card against CPU --------------------
    phase(f"16: LambdaMART cluster=on, {CPU_TREES} trees on {CPU_QUERIES} queries, card "
          f"against CPU")
    runs = {}
    for device in ("cuda", "cpu"):
        lm = LambdaMart(ntrees=CPU_TREES, nleaves=16, nthresholds=255, seed=1, cluster="on")
        runs[device] = (lm, lm.learn(small, None, Ndcg(10), verbose=False, device=device))
    (gpu_m, gpu_h), (cpu_m, cpu_h) = runs["cuda"], runs["cpu"]
    root = [(int(m.ensemble.feature[0, 0]), int(m.ensemble.threshold_bin[0, 0]))
            for m in (gpu_m, cpu_m)]
    diff = float(np.abs(np.array(gpu_h["train"]) - np.array(cpu_h["train"])).max())
    print(f"  root split (feature, bin) card {root[0]}, cpu {root[1]}; max train NDCG@10 "
          f"difference {diff:.3g} over {CPU_TREES} iterations")
    require(root[0] == root[1], "cluster=on: the root split differs between card and CPU")
    require(diff <= 1e-3, f"cluster=on: train NDCG@10 differs by {diff} between card and CPU")

    # -- phase 17: quicklearn on the card ------------------------------------
    phase("17: quicklearn (cli.main) trains, saves and scores on the card")
    from quickrank_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        svml = os.path.join(tmp, "mslr-shaped.svml")
        write_svml(make_ranking_dataset(num_queries=1000, avg_docs_per_query=116,
                                        num_features=N_FEATURES, seed=0), svml)
        model, scores = os.path.join(tmp, "cli.xml"), os.path.join(tmp, "cli.scores")
        for counters in (kernel_histogram.LAUNCHES, kernel_partition.LAUNCHES):
            for name in counters:
                counters[name] = 0
        kernel_qs.LAUNCHES = kernel_perfect.LAUNCHES = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--algo", "LAMBDAMART", "--train", svml, "--test", svml,
                           "--num-trees", "4", "--num-leaves", "16", "--partial", "2",
                           "--model-out", model, "--scores", scores])
        print("".join(f"    {line}\n" for line in out.getvalue().splitlines()
                      if line.startswith("# ") and not line.startswith("#  ")), end="")
        cli_launches = {**kernel_histogram.LAUNCHES, "qs_score": kernel_qs.LAUNCHES,
                        "perfect_score": kernel_perfect.LAUNCHES}
        print(f"  kernel launches during quicklearn: {cli_launches}")
        require(rc == 0, f"quicklearn: exit {rc}")
        require(cli_launches["node_histogram"] > 0 and cli_launches["histogram"] > 0
                and cli_launches["qs_score"] + cli_launches["perfect_score"] > 0,
                f"quicklearn did not run its kernels: {cli_launches}")
        require(os.path.exists(os.path.join(tmp, "cli.T2.xml")),
                "quicklearn wrote no partial model")
        loaded = LTRAlgorithm.load(model)
        require(type(loaded) is LambdaMart and loaded.ensemble.num_trees == 4,
                "quicklearn's model did not load as a 4-tree LambdaMART")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = quickscore.main(["-d", svml, "-m", model, "-r", "1",
                                  "-s", os.path.join(tmp, "qs.scores")])
        require(rc == 0, f"quickscore on quicklearn's model: exit {rc}")
        got, want = np.loadtxt(scores), np.loadtxt(os.path.join(tmp, "qs.scores"))
        require(got.shape == want.shape and np.isfinite(got).all()
                and np.array_equal(got, want),
                "quicklearn's test scores differ from quickscore's on the saved model")
        print(f"  {got.shape[0]} test scores equal quickscore's on the saved model "
              f"({loaded.scorer_path()} path)")

    # -- phase 18: K1's partial entry against its plain version -------------
    phase(f"18: qs_partial (per-tree columns) against the plain version on {card}")
    from quickrank_tpu_torch.trees.qs import partial_scores_qs

    def hold_partial(label, feats, tables, ens, chunk):
        """K1's partial entry over slot chunks against the plain version, bit
        for bit; (kernel ms, plain ms, bound) over all the slots at once."""
        T = tables.fid.shape[0]
        err = 0.0
        for t0 in range(0, T, chunk):
            t1 = min(T, t0 + chunk)
            got = kernel_qs.partial_scores_qs(feats, tables, t0, t1)
            torch.cuda.synchronize()
            plain = partial_scores_qs(feats, tables, t0, t1)
            require(got.shape == (feats.shape[0], t1 - t0) and bool(torch.isfinite(got).all()),
                    f"qs_partial {label}: bad output")
            err = max(err, float((got - plain).abs().max()))
            require(torch.equal(got, plain), f"qs_partial {label}, slots [{t0}, {t1}): kernel "
                    f"and plain version differ in {int((got != plain).sum())} cells")
        del got, plain
        k = time_ms(lambda: kernel_qs.partial_scores_qs(feats, tables), reps=10)
        p = time_ms(lambda: partial_scores_qs(feats, tables), reps=2)
        n = feats.shape[0]
        # bytes: rows and tables read once, [N, T] float32 written once;
        # operations: a compare a level of each doc's path (no sum)
        b = bound_ms(nbytes_of(feats, tables.packed()) + n * T * 4,
                     n * float(mean_leaf_depths(ens).sum()))
        print(f"  qs_partial {label} in chunks of {chunk} trees: bitwise the plain version "
              f"(max abs err {err}); all slots at once: kernel {k:.4f} ms, plain {p:.4f} ms, "
              f"bound {b[0]:.4f} ms by {b[1]}")
        return k, p, b

    e_qs, t_qs = qs_tables[(1000, 16)]
    hold_partial(f"1000x16 at {N_DOCS} x {N_FEATURES}", X, t_qs, e_qs, 128)
    t_bins = ensemble_to_qs(ens_bins, space="bin").to(dev)
    bins_dev = torch.from_numpy(bins_host).to(dev)
    hold_partial(f"1000x16 on u8 bins {N_DOCS} x {N_FEATURES}", bins_dev, t_bins, ens_bins, 128)
    ens_w2 = random_bestfirst_ensemble(4, 2048, N_FEATURES, seed=12)
    hold_partial(f"4x2048 leaves at {N_WIDE_DOCS} x {N_FEATURES} (wide kernel)",
                 X[:N_WIDE_DOCS], ensemble_to_qs(ens_w2).to(dev), ens_w2, 4)
    del t_bins, bins_dev, ens_w2

    # -- phase 19: DART at full width -----------------------------------------
    from quickrank_tpu_torch.learning import Dart

    phase(f"19: DART (UNIFORM / TREE, rate_drop 0.1), {DART_TREES} trees, "
          f"{train_ds.num_queries} train + {valid_ds.num_queries} valid queries, on {card}")
    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    kernel_qs.LAUNCHES = kernel_qs.PARTIAL_LAUNCHES = 0
    grow.HOST_SYNCS = 0
    dart = Dart(ntrees=DART_TREES, nleaves=16, nthresholds=255, rate_drop=0.1, seed=1, esr=0)
    t0 = time.perf_counter()
    dh = dart.learn(train_ds, valid_ds, Ndcg(10), verbose=False)
    dart_wall = time.perf_counter() - t0
    dart_launches = {"qs_score": kernel_qs.LAUNCHES, **kernel_histogram.LAUNCHES}
    it = dh["iter_seconds"]
    dart_s_iter = float(np.median(it[2:]))
    drops = np.asarray(dh["dropped_per_iter"])
    dart_delta_ms = float(np.mean(dh["delta_ms"]))
    best = dh["best_iteration"]
    print(f"  {len(it)} iterations in {dart_wall:.2f} s (init {dh['init_seconds']:.2f} s): "
          f"{dart_s_iter:.4f} s/iteration (median of iterations 2+; min {min(it[2:]):.4f}, "
          f"max {max(it[2:]):.4f}); {drops.mean():.3f} trees dropped an iteration (max "
          f"{drops.max()}); delta {dart_delta_ms:.4f} ms a dropped iteration, train and valid "
          f"(CUDA events, mean of {len(dh['delta_ms'])}; max {max(dh['delta_ms']):.4f})")
    print(f"  NDCG@10 last iteration train {dh['train'][-1]:.6f} valid {dh['valid'][-1]:.6f}; "
          f"best iteration {best}: train {dh['train'][best - 1]:.6f} valid "
          f"{dh['valid'][best - 1]:.6f}; {dart.ensemble.num_trees} trees kept")
    print(f"  kernel launches during the run: {dart_launches}")
    require(len(it) == DART_TREES, f"DART ran {len(it)} iterations, not {DART_TREES}")
    require(all(v > 0 for v in dart_launches.values()),
            f"a kernel of the DART path was not launched: {dart_launches}")
    require(drops.sum() > 0 and np.isfinite(dh["train"]).all() and np.isfinite(dh["valid"]).all(),
            "DART: no tree was dropped, or a metric is not finite")
    require(dh["train"][-1] > dh["train"][0], "DART: train NDCG@10 did not rise")

    # -- phase 20: the dropped-set delta at full width ------------------------
    from quickrank_tpu_torch.learning.dart import DropTable

    td = TrainData.build(train_ds, 255)
    model = rebin_ensemble(dart.ensemble, td.thresholds, force=True).to(dev)
    n_live = model.num_trees
    dropped = np.random.default_rng(20).choice(n_live, size=min(20, n_live), replace=False)
    phase(f"20: dropped-set delta, {len(dropped)} of the {n_live} trees of the DART model "
          f"on the u8 bin matrix {tuple(td.step.binned.shape)}")
    table = DropTable(model, dev)
    w_drop = model.weight[torch.from_numpy(dropped).to(dev)].cpu().numpy()
    kernel_qs.LAUNCHES = 0
    got = table.delta(dropped, w_drop, td.step.binned)
    torch.cuda.synchronize()
    require(kernel_qs.LAUNCHES == 1, "the delta did not launch K1 once")
    gathered = table.gathered(dropped, w_drop)
    plain = score_qs(td.step.binned, gathered)
    require(got.shape == (td.step.binned.shape[0],) and bool(torch.isfinite(got).all()),
            "delta: bad output")
    require(torch.equal(got, plain), f"delta: K1 and the plain scorer differ on "
            f"{int((got != plain).sum())} docs")
    # the weight words are written at every gather: another weight, another delta
    w_other = w_drop.copy()
    w_other[0] *= np.float32(0.5)
    other = table.delta(dropped, w_other, td.step.binned)
    require(not torch.equal(other, got), "delta: a changed weight did not change the delta")
    print("  bitwise the plain scorer on the same gathered tables; a changed weight changes it")
    # the delta's time taken apart: the whole delta (gather, weight words,
    # the unpacked view, K1) and K1 alone on the gathered rows, at the 1-4
    # trees of a DART run's first iterations and at 20
    depths = mean_leaf_depths(model)
    for n in (4, len(dropped)):
        few = table.gathered(dropped[:n], w_drop[:n])
        whole = time_ms(lambda: table.delta(dropped[:n], w_drop[:n], td.step.binned), reps=20)
        alone = time_ms(lambda: kernel_qs.score_qs(td.step.binned, few), reps=20)
        bnd = bound_ms(nbytes_of(td.step.binned, few.packed()) + td.step.binned.shape[0] * 4,
                       td.step.binned.shape[0] * float((depths[dropped[:n]] + 4).sum()))
        print(f"  {n} trees: delta {whole:.4f} ms, K1 alone {alone:.4f} ms (bound {bnd[0]:.4f} "
              f"ms by {bnd[1]}), so the gather and its host work {whole - alone:.4f} ms")
    del td, model, table, got, plain, other, gathered, few

    # -- phase 21: DART, the card against the CPU ------------------------------
    phase(f"21: DART, 8 trees on {CPU_QUERIES} queries, card against CPU")
    for label, kw in (("WEIGHTED / FOREST, rate_drop 0.5",
                       dict(sample_type="WEIGHTED", normalize_type="FOREST")),
                      ("UNIFORM / TREE, rate_drop 0.5, keep_drop", dict(keep_drop=True))):
        runs = {}
        for device in ("cuda", "cpu"):
            d = Dart(ntrees=8, nleaves=16, nthresholds=255, rate_drop=0.5, seed=1, **kw)
            runs[device] = d.learn(small, None, Ndcg(10), verbose=False, device=device)
        gpu_h, cpu_h = runs["cuda"], runs["cpu"]
        n = min(len(gpu_h["train"]), len(cpu_h["train"]))
        diffs = np.abs(np.array(gpu_h["train"][:n]) - np.array(cpu_h["train"][:n]))
        first = next(i for i, d in enumerate(cpu_h["dropped"]) if d)
        print(f"  {label}: dropped sets card {gpu_h['dropped'][:4]}, cpu {cpu_h['dropped'][:4]}; "
              f"train NDCG@10 differences {[float(f'{d:.3g}') for d in diffs]} over {n} "
              f"iterations, first drop at iteration {first + 1}")
        require(gpu_h["dropped"][:3] == cpu_h["dropped"][:3],
                f"DART {label}: the first dropped sets differ between card and CPU")
        # before the first drop as LambdaMART is held (phase 7); after it the
        # histogram kernels' last bits move the trees (docs that tie in the
        # kept trees sit a last bit apart once a tree is dropped, and their
        # rank order follows those bits), so the runs are held to 1e-2
        require(float(diffs[:first].max()) <= 1e-3,
                f"DART {label}: train NDCG@10 differs by {diffs[:first].max()} before a drop")
        require(float(diffs.max()) <= 1e-2, f"DART {label}: train NDCG@10 differs by "
                f"{diffs.max()}")

    # -- phase 22: quicklearn --algo DART on the card, --detailed -------------
    phase("22: quicklearn --algo DART trains, saves and writes --detailed on the card")
    with tempfile.TemporaryDirectory() as tmp:
        svml = os.path.join(tmp, "mslr-shaped.svml")
        serve_ds = make_ranking_dataset(num_queries=1000, avg_docs_per_query=116,
                                        num_features=N_FEATURES, seed=0)
        write_svml(serve_ds, svml)
        model_path = os.path.join(tmp, "dart.xml")
        for name in kernel_histogram.LAUNCHES:
            kernel_histogram.LAUNCHES[name] = 0
        kernel_qs.LAUNCHES = kernel_qs.PARTIAL_LAUNCHES = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--algo", "DART", "--train", svml, "--num-trees", "12",
                           "--num-leaves", "16", "--rate-drop", "0.3", "--partial", "4",
                           "--model-out", model_path])
        cli_dart_launches = {"qs_score": kernel_qs.LAUNCHES, **kernel_histogram.LAUNCHES}
        require(rc == 0, f"quicklearn --algo DART: exit {rc}")
        print(f"  training: kernel launches {cli_dart_launches}")
        require(all(v > 0 for v in cli_dart_launches.values()),
                f"quicklearn --algo DART did not run its kernels: {cli_dart_launches}")
        require(os.path.exists(os.path.join(tmp, "dart.T4.xml")), "no DART partial model")
        detailed = os.path.join(tmp, "detailed.svml")
        kernel_qs.PARTIAL_LAUNCHES = 0
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--model-in", model_path, "--test", svml, "--detailed", detailed])
        partial_launches = kernel_qs.PARTIAL_LAUNCHES
        require(rc == 0, f"quicklearn --detailed: exit {rc}")
        print(f"  --detailed: qs_partial launches {partial_launches}")
        require(partial_launches > 0, "--detailed did not launch K1's partial entry")
        loaded = LTRAlgorithm.load(model_path)
        require(type(loaded) is Dart and loaded.ensemble.num_trees > 0,
                "quicklearn's DART model did not load as DART")
        feats = torch.from_numpy(read_svml(svml).features).to(dev)
        tables = ensemble_to_qs(loaded.ensemble).to(dev)
        cols = read_svml(detailed).features
        want_cols = partial_scores_qs(feats, tables).cpu().numpy()
        require(cols.shape == want_cols.shape and np.array_equal(cols, want_cols),
                "--detailed columns differ from partial_scores_qs")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = quickscore.main(["-d", svml, "-m", model_path, "-r", "1",
                                  "-s", os.path.join(tmp, "dart.scores")])
        require(rc == 0, f"quickscore on the DART model: exit {rc}")
        served = np.loadtxt(os.path.join(tmp, "dart.scores")).astype(np.float32)
        fn = score_perfect if loaded.scorer_path() == "perfect" else score_qs
        _, host_tables = loaded._host_tables()
        want = fn(feats, host_tables.to(dev)).cpu().numpy()
        require(served.shape == want.shape and np.array_equal(served, want),
                "quickscore's DART scores differ from the plain scorer")
        print(f"  {loaded.ensemble.num_trees} trees; --detailed {cols.shape} bitwise "
              f"partial_scores_qs; quickscore ({loaded.scorer_path()} path) bitwise the plain "
              f"scorer on {served.shape[0]} docs")

    # -- phase 23: CoordinateAscent and LineSearch at full width -------------
    import copy

    from quickrank_tpu_torch.learning import CoordinateAscent, LineSearch, MetaCleaver, linear

    phase(f"23: CoordinateAscent and LineSearch, 21 points, {LINEAR_EPOCHS} epochs, "
          f"{train_ds.num_queries} train + {valid_ds.num_queries} valid queries, on {card}")
    fold = linear.Fold(train_ds, dev)
    F = train_ds.num_features
    w0 = np.full(F, np.float32(1.0 / F), np.float32)
    full = fold.dot(w0)
    pts = linear.grid_points(w0[0], np.float32(10.0 / F), 21)
    cands = linear.feature_candidates(full, fold.column(0), w0[0], pts)
    batch_ms = time_ms(lambda: fold.metrics(Ndcg(10), cands), reps=3)
    dot_ms = time_ms(lambda: fold.dot(w0), reps=3)
    print(f"  one {list(cands.shape)} candidate batch {batch_ms:.4f} ms (CUDA events; "
          f"{fold.batch_size()} candidates a chunk over the padded view "
          f"{list(fold.slot_mask.shape)}); X @ w in XLA's order {dot_ms:.4f} ms")
    del fold, full, cands
    linear_runs = {}
    for cls in (CoordinateAscent, LineSearch):
        torch.cuda.reset_peak_memory_stats()
        ranker = cls(num_points=21, max_iterations=LINEAR_EPOCHS)
        t0 = time.perf_counter()
        h = ranker.learn(train_ds, valid_ds, Ndcg(10), verbose=False)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        secs = h.get("epoch_seconds") or h["iteration_seconds"]
        unit = "epoch" if cls is CoordinateAscent else "iteration"
        linear_runs[ranker.NAME] = float(np.median(secs))
        print(f"  {ranker.NAME}: {np.median(secs):.4f} s/{unit} (median; all "
              f"{[round(x, 4) for x in secs]}), {wall:.2f} s with set-up; train NDCG@10 "
              f"{[round(x, 6) for x in h['train']]}, valid {[round(x, 6) for x in h['valid']]}; "
              f"peak device memory {peak:.2f} GiB")
        require(len(h["train"]) == LINEAR_EPOCHS and np.isfinite(h["train"]).all()
                and np.isfinite(h["valid"]).all(), f"{ranker.NAME}: bad history")
        require(h["train"][-1] >= h["train"][0] - 1e-6 and h["train"][-1] > 0.5,
                f"{ranker.NAME}: train NDCG@10 {h['train']}")
        got = ranker.score_dataset(valid_ds)
        want = valid_ds.features.astype(np.float64) @ ranker.best_weights
        err = float(np.abs(got - want).max())
        require(got.dtype == np.float64 and err <= 1e-12 * max(1.0, float(np.abs(want).max())),
                f"{ranker.NAME}: scores on the card differ from numpy's X @ w by {err}")
    print("  linear scores on the card within 1e-12 relative of numpy's float64 X @ w")

    # -- phase 24: the linear rankers, the card against the CPU ---------------
    phase(f"24: CoordinateAscent and LineSearch on {CPU_QUERIES} queries, card against CPU")
    for cls in (CoordinateAscent, LineSearch):
        first, final = {}, {}
        for device in ("cuda", "cpu"):
            fold = linear.Fold(small, device)
            ranker = cls(num_points=21, max_iterations=2)
            if cls is CoordinateAscent:
                w = np.full(F, np.float32(1.0 / F), np.float32)
                _, pts, ms, _ = ranker.feature_step(fold, Ndcg(10), w, 0, np.float32(10.0 / F))
            else:
                w, trace = np.ones(F, np.float32), []
                best = np.float32(fold.metric(Ndcg(10), fold.dot(w)))
                ranker.iteration(fold, Ndcg(10), w, w, best, np.float32(10.0), trace=trace)
                pts, ms = trace[0]
            first[device] = (pts, ms)
            final[device] = ranker.learn(small, None, Ndcg(10), verbose=False,
                                         device=device)["train"][-1]
        (gp, gm), (cp, cm) = first["cuda"], first["cpu"]
        fin = np.isfinite(cm)
        step_err = float(np.abs(gm[fin] - cm[fin]).max())
        gap = abs(final["cuda"] - final["cpu"])
        print(f"  {cls.NAME}: first feature step's {fin.sum()} candidate metrics within "
              f"{step_err:.3g} of the CPU's; train NDCG@10 after 2 epochs card "
              f"{final['cuda']:.6f}, cpu {final['cpu']:.6f} (gap {gap:.3g})")
        require(np.array_equal(gp, cp) and np.array_equal(np.isfinite(gm), fin),
                f"{cls.NAME}: the card's candidate grid differs from the CPU's")
        require(step_err <= 1e-5, f"{cls.NAME}: first step's metrics differ by {step_err}")
        require(gap <= 1e-2, f"{cls.NAME}: final train NDCG@10 differs by {gap}")

    # -- phase 25: Cleaver at full width on phase 19's DART model -------------
    from quickrank_tpu_torch.optimization import PRUNING_METHODS, Cleaver

    model = copy.deepcopy(dart)
    T = model.ensemble.num_trees
    phase(f"25: Cleaver QUALITY_LOSS, pruning rate {CLEAVER_RATE}, LineSearch (2 "
          f"iterations) before and after pruning, on phase 19's {T}-tree DART model, "
          f"{train_ds.num_queries} train + {valid_ds.num_queries} valid queries, on {card}")
    torch.cuda.reset_peak_memory_stats()
    kernel_qs.PARTIAL_LAUNCHES = 0
    t0 = time.perf_counter()
    ptrain = Cleaver.partial_dataset(model, train_ds, dev)
    pvalid = Cleaver.partial_dataset(model, valid_ds, dev)
    extract_ms = (time.perf_counter() - t0) * 1e3
    cleaver_partial_launches = kernel_qs.PARTIAL_LAUNCHES
    cl = Cleaver("QUALITY_LOSS", CLEAVER_RATE, line_search=LineSearch(max_iterations=2), seed=0)
    t0 = time.perf_counter()
    info = cl.optimize(model, train_ds, valid_ds, Ndcg(10), verbose=False, ptrain=ptrain,
                       pvalid=pvalid)
    cleaver_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    post_it = info["post_ls_iteration_seconds"]
    print(f"  extraction (K1's partial entry, {cleaver_partial_launches} launches, and the host "
          f"copies) {extract_ms:.1f} ms for {ptrain.num_docs} + {pvalid.num_docs} docs x {T} trees; "
          f"optimize {cleaver_s:.2f} s: line search before pruning {info['pre_ls_seconds']:.2f} s, "
          f"drop-one selection {info['prune_seconds']:.3f} s, line search after "
          f"{info['post_ls_seconds']:.2f} s ({np.median(post_it):.3f} s/iteration over "
          f"{T - len(info['pruned'])} columns); peak device memory {peak:.2f} GiB")
    print(f"  trees {info['num_trees_before']} -> {info['num_trees_after']}; NDCG@10 train "
          f"{info['metric_before']:.6f} -> {info['metric_after']:.6f}, valid "
          f"{info['metric_before_valid']:.6f} -> {info['metric_after_valid']:.6f}")
    require(cleaver_partial_launches > 0, "Cleaver's extraction did not launch K1's partial entry")
    k = int(round(CLEAVER_RATE * T))
    # the line search after pruning may set more weights to zero, and the
    # write-back drops those trees too
    require(len(info["pruned"]) == k and model.ensemble.num_trees == info["num_trees_after"]
            <= T - k, f"Cleaver pruned {len(info['pruned'])} trees, not {k}")
    require(np.isfinite([info["metric_after"], info["metric_after_valid"]]).all(),
            "Cleaver: a metric is not finite")
    kernel_qs.LAUNCHES = kernel_perfect.LAUNCHES = 0
    scored = model.score_dataset(train_ds)
    want = (torch.from_numpy(ptrain.features).to(dev).double()
            @ torch.from_numpy(cl.weights_).to(dev)).cpu().numpy()
    err = float(np.abs(scored - want).max())
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    print(f"  the pruned model's {model.scorer_path()} kernel scores against partial @ weights: "
          f"max abs err {err:.3g} (atol {atol:.3g})")
    require(kernel_qs.LAUNCHES + kernel_perfect.LAUNCHES > 0,
            "the pruned model was not scored by a kernel")
    require(err <= atol, f"pruned model's scores differ from partial @ weights by {err}")
    # K1's partial entry at the shape the extraction gave it: one train block
    # (the second where there are two), the kernel against the plain version
    # bit for bit and against the columns the extraction wrote
    X_tr = torch.from_numpy(np.ascontiguousarray(train_ds.features, np.float32)).to(dev)
    qs_tr = ensemble_to_qs(dart.ensemble).to(dev)
    n_tr, n_slots = X_tr.shape[0], qs_tr.fid.shape[0]
    step = max(1, kernel_qs.PARTIAL_BLOCK_ELEMS // n_tr)
    b0 = step if step < n_slots else 0
    b1 = min(n_slots, b0 + step)
    got = kernel_qs.partial_scores_qs(X_tr, qs_tr, b0, b1)
    plain = partial_scores_qs(X_tr, qs_tr, b0, b1)
    partial_err = float((got - plain).abs().max())
    require(torch.equal(got, plain), f"qs_partial on Cleaver's block [{b0}, {b1}): kernel and "
            f"plain version differ in {int((got != plain).sum())} cells")
    require(np.array_equal(got.cpu().numpy(), ptrain.features[:, b0:b1]),
            f"Cleaver's extraction of slots [{b0}, {b1}) differs from K1's partial entry")
    del got, plain
    partial_ms = time_ms(lambda: kernel_qs.partial_scores_qs(X_tr, qs_tr, b0, b1), reps=10)
    partial_plain_ms = time_ms(lambda: partial_scores_qs(X_tr, qs_tr, b0, b1), reps=2)
    # bytes: the rows and the block's tables read once, [N, b1 - b0] float32
    # written once; operations: a compare a level of each doc's path
    partial_bound = bound_ms(nbytes_of(X_tr, qs_tr.packed()[b0:b1]) + n_tr * (b1 - b0) * 4,
                             n_tr * float(mean_leaf_depths(dart.ensemble)[b0:b1].sum()))
    print(f"  qs_partial on Cleaver's train block, slots [{b0}, {b1}) of {n_slots} at {n_tr} "
          f"docs: bitwise the plain version and the extraction (max abs err {partial_err}); "
          f"kernel {partial_ms:.4f} ms, plain {partial_plain_ms:.4f} ms, bound "
          f"{partial_bound[0]:.4f} ms by {partial_bound[1]}")
    del ptrain, pvalid, X_tr, qs_tr
    strategy_s = {}
    for method in PRUNING_METHODS:
        m = copy.deepcopy(dart)
        t0 = time.perf_counter()
        inf = Cleaver(method, 0.25, seed=3).optimize(m, valid_ds, None, Ndcg(10), verbose=False)
        strategy_s[method] = round(time.perf_counter() - t0, 3)
        require(len(inf["pruned"]) == int(round(0.25 * T)) and m.ensemble.num_trees == T - len(
            inf["pruned"]), f"{method}: pruned {len(inf['pruned'])} of {T}")
    print(f"  all eight strategies at {valid_ds.num_queries} queries prune "
          f"{int(round(0.25 * T))} of {T} trees; seconds each {strategy_s}")

    # -- phase 26: quicklearn's optimization phase on the card -----------------
    phase(f"26: quicklearn --opt-algo, --opt-model, COORDASC, --meta-algo and quickscore "
          "on the card")
    with tempfile.TemporaryDirectory() as tmp:
        svml = os.path.join(tmp, "mslr-shaped.svml")
        write_svml(make_ranking_dataset(num_queries=1000, avg_docs_per_query=116,
                                        num_features=N_FEATURES, seed=0), svml)
        path = lambda name: os.path.join(tmp, name)  # noqa: E731

        def quicklearn(args):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(args)
            require(rc == 0, f"quicklearn {' '.join(args)}: exit {rc}")
            return out.getvalue()

        kernel_qs.PARTIAL_LAUNCHES = 0
        for name in kernel_histogram.LAUNCHES:
            kernel_histogram.LAUNCHES[name] = 0
        quicklearn(["--algo", "LAMBDAMART", "--train", svml, "--test", svml, "--num-trees", "20",
                    "--num-leaves", "16", "--model-out", path("m.xml"), "--opt-algo", "EPRUNING",
                    "--opt-method", "QUALITY_LOSS", "--pruning-rate", "0.5",
                    "--with-line-search", "--max-iterations", "2", "--opt-model", path("o.xml"),
                    "--opt-algo-model", path("p.xml"), "--train-partial", path("tp.svml"),
                    "--scores", path("p.scores")])
        launches26 = {"qs_partial": kernel_qs.PARTIAL_LAUNCHES, **kernel_histogram.LAUNCHES}
        require(all(v > 0 for v in launches26.values()),
                f"quicklearn --opt-algo did not run its kernels: {launches26}")
        for name in ("o.xml", "p.xml", "tp.svml"):
            require(os.path.exists(path(name)), f"quicklearn wrote no {name}")
        pruned = LTRAlgorithm.load(path("p.xml"))
        require(pruned.ensemble.num_trees == 10, f"p.xml has {pruned.ensemble.num_trees} trees")
        quicklearn(["--algo", "LAMBDAMART", "--model-in", path("m.xml"), "--skip-train",
                    "--train", svml, "--train-partial", path("tp.svml"), "--opt-model",
                    path("o.xml"), "--opt-algo-model", path("p2.xml")])
        require(LTRAlgorithm.load(path("p2.xml")).ensemble.num_trees <= 20,
                "--opt-model as input: bad model")
        note = quicklearn(["--algo", "COORDASC", "--train", svml, "--test", svml,
                           "--max-iterations", "1", "--model-out", path("c.xml"),
                           "--scores", path("c.scores")])
        require("has no partial_save/output_basename support" in note,
                "COORDASC with the default --partial: no note")
        require(type(LTRAlgorithm.load(path("c.xml"))) is CoordinateAscent,
                "c.xml did not load as COORDASC")
        quicklearn(["--algo", "LAMBDAMART", "--meta-algo", "METACLEAVER", "--train", svml,
                    "--num-trees", "4", "--final-num-trees", "8", "--num-leaves", "16",
                    "--opt-method", "QUALITY_LOSS", "--opt-last-only",
                    "--model-out", path("meta.xml")])
        meta = LTRAlgorithm.load(path("meta.xml"))
        require(type(meta) is MetaCleaver and 0 < meta.ltr_algo.ensemble.num_trees <= 8,
                "meta.xml did not load as a METACLEAVER model of at most 8 trees")
        for model_file, scores in (("c.xml", "c.scores"), ("p.xml", "p.scores")):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = quickscore.main(["-d", svml, "-m", path(model_file), "-r", "1",
                                      "-s", path("qs." + scores)])
            require(rc == 0, f"quickscore on {model_file}: exit {rc}")
            got, want = np.loadtxt(path(scores)), np.loadtxt(path("qs." + scores))
            require(got.shape == want.shape and np.isfinite(got).all()
                    and np.array_equal(got, want),
                    f"quicklearn's --scores differ from quickscore's on {model_file}")
        print(f"  --opt-algo: kernel launches {launches26}, 20 -> {pruned.ensemble.num_trees} "
              f"trees; --opt-model as input; COORDASC with the default --partial (the note); "
              f"METACLEAVER ({meta.ltr_algo.ensemble.num_trees} trees); quickscore's scores equal "
              f"quicklearn's on c.xml (linear) and p.xml ({pruned.scorer_path()})")

    # -- phase 27: RankBoost at full width --------------------------------------
    import glob
    import shutil

    from quickrank_tpu_torch.io import codegen
    from quickrank_tpu_torch.learning import (
        LambdaMartSelective,
        RandomForest,
        RankBoost,
        StochasticNegative,
        rankboost,
    )
    from quickrank_tpu_torch.learning.selective import select_presence
    from quickrank_tpu_torch.ops.histogram import masked_histogram_scatter

    phase(f"27: RankBoost, {RANKBOOST_ROUNDS} rounds, {train_ds.num_queries} train + "
          f"{valid_ds.num_queries} valid queries, on {card}")
    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    rankboost.HOST_SYNCS = 0
    rb = RankBoost(ntrees=RANKBOOST_ROUNDS, nthresholds=255)
    t0 = time.perf_counter()
    rb_hist = rb.learn(train_ds, valid_ds, Ndcg(10), verbose=False)
    rb_wall = time.perf_counter() - t0
    rb_launches = dict(kernel_histogram.LAUNCHES)
    rb_syncs = rankboost.HOST_SYNCS / RANKBOOST_ROUNDS
    rb_s_round = float(np.median(rb_hist["iter_seconds"][1:]))
    print(f"  {rb_s_round:.4f} s/round (median of rounds 2+; first "
          f"{rb_hist['iter_seconds'][0]:.4f}), {rb_wall:.2f} s with set-up; kernel launches "
          f"{rb_launches}, host syncs a round {rb_syncs:.2f}; train NDCG@10 "
          f"{rb_hist['train'][0]:.6f} -> {rb_hist['train'][-1]:.6f}, best valid NDCG@10 "
          f"{max(rb_hist['valid']):.6f} at round {rb_hist['best_T']}")
    require(rb_launches["node_histogram"] == RANKBOOST_ROUNDS and rb_syncs == 2,
            f"RankBoost: {rb_launches} launches, {rb_syncs} syncs a round")
    require(np.isfinite(rb_hist["train"]).all() and np.isfinite(rb_hist["valid"]).all()
            and rb_hist["train"][-1] > rb_hist["train"][0], "RankBoost: bad history")
    # one round's potential histogram, from the scores the run ended with
    td27 = TrainData.build(train_ds, 255, device=dev)
    levels27 = tuple(float(x) for x in np.unique(train_ds.labels))
    pi27, _ = rankboost.potentials(rb.train_scores, td27.step, levels27)
    b27, dm27 = td27.step.binned, td27.step.doc_mask
    F27, B27 = td27.num_real_features, td27.num_bins
    got = rankboost.potential_histogram(b27, pi27, dm27, B27, F27)[..., None]
    vt27 = pi27[None].contiguous()
    pos27 = torch.where(dm27, 0, 1).to(torch.int32)
    require(torch.equal(got, kernel_histogram.node_histogram_fixed(b27, vt27, pos27, B27, 0, 1,
                                                                   F27)),
            "RankBoost's K4 histogram differs from node_histogram_fixed")
    cols27 = b27[:, :F27]
    v64 = pi27.double()
    plain, exact, mass, terms = (masked_histogram_scatter(cols27, v[:, None], dm27, B27)
                                 for v in (pi27, v64, v64.abs(), torch.ones_like(v64)))
    rb_k4_err = check_histogram("K4 RankBoost potentials (C = 1)", got, plain, exact, mass,
                                terms, slice(0, 0), kernel_histogram.rounding_error(vt27))
    rb_k4_ms = time_ms(lambda: rankboost.potential_histogram(b27, pi27, dm27, B27, F27), reps=20)
    rb_plain_ms = time_ms(lambda: masked_histogram_scatter(cols27, pi27[:, None], dm27, B27),
                          reps=3)
    n27 = int(dm27.sum())
    rb_bound = bound_ms(n27 * F27 + nbytes_of(vt27, pos27) + F27 * B27 * 4, n27 * F27)
    print(f"  K4 on one round's potentials (C = 1, {F27} features, {B27} bins) bit for bit "
          f"node_histogram_fixed; {rb_k4_ms:.4f} ms (plain {rb_plain_ms:.4f}, bound "
          f"{rb_bound[0]:.4f} by {rb_bound[1]})")
    served = make_ranking_dataset(num_queries=400, seed=14)
    with tempfile.TemporaryDirectory() as tmp:
        svml, model = os.path.join(tmp, "served.svml"), os.path.join(tmp, "rb.xml")
        write_svml(served, svml)
        rb.save(model)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = quickscore.main(["-d", svml, "-m", model, "-r", "3",
                                  "-s", os.path.join(tmp, "qs.scores")])
        require(rc == 0, f"quickscore on the RankBoost model: exit {rc}")
        np.savetxt(os.path.join(tmp, "sd.scores"), rb.score_dataset(served), fmt="%.15g")
        got, want = (np.loadtxt(os.path.join(tmp, f)) for f in ("qs.scores", "sd.scores"))
        require(got.shape == (served.num_docs,) and np.isfinite(got).all()
                and np.array_equal(got, want),
                "quickscore's scores of the RankBoost model differ from score_dataset")
    print(f"  quickscore's scores of the saved model ({rb.best_T} weak rankers) equal "
          f"score_dataset on {served.num_docs} docs of 400 other queries")
    del td27, b27, dm27, pi27, vt27, pos27, cols27, v64, plain, exact, mass, terms, got

    # -- phase 28: RankBoost and Selective, the card against the CPU ------------
    phase(f"28: RankBoost and LambdaMART-Selective on {CPU_QUERIES} queries, card "
          f"against CPU")
    runs28 = {}
    for device in ("cuda", "cpu"):
        m = RankBoost(ntrees=10, nthresholds=255)
        runs28[device] = (m, m.learn(small, None, Ndcg(10), verbose=False, device=device))
    (gm, gh), (cm, ch) = runs28["cuda"], runs28["cpu"]
    gap = abs(gh["train"][-1] - ch["train"][-1])
    print(f"  RankBoost: weak rankers (feature) card {gm.features_[:5].tolist()}, cpu "
          f"{cm.features_[:5].tolist()}; final train NDCG@10 gap {gap:.3g}")
    require(np.array_equal(gm.features_[:5], cm.features_[:5])
            and np.array_equal(gm.thetas_[:5], cm.thetas_[:5]),
            "RankBoost: the card's first five weak rankers differ from the CPU's")
    require(gap <= 1e-3, f"RankBoost: final train NDCG@10 differs by {gap}")
    runs28 = {}
    for device in ("cuda", "cpu"):
        m = LambdaMartSelective(ntrees=3, nleaves=16, nthresholds=255, seed=1,
                                sampling_iterations=1, rank_sampling_factor=0.5,
                                random_sampling_factor=0.0)
        runs28[device] = (m, m.learn(small, None, Ndcg(10), verbose=False, device=device))
    (gm, gh), (cm, ch) = runs28["cuda"], runs28["cpu"]
    root = [(int(m.ensemble.feature[0, 0]), int(m.ensemble.threshold_bin[0, 0]))
            for m in (gm, cm)]
    diff = float(np.abs(np.array(gh["train"]) - np.array(ch["train"])).max())
    print(f"  LambdaMART-Selective (RATIO 0.5): root split card {root[0]}, cpu {root[1]}; max "
          f"train NDCG@10 difference {diff:.3g} over 3 iterations")
    require(root[0] == root[1], "Selective: root split differs")
    require(diff <= 1e-3, f"Selective: train NDCG@10 differs by {diff}")

    # -- phase 29: the sampling learners and RandomForest at full width ---------
    phase(f"29: RandomForest, LambdaMART-Selective (RATIO, MUL, POS; MIX) and "
          f"Stochastic-Negative, {TRAIN_TREES} trees at {train_ds.num_queries} queries, on {card}")

    def per_query(mask, sd):
        kept = mask[sd.pad_index] & sd.slot_mask
        pos = (sd.labels2d > 0) & sd.slot_mask
        neg = (sd.labels2d <= 0) & sd.slot_mask
        return (kept & pos).sum(1), pos.sum(1), (kept & neg).sum(1), neg.sum(1)

    def check_presence(model):
        """Wrap the presence hook: every fresh mask keeps each positive and
        as many negatives a query as the rule says."""
        hook, checked = model._update_presence, [0]
        selective = isinstance(model, LambdaMartSelective)

        def update(m, tr, scores, gen):
            factors = model._factors() if selective else None
            out = hook(m, tr, scores, gen)
            if out is None or (selective and (m == 0 or m % model.sampling_iterations)):
                return out
            sd, N = tr.step, tr.padded.num_docs_padded
            kp, npos, kn, nneg = per_query(out, sd)
            require(torch.equal(kp, npos), f"{model.NAME}: a positive was dropped")
            if selective:
                rk, rd = factors
                top, rnd = (select_presence(scores, sd, N, model.negative_strategy, a, b,
                                            torch.Generator())
                            for a, b in ((rk, 0.0), (0.0, rd)))
                require(not bool((top & ~out).any()),
                        f"{model.NAME}: a top-scored negative was dropped")
                want = torch.minimum(per_query(top, sd)[2] + per_query(rnd, sd)[2], nneg)
            else:
                want = torch.floor(nneg.float() * float(np.float32(model.negative_fraction)))
            require(torch.equal(kn, want.long()),
                    f"{model.NAME}: the negatives kept differ from the rule's count")
            checked[0] += 1
            return out

        model._update_presence = update
        return checked

    sampled_runs = {}
    common = dict(ntrees=TRAIN_TREES, nleaves=16, nthresholds=255, seed=1)
    learners29 = [("RANDOMFOREST", RandomForest(subsample=0.6, max_features=0.5, **common))]
    learners29 += [(f"SELECTIVE-{s}", LambdaMartSelective(
        sampling_iterations=1, rank_sampling_factor=0.5, random_sampling_factor=0.25,
        normalization_factor=4, adaptive_strategy="MIX", negative_strategy=s, **common))
        for s in ("RATIO", "MUL", "POS")]
    learners29 += [("STOCHASTIC-NEGATIVE", StochasticNegative(subsample=0.3, **common))]
    # the five learners train on one binned copy of the 19,000 queries
    td29 = TrainData.build(train_ds, 255)
    for label, m in learners29:
        checked = check_presence(m) if label != "RANDOMFOREST" else [None]
        for name in kernel_histogram.LAUNCHES:
            kernel_histogram.LAUNCHES[name] = 0
        grow.HOST_SYNCS = 0
        h = m.learn(td29, valid_ds, Ndcg(10), verbose=False)
        sampled_runs[label] = report_run(label, m, h)
        print(f"    train NDCG@10 {[round(x, 5) for x in h['train']]}, valid best "
              f"{max(h['valid']):.5f}; kernel launches {dict(kernel_histogram.LAUNCHES)}; "
              f"presence masks checked {checked[0]}")
        require(np.isfinite(h["train"]).all() and np.isfinite(h["valid"]).all(),
                f"{label}: bad history")
        require(all(v > 0 for v in kernel_histogram.LAUNCHES.values()),
                f"{label}: a histogram kernel was not launched")
        require(checked[0] is None or checked[0] >= TRAIN_TREES - 1,
                f"{label}: {checked[0]} presence masks checked")
    print(f"  s/tree beside LambdaMART best@255 {train_runs['best'][1]:.4f} (phase 6): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sampled_runs.items()))

    # -- phase 30: quicklearn for the new learners, codegen and --trace ---------
    phase(f"30: quicklearn --algo RANKBOOST, LAMBDAMART-SELECTIVE, STOCHASTIC-NEGATIVE, "
          "RANDOMFOREST, CUSTOM, --code-file and --trace on the card")
    cc = shutil.which("gcc") or shutil.which("cc")
    require(cc is not None, "no C compiler to build the generated scorers with")
    with tempfile.TemporaryDirectory() as tmp:
        ds30 = make_ranking_dataset(num_queries=400, avg_docs_per_query=116,
                                    num_features=N_FEATURES, seed=0)
        svml = os.path.join(tmp, "mslr-shaped.svml")
        write_svml(ds30, svml)
        path = lambda name: os.path.join(tmp, name)  # noqa: E731

        def quicklearn(args):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(args)
            require(rc == 0, f"quicklearn {' '.join(args)}: exit {rc}")
            return out.getvalue()

        algos30 = {"RANKBOOST": ["--num-trees", "20"],
                   "LAMBDAMART-SELECTIVE": ["--sampling-iterations", "1",
                                            "--random-sampling-factor", "0.25",
                                            "--negative-strategy", "POS"],
                   "STOCHASTIC-NEGATIVE": ["--subsample", "0.3"],
                   "RANDOMFOREST": ["--subsample", "0.6", "--max-features", "0.5"],
                   "CUSTOM": []}
        for algo, extra in algos30.items():
            for name in kernel_histogram.LAUNCHES:
                kernel_histogram.LAUNCHES[name] = 0
            quicklearn(["--algo", algo, "--train", svml, "--test", svml, "--num-trees", "4",
                        "--num-leaves", "16", "--partial", "0", "--model-out", path(f"{algo}.xml"),
                        "--scores", path(f"{algo}.scores")] + extra)
            launched = dict(kernel_histogram.LAUNCHES)
            require(algo == "CUSTOM" or launched["node_histogram"] > 0,
                    f"quicklearn --algo {algo} did not launch K4: {launched}")
            loaded = LTRAlgorithm.load(path(f"{algo}.xml"))
            require(loaded.NAME == algo, f"{algo}.xml loaded as {loaded.NAME}")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = quickscore.main(["-d", svml, "-m", path(f"{algo}.xml"), "-r", "1",
                                      "-s", path(f"{algo}.qs")])
            require(rc == 0, f"quickscore on {algo}.xml: exit {rc}")
            got, want = np.loadtxt(path(f"{algo}.qs")), np.loadtxt(path(f"{algo}.scores"))
            require(got.shape == want.shape and np.isfinite(got).all()
                    and np.array_equal(got, want),
                    f"quicklearn's --scores differ from quickscore's on {algo}.xml")
            print(f"  {algo}: K4/K5 launches {launched}; quickscore's {got.shape[0]} scores "
                  f"equal quicklearn's ({loaded.scorer_path()} path)")
        quicklearn(["--algo", "OBVLAMBDAMART", "--train", svml, "--num-trees", "4",
                    "--tree-depth", "3", "--partial", "0", "--model-out", path("obv.xml")])
        X30 = ds30.features[:512]
        for generator, model in (("condop", "RANDOMFOREST.xml"), ("oblivious", "obv.xml"),
                                 ("vpred", "RANDOMFOREST.xml")):
            code = path(f"ranker.{generator}")
            quicklearn(["--model-file", path(model), "--code-file", code, "--generator",
                        generator])
            text = open(code).read()
            loaded = LTRAlgorithm.load(path(model))
            require(text == codegen.generate(loaded, generator),
                    f"--code-file {generator}: not the generator's text")
            if generator == "vpred":
                lines = text.split("\n")
                require(int(lines[0]) == loaded.ensemble.num_trees
                        and lines.count("end") == loaded.ensemble.num_trees,
                        "vpred: bad node list")
                print(f"  vpred: {lines.count('end')} trees in the node list")
                continue
            with open(path("main.c"), "w") as f:
                f.write(text + CODEGEN_MAIN)
            subprocess.run([cc, "-O1", "-o", path("ranker"), path("main.c"), "-lm"], check=True)
            rows = [f"{X30.shape[0]} {X30.shape[1]}"] + [
                " ".join(np.format_float_positional(v, unique=True) for v in row) for row in X30]
            out = subprocess.run([path("ranker")], input="\n".join(rows), capture_output=True,
                                 text=True, check=True).stdout
            got = np.asarray([float(x) for x in out.split()])
            want = loaded.score_dataset(ds30, device="cuda")[: X30.shape[0]]
            err = float(np.abs(got - want).max())
            tol = 1e-5 * max(1.0, float(np.abs(want).max()))
            print(f"  {generator}: compiled with {os.path.basename(cc)}, {got.shape[0]} docs "
                  f"within {err:.3g} of the model's scores on the card (tolerance {tol:.3g})")
            require(got.shape == want.shape and err <= tol,
                    f"{generator}: the compiled scorer differs by {err}")
        quicklearn(["--algo", "LAMBDAMART", "--train", svml, "--num-trees", "2",
                    "--num-leaves", "16", "--partial", "0", "--trace", path("trace")])
        traces = glob.glob(path("trace/*.trace.json"))
        require(len(traces) == 1, f"--trace wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"  --trace: {os.path.getsize(traces[0])} bytes, {len(events)} events, "
              f"{kernels} of them the card's kernels")
        require(len(events) > 0, "--trace wrote no events")

    # -- phase 31: the histogram kernels under a common scale -------------------
    from quickrank_tpu_torch.parallel import launch, mesh, workers

    kh = kernel_histogram
    t0 = time.perf_counter()
    td = TrainData.build(train_ds, 255, device=dev)
    binned = td.step.binned
    N, W = binned.shape
    n_real = int(td.step.doc_mask.sum())
    phase(f"31: K4 and K5 under a given scale (int64 sums, then the conversion: the "
          f"group's entry) on {N} x {W} u8 bins, scale count {n_real}; binning "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cpu").manual_seed(5)  # phase 5's draws
    g = torch.randn(N, generator=gen).to(dev)
    vt = doc_channels(g, td.step.doc_mask).T.contiguous()
    pos_root = torch.where(td.step.doc_mask, 0, 1).to(torch.int32)
    pos16 = torch.randint(0, 16, (N,), generator=gen, dtype=torch.int32).to(dev)
    halves = (slice(0, N // 2), slice(N // 2, N))
    for label, v, pos, k in (("K4 root, C=3, k=1", vt, pos_root, 1),
                             ("K4 C=2, k=16", vt[:2].contiguous(), pos16, 16)):
        bits = kh.channel_max_bits(v)
        whole = kh.node_histogram_int(binned, v, pos, 256, 0, k, bits, n_real)
        require(torch.equal(whole, kh.node_histogram_fixed_int(binned, v, pos, 256, 0, k,
                                                               bits, n_real)),
                f"{label}: the int64 entry differs from node_histogram_fixed_int")
        parts = [kh.node_histogram_int(binned[sl].contiguous(), v[:, sl].contiguous(),
                                       pos[sl].contiguous(), 256, 0, k, bits, n_real)
                 for sl in halves]
        require(torch.equal(parts[0] + parts[1], whole),
                f"{label}: the halves' int64 sums differ from the whole's")
        require(torch.equal(kh.to_float(whole, bits, n_real),
                            kh.fixed_to_float(whole, bits, n_real)),
                f"{label}: the conversion differs from fixed_to_float")
        print(f"  {label}: int64 sums bitwise node_histogram_fixed_int; halves + "
              f"halves == whole; conversion bitwise fixed_to_float")
    slots = torch.randint(0, 32, (N, 1), generator=gen, dtype=torch.int32).to(dev)
    vals = torch.stack([g, torch.rand(N, generator=gen).to(dev)], dim=-1).contiguous()
    bits5 = kh.channel_max_bits(vals.T)
    k5 = kh.histogram_int(slots, vals, 32, bits5, n_real)
    require(torch.equal(k5, kh.node_histogram_fixed_int(slots, vals.T.contiguous(), None, 32,
                                                        0, 1, bits5, n_real)),
            "K5's int64 entry differs from node_histogram_fixed_int")
    k5_parts = [kh.histogram_int(slots[sl].contiguous(), vals[sl].contiguous(), 32, bits5,
                                 n_real) for sl in halves]
    require(torch.equal(k5_parts[0] + k5_parts[1], k5), "K5: halves' sums differ")
    print("  K5 32 slots, C=2: int64 sums bitwise their plain version; halves sum to them")
    bits = kh.channel_max_bits(vt)
    acc = kh.node_histogram_int(binned, vt, pos_root, 256, 0, 1, bits, n_real)
    fixed_ms = time_ms(lambda: kh.node_histogram_int(binned, vt, pos_root, 256, 0, 1, bits,
                                                     n_real), reps=20)
    fixed_plain_ms = time_ms(lambda: kh.node_histogram_fixed_int(
        binned, vt, pos_root, 256, 0, 1, bits, n_real), reps=3)
    conv_ms = time_ms(lambda: kh.to_float(acc, bits, n_real), reps=20)
    conv_plain_ms = time_ms(lambda: kh.fixed_to_float(acc, bits, n_real), reps=3)
    conv_err = float((kh.to_float(acc, bits, n_real)
                      - kh.fixed_to_float(acc, bits, n_real)).abs().max())
    fixed_bound = bound_ms(n_real * W + nbytes_of(vt, pos_root, bits) + acc.numel() * 8,
                           n_real * W * 3)
    conv_bound = bound_ms(acc.numel() * (8 + 4) + nbytes_of(bits), acc.numel())
    # K4's one library call: index_add_ with the flat (feature, bin, node)
    # index of every (doc, feature) of the root given; timed, never used
    rows = td.step.doc_mask.nonzero()[:, 0]
    flat = (torch.arange(W, device=dev)[None, :] * 256 + binned[rows].long()).reshape(-1)
    vals4 = vt[:, rows].T[:, None, :].expand(-1, W, -1).reshape(-1, 3)
    k4_library = time_ms(
        lambda: torch.zeros((W * 256, 3), device=dev).index_add_(0, flat, vals4), reps=3)
    lib = torch.zeros((W * 256, 3), device=dev).index_add_(0, flat, vals4).reshape(W, 256, 3)
    k4_root = kh.node_histogram(binned, vt, pos_root, 256, 0, 1)
    mass = torch.zeros((W * 256, 3), device=dev).index_add_(0, flat, vals4.abs()).reshape(
        W, 256, 3)
    # float32 atomics in any order: within (t - 1) 2^-24 sum|v| of the exact
    # sum for a bin of t docs, and the kernel far closer than that
    terms = lib[..., :1]
    require(torch.equal(lib[..., 0], k4_root[..., 0])
            and bool(((lib - k4_root).abs() <= terms * 2.0 ** -23 * mass + 1e-6).all()),
            "K4: index_add_ disagrees with the kernel")
    print(f"  ms per call on {card}: K4's int64 sums (root, scale given) {fixed_ms:.4f} / "
          f"plain {fixed_plain_ms:.4f}; conversion {conv_ms:.4f} / plain {conv_plain_ms:.4f}; "
          f"K4 whole (its own scale, sums, conversion) "
          f"{k4_times['256 bins, k=1 (root)'][0]:.4f} (phase 5); K4's library call "
          f"(index_add_, flat index given) {k4_library:.4f}")
    print(f"  bounds: int64 sums {fixed_bound[0]:.4f} ms by {fixed_bound[1]}, conversion "
          f"{conv_bound[0]:.4f} ms by {conv_bound[1]}")
    del td, binned, g, vt, pos_root, pos16, slots, vals, acc, rows, flat, vals4, lib, mass
    del k4_root, whole, parts, k5, k5_parts
    torch.cuda.empty_cache()

    # -- phase 32: two gloo ranks on the one card against one -------------------
    phase(f"32: query-sharded LambdaMART, 2 gloo ranks on the one card against 1, "
          f"best@255, bestk@255, level@255, oblivious@255, 4 trees at "
          f"{train_ds.num_queries} + {valid_ds.num_queries} queries")
    growers32 = {
        "best": ("LambdaMart", dict(growth="best")),
        "bestk": ("LambdaMart", dict(growth="bestk")),
        "level": ("LambdaMart", dict(growth="level", max_depth=4)),
        "oblivious": ("ObliviousLambdaMart", dict(treedepth=4)),
    }
    ntrees32 = 4
    # phases 32-36 share the datasets written here; removed when the script exits
    data_dir = tempfile.mkdtemp(prefix="qr_smoke_")
    atexit.register(shutil.rmtree, data_dir, True)
    t0 = time.perf_counter()
    specs = {}
    train_npz = workers.save_dataset(train_ds, os.path.join(data_dir, "train.npz"))
    valid_npz = workers.save_dataset(valid_ds, os.path.join(data_dir, "valid.npz"))
    for gname, (learner, kw) in growers32.items():
        kw = dict(kw, ntrees=ntrees32, nthresholds=255, seed=1, esr=100)
        if learner == "LambdaMart":
            kw["nleaves"] = 16
        specs[gname] = dict(learner=learner, kwargs=kw, train=train_npz, valid=valid_npz)
    jobs1 = [j for s32 in specs.values()
             for j in (("train_rank", dict(s32, grouped=False)), ("train_rank", s32))]
    one = launch.run_ranks(workers.batch_rank, 1, args=(jobs1,), device="cuda",
                           backend="gloo", deadline=600)[0]
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = launch.run_ranks(workers.batch_rank, 2, args=(list(
        ("train_rank", s32) for s32 in specs.values()),), device="cuda", backend="gloo",
        deadline=600)
    t_two = time.perf_counter() - t0
    print(f"  launches: 1 rank {t_one:.1f} s (data written, loaded and binned, each "
          f"grower unsharded and as a 1-rank group), 2 ranks {t_two:.1f} s")
    group_launches = dict.fromkeys(kernel_histogram.LAUNCHES, 0)
    for i, gname in enumerate(growers32):
        solo, grp = one[2 * i], one[2 * i + 1]
        pair = [r[i] for r in two]
        for k, v in pair[0]["trees"].items():
            require(np.array_equal(v, pair[1]["trees"][k]),
                    f"{gname}: the two ranks hold different {k}")
            require(np.array_equal(v, grp["trees"][k]),
                    f"{gname}: 2 ranks' {k} differ from the 1-rank group's")
        d_tr = float(np.abs(np.subtract(pair[0]["history"]["train"],
                                        grp["history"]["train"])).max())
        require(d_tr <= 1e-6, f"{gname}: 2 ranks' train NDCG@10 off by {d_tr}")
        root = [(int(r["trees"]["feature"][0, 0]), int(r["trees"]["threshold_bin"][0, 0]))
                for r in (grp, solo)]
        d_solo = float(np.abs(np.subtract(grp["history"]["train"],
                                          solo["history"]["train"])).max())
        require(root[0] == root[1], f"{gname}: the group's root split differs")
        require(d_solo <= 1e-3, f"{gname}: group and unsharded NDCG@10 off by {d_solo}")
        same = all(np.array_equal(v, solo["trees"][k]) for k, v in grp["trees"].items())
        for r in [grp] + pair:
            for k in group_launches:
                group_launches[k] += r["launches"][k]
        c1, c2 = grp["collectives"], pair[0]["collectives"]
        s_grp = float(np.median(grp["history"]["iter_seconds"][2:]))
        s_solo = float(np.median(solo["history"]["iter_seconds"][2:]))
        s_pair = float(np.median(pair[0]["history"]["iter_seconds"][2:]))
        print(f"  {gname}@255: 2 ranks = 1-rank group node for node, leaf values bitwise, "
              f"train NDCG@10 within {d_tr:.3g}; 1-rank group vs unsharded: root {root[0]}, "
              f"NDCG@10 within {d_solo:.3g}, trees bitwise equal: {same}")
        print(f"    collectives a tree (rank 0): 1 rank {c1['calls'] / ntrees32:.1f} calls, "
              f"{c1['bytes'] / ntrees32 / 1e6:.3f} MB, {c1['seconds'] * 1e3 / ntrees32:.3f} "
              f"ms; 2 ranks {c2['calls'] / ntrees32:.1f} calls, "
              f"{c2['bytes'] / ntrees32 / 1e6:.3f} MB, {c2['seconds'] * 1e3 / ntrees32:.3f} ms")
        print(f"    s/tree (median of iterations 2+): unsharded {s_solo:.4f}, 1-rank group "
              f"{s_grp:.4f} ({s_grp / s_solo:.2f}x), 2 ranks sharing the card {s_pair:.4f}; "
              f"train NDCG@10 {[round(x, 5) for x in grp['history']['train']]}")
    print(f"  histogram launches in the group runs (every rank): {group_launches}")
    require(all(v > 0 for v in group_launches.values()),
            f"a kernel of the group path was not launched: {group_launches}")

    # -- phase 33: NCCL --------------------------------------------------------
    phase("33: a 1-rank NCCL group trains LambdaMART best@255, 4 trees, against "
          "phase 32's 1-rank gloo group")
    nccl = launch.run_ranks(workers.batch_rank, 1, args=([("train_rank", specs["best"])],),
                            device="cuda", deadline=600)[0][0]
    for k, v in one[1]["trees"].items():
        require(np.array_equal(v, nccl["trees"][k]), f"NCCL: {k} differs from gloo's")
    require(nccl["history"]["train"] == one[1]["history"]["train"],
            "NCCL: train NDCG@10 differs from gloo's")
    s_nccl = float(np.median(nccl["history"]["iter_seconds"][2:]))
    s_gloo = float(np.median(one[1]["history"]["iter_seconds"][2:]))
    s_solo = float(np.median(one[0]["history"]["iter_seconds"][2:]))
    print(f"  the NCCL group's trees and train NDCG@10 equal the gloo group's; collectives "
          f"a tree {nccl['collectives']['calls'] / ntrees32:.1f} calls, "
          f"{nccl['collectives']['bytes'] / ntrees32 / 1e6:.3f} MB, "
          f"{nccl['collectives']['seconds'] * 1e3 / ntrees32:.3f} ms of host time (the "
          f"enqueue); s/tree NCCL {s_nccl:.4f}, gloo {s_gloo:.4f}, unsharded {s_solo:.4f} "
          f"(phase 32, the same card)")
    cards = torch.cuda.device_count()
    if cards >= 2:
        duo = launch.run_ranks(workers.batch_rank, 2, args=(
            [("train_rank", specs["best"])],), device="cuda", deadline=600)
        for k, v in one[1]["trees"].items():
            require(all(np.array_equal(v, r[0]["trees"][k]) for r in duo),
                    f"2 NCCL ranks on 2 cards: {k} differs from 1 rank's")
        print(f"  2 NCCL ranks on 2 of the {cards} cards equal 1 rank node for node; "
              f"s/tree {float(np.median(duo[0][0]['history']['iter_seconds'][2:])):.4f}")
    else:
        print(f"  SKIPPED: 2 NCCL ranks on 2 cards, since this machine has {cards} CUDA "
              "device and NCCL refuses two ranks on one card")

    # -- phase 34: --num-shards in the two CLIs ----------------------------------
    phase("34: quicklearn --num-shards 1 and quickscore --num-shards 1 on the card, on "
          "data whose padded rows cross a power of two")
    with tempfile.TemporaryDirectory() as tmp:
        # 946 queries: 130,110 real docs padded to 131,072 rows, so a scale
        # counting the rows would round on another grid than the group's
        ds34 = make_ranking_dataset(num_queries=946, avg_docs_per_query=116,
                                    num_features=N_FEATURES, seed=0)
        svml = os.path.join(tmp, "mslr-shaped.svml")
        write_svml(ds34, svml)
        n_pad = -(-(ds34.num_docs + 1) // 1024) * 1024
        require(ds34.num_docs.bit_length() != n_pad.bit_length(),
                f"phase 34's data do not cross a power of two: {ds34.num_docs} docs, "
                f"{n_pad} rows")
        models = {}
        for tag, flag in (("plain", []), ("shards1", ["--num-shards", "1"])):
            models[tag] = os.path.join(tmp, f"{tag}.xml")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["--algo", "LAMBDAMART", "--train", svml, "--test", svml,
                               "--num-trees", "4", "--num-leaves", "16", "--partial", "0",
                               "--quiet", "--model-out", models[tag], "--scores",
                               os.path.join(tmp, f"{tag}.scores")] + flag)
            require(rc == 0, f"quicklearn {' '.join(flag)}: exit {rc}")
        a, b = (LTRAlgorithm.load(models[t]).ensemble.numpy() for t in ("plain", "shards1"))
        require(all(np.array_equal(a[k], b[k]) for k in a),
                "quicklearn --num-shards 1: its model differs from the no-flag run's")
        got, want = (np.loadtxt(os.path.join(tmp, f"{t}.scores")) for t in ("shards1", "plain"))
        require(np.array_equal(got, want), "quicklearn --num-shards 1: test scores differ")
        print(f"  quicklearn --num-shards 1 (one NCCL rank) saved the no-flag run's model and "
              f"test scores bit for bit ({ds34.num_docs} real docs and {n_pad} padded rows, "
              f"of bit lengths {ds34.num_docs.bit_length()} and {n_pad.bit_length()}: both "
              f"runs count the real docs in the fixed-point scale)")
        outs = {}
        for tag, flag in (("plain", []), ("shards1", ["--num-shards", "1"])):
            outs[tag] = os.path.join(tmp, f"qs.{tag}")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = quickscore.main(["-d", svml, "-m", models["plain"], "-r", "3", "-s",
                                      outs[tag]] + flag)
            require(rc == 0, f"quickscore {' '.join(flag)}: exit {rc}")
        require(np.array_equal(np.loadtxt(outs["plain"]), np.loadtxt(outs["shards1"])),
                "quickscore --num-shards 1 differs from quickscore")
        print("  quickscore --num-shards 1 writes quickscore's scores bit for bit")
        cards = torch.cuda.device_count()
        two_args = ["--algo", "LAMBDAMART", "--train", svml, "--num-trees", "2", "--quiet",
                    "--partial", "0", "--num-shards", "2"]
        if cards < 2:
            try:
                cli.main(two_args)
                require(False, "quicklearn --num-shards 2 ran on one card")
            except ValueError as e:
                require(f"{cards} are visible" in str(e), f"unexpected refusal: {e}")
                print(f"  quicklearn --num-shards 2 on {cards} card raises: {e}")
            try:
                quickscore.main(["-d", svml, "-m", models["plain"], "--num-shards", "2"])
                require(False, "quickscore --num-shards 2 ran on one card")
            except ValueError as e:
                require(f"{cards} are visible" in str(e), f"unexpected refusal: {e}")
                print(f"  quickscore --num-shards 2 on {cards} card raises: {e}")
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                require(cli.main(two_args) == 0, "quicklearn --num-shards 2 failed")
            print(f"  quicklearn --num-shards 2 trained on 2 of the {cards} cards")

    def three_ways(jobs):
        """``jobs`` (rank entry, spec) run unsharded and as a 1-rank gloo group
        (one launch), then as 2 gloo ranks sharing the card: (unsharded
        results, 1-rank group results, [rank 0, rank 1] results, seconds of
        the two launches)."""
        t0 = time.perf_counter()
        one = launch.run_ranks(workers.batch_rank, 1, args=(
            [j for e, sp in jobs for j in ((e, dict(sp, grouped=False)), (e, sp))],),
            device="cuda", backend="gloo", deadline=900)[0]
        t1 = time.perf_counter()
        two = launch.run_ranks(workers.batch_rank, 2, args=(jobs,), device="cuda",
                               backend="gloo", deadline=900)
        secs = (t1 - t0, time.perf_counter() - t1)
        return one[0::2], one[1::2], [list(r) for r in zip(*two)], secs

    def model_of(r):
        """A rank's result reduced to what must match bit for bit: the model
        (trees or weights) as bytes, and the decisions (metrics, dropped
        sets, pruned set)."""
        out = {"model": {k: np.asarray(v).tobytes()
                         for k, v in (r["trees"] if "trees" in r
                                      else {"weights": r["weights"]}).items()}}
        if "info" in r:
            out.update({k: r["info"][k] for k in ("pruned", "metric_before", "metric_after",
                                                  "metric_before_valid",
                                                  "metric_after_valid")})
        else:
            out.update({k: r["history"].get(k) for k in ("train", "valid", "dropped")})
        return out

    def hold_three(label, solo, grp, pair):
        require(model_of(pair[0]) == model_of(pair[1]), f"{label}: the two ranks differ")
        require(model_of(pair[0]) == model_of(grp), f"{label}: 2 ranks differ from 1 rank")
        require(model_of(grp) == model_of(solo),
                f"{label}: the 1-rank group differs from the unsharded run")

    def collectives(r, per):
        c = r["collectives"]
        return (f"{c['calls'] / per:.1f} calls, {c['bytes'] / per / 1e6:.4f} MB, "
                f"{c['seconds'] * 1e3 / per:.3f} host ms")

    # -- phase 35: DART under a group --------------------------------------------
    phase(f"35: DART under a group, {DART35_TREES} iterations at {train_ds.num_queries} + "
          f"{valid_ds.num_queries} queries: unsharded, a 1-rank gloo group and 2 gloo "
          "ranks sharing the card")
    dart35 = {"UNIFORM / TREE": dict(rate_drop=0.1),
              "X-DART (WCONTR, keep_drop)": dict(sample_type="WCONTR", keep_drop=True,
                                                 rate_drop=0.2)}
    jobs35 = [("train_rank", dict(learner="Dart", train=train_npz, valid=valid_npz, kwargs=dict(
        ntrees=DART35_TREES, nleaves=16, nthresholds=255, seed=1, esr=0, **kw)))
        for kw in dart35.values()]
    solo35, grp35, pair35, secs35 = three_ways(jobs35)
    print(f"  launches: 1 rank {secs35[0]:.1f} s (unsharded and the 1-rank group), 2 ranks "
          f"{secs35[1]:.1f} s")
    dart35_s = {}
    for i, label in enumerate(dart35):
        hold_three(f"DART {label}", solo35[i], grp35[i], pair35[i])
        h = grp35[i]["history"]
        n_it = len(h["train"])
        dropped = sum(len(d) for d in h["dropped"])
        require(dropped > 0, f"DART {label}: no tree was dropped")
        s = [float(np.median(r["history"]["iter_seconds"][2:]))
             for r in (solo35[i], grp35[i], pair35[i][0])]
        dart35_s[label] = s
        launches35 = {k: v for k, v in grp35[i]["launches"].items() if v}
        require(all(grp35[i]["launches"][k] > 0 for k in
                    ("node_histogram", "histogram", "histogram_to_float", "query_sum",
                     "qs_score")), f"DART {label}: a kernel was not launched: {launches35}")
        print(f"  {label}: 2 ranks = 1-rank group = unsharded bit for bit (trees, weights, "
              f"train and valid NDCG@10, dropped sets); {n_it} iterations, {dropped} trees "
              f"dropped, last train NDCG@10 {h['train'][-1]:.6f}")
        print(f"    s/iteration (median of iterations 2+): unsharded {s[0]:.4f}, 1-rank group "
              f"{s[1]:.4f} ({s[1] / s[0]:.2f}x), 2 ranks sharing the card {s[2]:.4f}")
        print(f"    collectives an iteration (rank 0): 1 rank {collectives(grp35[i], n_it)}; "
              f"2 ranks {collectives(pair35[i][0], n_it)}; launches (1-rank group) "
              f"{launches35}")

    # -- phase 36: the linear rankers and Cleaver under a group --------------------
    ds36 = [make_ranking_dataset(num_queries=n, num_features=N_FEATURES, seed=36 + i)
            for i, n in enumerate(LINEAR36_QUERIES)]
    phase(f"36: CoordinateAscent (1 epoch), LineSearch (2 iterations) and Cleaver "
          f"(QUALITY_LOSS 0.5, LineSearch 2 iterations, {CLEAVER36_TREES} trees) at "
          f"{ds36[0].num_queries} + {ds36[1].num_queries} queries x {N_FEATURES} features: "
          "unsharded, a 1-rank gloo group and 2 gloo ranks sharing the card")
    train36 = workers.save_dataset(ds36[0], os.path.join(data_dir, "train36.npz"))
    valid36 = workers.save_dataset(ds36[1], os.path.join(data_dir, "valid36.npz"))
    lm36 = LambdaMart(ntrees=CLEAVER36_TREES, nleaves=16, nthresholds=255, seed=1, esr=0)
    lm36.learn(ds36[0], None, Ndcg(10), verbose=False)
    model36 = os.path.join(data_dir, "lm36.xml")
    lm36.save(model36)
    jobs36 = [
        ("train_rank", dict(learner="CoordinateAscent", kwargs=dict(max_iterations=1),
                            train=train36, valid=valid36)),
        ("train_rank", dict(learner="LineSearch", kwargs=dict(max_iterations=2),
                            train=train36, valid=valid36)),
        ("optimize_rank", dict(model=model36, train=train36, valid=valid36, cleaver=dict(
            pruning_method="QUALITY_LOSS", pruning_rate=0.5,
            line_search=dict(max_iterations=2)))),
    ]
    solo36, grp36, pair36, secs36 = three_ways(jobs36)
    print(f"  launches: 1 rank {secs36[0]:.1f} s, 2 ranks {secs36[1]:.1f} s")
    linear36 = {}
    for i, label in enumerate(("COORDASC", "LINESEARCH", "CLEAVER")):
        hold_three(label, solo36[i], grp36[i], pair36[i])
        require(grp36[i]["launches"]["query_sum"] > 0, f"{label}: query_sum not launched")
        if label == "CLEAVER":
            s = [r["info"]["extract_seconds"] + r["info"]["prune_seconds"]
                 + r["info"].get("pre_ls_seconds", 0.0) + r["info"].get("post_ls_seconds", 0.0)
                 for r in (solo36[i], grp36[i], pair36[i][0])]
            info = grp36[i]["info"]
            require(grp36[i]["launches"]["qs_partial"] > 0, "Cleaver: K1's partial entry "
                    "was not launched")
            per, unit = 1, "a run"
            print(f"  CLEAVER: 2 ranks = 1-rank group = unsharded bit for bit (pruned set "
                  f"{len(info['pruned'])} of {info['num_trees_before']}, weights, metrics); "
                  f"train NDCG@10 {info['metric_before']:.6f} -> {info['metric_after']:.6f}")
        else:
            secs_key = "epoch_seconds" if label == "COORDASC" else "iteration_seconds"
            s = [float(np.median(r["history"][secs_key])) for r in
                 (solo36[i], grp36[i], pair36[i][0])]
            per = len(grp36[i]["history"]["train"])
            unit = "an epoch" if label == "COORDASC" else "an iteration"
            print(f"  {label}: 2 ranks = 1-rank group = unsharded bit for bit (weights, train "
                  f"and valid NDCG@10 {grp36[i]['history']['train'][-1]:.6f} / "
                  f"{grp36[i]['history']['valid'][-1]:.6f})")
        linear36[label] = s
        print(f"    seconds {unit}: unsharded {s[0]:.4f}, 1-rank group {s[1]:.4f} "
              f"({s[1] / s[0]:.2f}x), 2 ranks sharing the card {s[2]:.4f}; collectives "
              f"{unit} (rank 0): 1 rank {collectives(grp36[i], per)}; 2 ranks "
              f"{collectives(pair36[i][0], per)}")
    del ds36, lm36

    # -- phase 37: quicklearn --num-shards 1 with DART and the optimization phase --
    phase("37: quicklearn --algo DART with --opt-algo CLEAVER, --num-shards 1 against the "
          "no-flag run, on phase 34's data")
    with tempfile.TemporaryDirectory() as tmp:
        svml = os.path.join(tmp, "mslr-shaped.svml")
        write_svml(ds34, svml)
        files = {}
        for tag, flag in (("plain", []), ("shards1", ["--num-shards", "1"])):
            files[tag] = {k: os.path.join(tmp, f"{tag}.{k}") for k in
                          ("model.xml", "pruned.xml", "opt.xml", "ptrain.svml")}
            f = files[tag]
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["--algo", "DART", "--train", svml, "--num-trees", "8",
                               "--num-leaves", "16", "--rate-drop", "0.3", "--partial", "0",
                               "--quiet", "--model-out", f["model.xml"], "--opt-algo",
                               "CLEAVER", "--opt-method", "QUALITY_LOSS", "--pruning-rate",
                               "0.5", "--with-line-search", "--max-iterations", "2",
                               "--opt-model", f["opt.xml"], "--opt-algo-model",
                               f["pruned.xml"], "--train-partial", f["ptrain.svml"]] + flag)
            require(rc == 0, f"quicklearn --algo DART --opt-algo {' '.join(flag)}: exit {rc}")
        for k in ("model.xml", "pruned.xml"):
            a, b = (LTRAlgorithm.load(files[t][k]).ensemble.numpy() for t in files)
            require(all(np.array_equal(a[x], b[x]) for x in a),
                    f"quicklearn --num-shards 1: its {k} differs from the no-flag run's")
        for k in ("opt.xml", "ptrain.svml"):
            with open(files["plain"][k], "rb") as fa, open(files["shards1"][k], "rb") as fb:
                require(fa.read() == fb.read(), f"quicklearn --num-shards 1: {k} differs")
        kept = LTRAlgorithm.load(files["plain"]["pruned.xml"]).ensemble.num_trees
        print(f"  quicklearn --algo DART --opt-algo CLEAVER --num-shards 1 (one NCCL rank) "
              f"saved the no-flag run's DART model, pruned model ({kept} trees kept), "
              f"optimizer model and per-tree scores bit for bit")

    def row(name, source, replaces, n_launches, err, ms, plain_ms, bound, library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"quickrank_tpu_torch/csrc/{source}",
                "replaces": f"quickrank_tpu/ops/{replaces}", "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms}

    report = {"kernels": [
        row("qs_score", "qs_score.cu", "pallas_qs.py:100", launches["qs_score"], qs_err,
            *times[("qs", 1000, 16)], qs_bound),
        row("perfect_score", "perfect_score.cu", "pallas_perfect.py:102",
            launches["perfect_score"], pf_err, *times[("perfect", 1000, 4)], pf_bound),
        row("oblivious_score", "oblivious_score.cu", "pallas_oblivious.py:100", k3_launches,
            obl_err, *obl_times[(1000, 4)], obl_bound),
        # launches: the training runs of phase 7, RankBoost's (phase 27) and
        # the group runs of phase 32 (every rank)
        row("node_histogram", "histogram.cu", "pallas_histogram.py:183",
            train_launches["node_histogram"] + rb_launches["node_histogram"]
            + group_launches["node_histogram"],
            hist_err["node_histogram"], *k4_times["256 bins, k=1 (root)"], k4_bound,
            library_ms=k4_library),
        row("histogram", "histogram.cu", "pallas_histogram.py:278",
            train_launches["histogram"] + group_launches["histogram"], hist_err["histogram"],
            *k5_times, k5_bound, library_ms=k5_library),
        # the largest byte difference over the three directive sets; no
        # single PyTorch call computes the function (the row scatter alone is
        # printed by phase 13)
        row("partition_rows", "partition_rows.cu", "pallas_partition.py:236",
            on_counts["partition_rows"], k6_err, k6_times[0], k6_times[1], k6_times[3]),
        # K1's partial entry (per-tree columns, no sum): its launches on
        # Cleaver's extraction and its hold and times on one of that
        # extraction's blocks (phase 25)
        row("qs_partial", "qs_score.cu", "pallas_qs.py:100", cleaver_partial_launches,
            partial_err, partial_ms, partial_plain_ms, partial_bound),
        # K4's and K5's conversion of the int64 sums, a launch of its own
        # since the group's ranks add their sums before it; timed on K4's
        # root pass (phase 31)
        row("histogram_to_float", "histogram.cu", "pallas_histogram.py:183",
            train_launches["histogram_to_float"] + rb_launches["histogram_to_float"]
            + group_launches["histogram_to_float"], conv_err, conv_ms, conv_plain_ms,
            conv_bound),
    ]}
    print(f"  s/tree at {train_ds.num_queries} queries on {card}: best@255 "
          f"{train_runs['best'][1]:.4f}, level@255 {train_runs['level'][1]:.4f}, bestk@255 "
          f"{bestk_per_tree:.4f}, oblivious@255 {obl_per_tree:.4f}, best@255 cluster=on "
          f"{on_s:.4f} beside cluster=off {off_s:.4f}; DART {dart_s_iter:.4f} s/iteration, "
          f"delta {dart_delta_ms:.4f} ms; COORDASC {linear_runs['COORDASC']:.4f} s/epoch, "
          f"LINESEARCH {linear_runs['LINESEARCH']:.4f} s/iteration, candidate batch "
          f"{batch_ms:.4f} ms; Cleaver {cleaver_s:.2f} s; RankBoost {rb_s_round:.4f} s/round "
          f"(K4 {rb_k4_ms:.4f} ms a round); "
          + ", ".join(f"{k} {v:.4f}" for k, v in sampled_runs.items()) + " s/tree")
    # the fixed-order query sum: not a TPU kernel, so a line of its own (its
    # launches are phase 6's training runs; held bitwise against its plain
    # version there, at a metric's [Q, D] terms)
    q_label, q_t = next(iter(qsum_times.items()))
    print(json.dumps({"query_sum": {
        "name": "query_sum", "route": "cuda", "source": "quickrank_tpu_torch/csrc/query_sum.cu",
        "replaces": None, "shape": q_label, "launches": qsum_launches, "max_abs_err": 0.0,
        "ms": q_t[0], "plain_ms": q_t[1], "float64_sum_ms": q_t[2], "bound_ms": q_t[4][0],
        "bound_by": q_t[4][1], "library_ms": q_t[3]}}))
    print(f"  under a group (phases 35-36; unsharded / 1-rank gloo group / 2 gloo ranks): "
          + "; ".join(f"DART {k} {' / '.join(f'{x:.4f}' for x in v)} s/iteration"
                      for k, v in dart35_s.items())
          + "; " + "; ".join(f"{k} {' / '.join(f'{x:.4f}' for x in v)} s"
                             for k, v in linear36.items()))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
