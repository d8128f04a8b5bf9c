"""Boundaries of the port: it imports nothing of JAX or of the JAX package,
a CUDA tensor reaches a kernel or an exception (never the plain version),
and the kernels agree with their plain versions on the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.ops import (
    _cuda,
    kernel_histogram,
    kernel_oblivious,
    kernel_perfect,
    kernel_qs,
)
from quickrank_tpu_torch.ops import oblivious as plain_oblivious
from quickrank_tpu_torch.trees.oblivious import ObliviousEnsemble
from quickrank_tpu_torch.trees.perfect import ensemble_to_perfect, score_perfect
from quickrank_tpu_torch.trees.qs import ensemble_to_qs, score_qs
from quickrank_tpu_torch.trees.qs import partial_scores_qs as qs_partial_plain
from quickrank_tpu_torch.trees.random_ensemble import (
    random_balanced_ensemble,
    random_bestfirst_ensemble,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import quickrank_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "quickrank_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has imported jax already), importing
    every module of the port loads no jax, flax or quickrank_tpu module."""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20, res.stdout


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _cuda.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build(force=True)


@pytest.mark.parametrize("wrapper", ["qs", "perfect"])
def test_other_devices_raise(wrapper):
    """A tensor on neither the CPU nor CUDA is refused, not scored by the
    plain version."""
    ens = random_balanced_ensemble(3, 2, 4, seed=1)
    X = torch.zeros((8, 4), device="meta")
    if wrapper == "qs":
        with pytest.raises(ValueError, match="device"):
            kernel_qs.score_qs(X, ensemble_to_qs(ens).to("meta"))
    else:
        with pytest.raises(ValueError, match="device"):
            kernel_perfect.score_perfect(X, ensemble_to_perfect(ens).to("meta"))


def test_tables_on_another_device_raise():
    ens = random_balanced_ensemble(3, 2, 4, seed=1)
    X = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="tables on meta"):
        kernel_qs.score_qs(X, ensemble_to_qs(ens).to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("leaves", [16, 64, 128])
def test_qs_kernel_matches_plain_on_card(cuda_device, leaves):
    ens = random_bestfirst_ensemble(30, leaves, 24, seed=leaves)
    tables = ensemble_to_qs(ens).to(cuda_device)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1000, 24), dtype=np.float32)).to(cuda_device)
    before = kernel_qs.LAUNCHES
    got = kernel_qs.score_qs(X, tables)
    torch.cuda.synchronize()
    assert kernel_qs.LAUNCHES == before + 1
    assert torch.equal(got, score_qs(X, tables))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["N=1", "N=127", "N=129", "F=1", "F=700 (unstaged)",
                                  "65 leaves", "dead slots only", "u8 rows",
                                  "unaligned rows"])
def test_qs_kernel_edges_on_card(cuda_device, case):
    """K1 bitwise against the plain scorer where its staging changes shape:
    a block that is not full (1, 127, 129 docs), one feature, rows too wide
    to stage (read from global memory), leaf sets of two words, an ensemble
    whose every slot is dead (all Kahan steps add 0), uint8 bin rows against
    bin-space tables, and rows that do not start on a 16-byte boundary."""
    N = {"N=1": 1, "N=127": 127, "N=129": 129}.get(case, 1000)
    F = {"F=1": 1, "F=700 (unstaged)": 700, "unaligned rows": 23}.get(case, 24)
    leaves = 65 if case == "65 leaves" else 16
    ens = random_bestfirst_ensemble(30, leaves, F, seed=len(case))
    if case == "dead slots only":
        ens.num_trees = 0
    rng = np.random.default_rng(0)
    if case == "u8 rows":
        ens.threshold_bin = torch.from_numpy(
            rng.integers(0, 255, size=tuple(ens.threshold_bin.shape)).astype(np.int32))
        tables = ensemble_to_qs(ens, space="bin").to(cuda_device)
        X = torch.from_numpy(rng.integers(0, 256, size=(N, F)).astype(np.uint8))
    else:
        tables = ensemble_to_qs(ens).to(cuda_device)
        X = torch.from_numpy(rng.standard_normal((N + 1, F), dtype=np.float32))
    X = X.to(cuda_device)
    if case == "unaligned rows":
        X = X[1:]  # contiguous, 92 bytes past the allocation's start
        assert X.data_ptr() % 16 != 0
    elif case != "u8 rows":
        X = X[:N].contiguous()
    before = kernel_qs.LAUNCHES
    got = kernel_qs.score_qs(X, tables)
    torch.cuda.synchronize()
    assert kernel_qs.LAUNCHES == before + 1
    assert torch.equal(got, score_qs(X, tables))
    assert torch.equal(got.cpu(), score_qs(X.cpu(), tables.to("cpu")))
    if case == "dead slots only":
        assert not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("space", ["value", "bin"])
@pytest.mark.parametrize("leaves", [1024, 2048, 4096])
def test_qs_kernel_wide_trees_on_card(cuda_device, leaves, space):
    """K1 on trees whose records do not fit one block's shared memory (16,
    32 and 64 leaf-set words; from 2,560 leaves one word spans tiles), in
    value space on float32 rows and in bin space on u8 rows, with a dead
    slot: bitwise the plain scorer on the card and on the CPU."""
    ens = random_bestfirst_ensemble(3, leaves, 24, seed=leaves)
    ens.num_trees = 2
    rng = np.random.default_rng(leaves)
    if space == "bin":
        ens.threshold_bin = torch.from_numpy(
            rng.integers(0, 255, size=tuple(ens.threshold_bin.shape)).astype(np.int32))
        X = torch.from_numpy(rng.integers(0, 256, size=(1000, 24)).astype(np.uint8))
    else:
        X = torch.from_numpy(rng.standard_normal((1000, 24), dtype=np.float32))
    tables = ensemble_to_qs(ens, space=space)
    before = kernel_qs.LAUNCHES
    got = kernel_qs.score_qs(X.to(cuda_device), tables.to(cuda_device))
    torch.cuda.synchronize()
    assert kernel_qs.LAUNCHES == before + 1
    assert torch.equal(got, score_qs(X.to(cuda_device), tables.to(cuda_device)))
    assert torch.equal(got.cpu(), score_qs(X, tables))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_perfect_kernel_matches_plain_on_card(cuda_device, depth):
    ens = random_balanced_ensemble(130, depth, 24, seed=depth)
    pe = ensemble_to_perfect(ens)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((1000, 24), dtype=np.float32))
    before = kernel_perfect.LAUNCHES
    got = kernel_perfect.score_perfect(X.to(cuda_device), pe.to(cuda_device))
    torch.cuda.synchronize()
    assert kernel_perfect.LAUNCHES == before + 1
    assert torch.equal(got, score_perfect(X.to(cuda_device), pe.to(cuda_device)))
    assert torch.equal(got.cpu(), score_perfect(X, pe))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["N=1", "N=127", "N=129", "F=1", "F=700 (unstaged)",
                                  "unaligned rows", "a tree of weight 0",
                                  "NaN and inf features"])
def test_perfect_kernel_edges_on_card(cuda_device, case):
    """K2 bitwise against the plain scorer, on the card and on the CPU,
    where its staging or its routing changes: a block that is not full (1,
    127, 129 docs), one feature, rows too wide to stage (read from global
    memory), rows that do not start on a 16-byte boundary, a tree whose
    wleaf is all 0, and NaN (left), +inf (right, past pass-through nodes
    too) and -inf features.  130 trees of depth 4 span several model
    tiles."""
    N = {"N=1": 1, "N=127": 127, "N=129": 129}.get(case, 1000)
    F = {"F=1": 1, "F=700 (unstaged)": 700, "unaligned rows": 23}.get(case, 24)
    ens = random_balanced_ensemble(130, 4, F, seed=len(case))
    if case == "a tree of weight 0":
        ens.weight[5] = 0.0
    pe = ensemble_to_perfect(ens)
    if case == "NaN and inf features":
        pe.thr[7, 3:] = float(np.finfo(np.float32).max)  # pass-through nodes
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N + 1, F), dtype=np.float32)
    if case == "NaN and inf features":
        X[::5, ::3] = np.nan
        X[1::5, 1::3] = np.inf
        X[2::5, 2::3] = -np.inf
    X = torch.from_numpy(X).to(cuda_device)
    X = X[1:] if case == "unaligned rows" else X[:N].contiguous()
    assert (X.data_ptr() % 16 != 0) == (case == "unaligned rows")
    before = kernel_perfect.LAUNCHES
    got = kernel_perfect.score_perfect(X, pe.to(cuda_device))
    torch.cuda.synchronize()
    assert kernel_perfect.LAUNCHES == before + 1
    assert torch.equal(got, score_perfect(X, pe.to(cuda_device)))
    assert torch.equal(got.cpu(), score_perfect(X.cpu(), pe))


def _oblivious(T, D, F, seed, dead_tree=None):
    rng = np.random.default_rng(seed)
    d = dict(fid=rng.integers(0, F, size=(T, D)), thr=rng.normal(size=(T, D)),
             thr_bin=rng.integers(0, 200, size=(T, D)), leaf=rng.normal(size=(T, 2 ** D)),
             weight=rng.uniform(0.05, 0.3, size=T), num_trees=T)
    if dead_tree is not None:
        d["thr"][dead_tree] = np.finfo(np.float32).max
        d["thr_bin"][dead_tree] = 2 ** 30
    return ObliviousEnsemble.from_numpy(d)


@pytest.mark.gpu
@pytest.mark.parametrize("N,T,D,F", [(1, 30, 4, 24), (257, 30, 4, 24), (1000, 1, 4, 24),
                                     (1000, 30, 1, 24), (1000, 100, 8, 24),
                                     (300, 7, 12, 24), (300, 30, 4, 700)])
def test_oblivious_kernel_matches_plain_on_card(cuda_device, N, T, D, F):
    """K3 bitwise against its plain version: one doc, one past two blocks,
    one tree, depth 1, depth 8 (several tiles of trees), depth 12 (one tree
    a tile), rows too wide to stage in shared memory, with an all-dead tree
    where there is room for one."""
    ens = _oblivious(T, D, F, seed=N + T + D, dead_tree=1 if T > 1 else None)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((N, F), dtype=np.float32))
    before = kernel_oblivious.LAUNCHES
    got = kernel_oblivious.score_oblivious(X.to(cuda_device), ens.to(cuda_device))
    torch.cuda.synchronize()
    assert kernel_oblivious.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), plain_oblivious.score_oblivious(X, ens))
    assert torch.equal(got, plain_oblivious.score_oblivious(X.to(cuda_device),
                                                          ens.to(cuda_device)))


@pytest.mark.gpu
def test_oblivious_kernel_scores_bins_on_card(cuda_device):
    ens = _oblivious(40, 4, 24, seed=3, dead_tree=2)
    bins = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(999, 24))).to(
        torch.uint8)
    got = kernel_oblivious.score_oblivious(bins.to(cuda_device), ens.to(cuda_device))
    assert torch.equal(got.cpu(), plain_oblivious.score_oblivious_binned(bins, ens))


@pytest.mark.gpu
def test_oblivious_kernel_threshold_equality_on_card(cuda_device):
    """A feature equal to its threshold routes left, on the card too."""
    ens = _oblivious(4, 2, 8, seed=5)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 8), dtype=np.float32))
    for t in range(4):
        for d in range(2):
            X[t * 2 + d, int(ens.fid[t, d])] = ens.thr[t, d]
    idx = plain_oblivious.leaf_index(X, ens.fid, ens.thr)
    assert all(int(idx[t * 2, t]) < 2 and int(idx[t * 2 + 1, t]) % 2 == 0 for t in range(4))
    got = kernel_oblivious.score_oblivious(X.to(cuda_device), ens.to(cuda_device))
    assert torch.equal(got.cpu(), plain_oblivious.score_oblivious(X, ens))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["contiguous", "dtype", "int32-bins", "cpu-model", "deep"])
def test_oblivious_kernel_refuses_on_card(cuda_device, bad):
    """What the kernel does not take raises; nothing falls to the plain
    version."""
    ens = _oblivious(3, 13 if bad == "deep" else 2, 8, seed=1)
    X = torch.zeros((16, 8), device=cuda_device)
    X = {"contiguous": torch.zeros((8, 16), device=cuda_device).T, "dtype": X.double(),
         "int32-bins": X.int(), "cpu-model": X, "deep": X}[bad]
    before = kernel_oblivious.LAUNCHES
    with pytest.raises(ValueError):
        kernel_oblivious.score_oblivious(X, ens if bad == "cpu-model" else ens.to(cuda_device))
    assert kernel_oblivious.LAUNCHES == before


def _histogram_inputs(N=6000, W=40, num_bins=256, seed=0):
    """u8 bins (some >= num_bins, dropped), channel-major values zero on a
    tenth of the docs, node ids in [0, 16)."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, min(num_bins + 8, 256), size=(N, W)).astype(np.uint8)
    mask = rng.uniform(size=N) < 0.9
    g = rng.normal(size=N).astype(np.float32)
    vt = np.stack([mask, g * mask, g * g * mask]).astype(np.float32)
    pos = rng.integers(0, 16, size=N).astype(np.int32)
    return binned, vt, pos


def _assert_within_sum_tolerance(got, plain, mass, terms, rounding, count_channels):
    """Count channels exact; value channels within 1e-4 of the bin's sum of
    |values| (float32 summation error of the plain version) plus, for each
    of the bin's ``terms`` values, the kernel's fixed-point ``rounding``."""
    got, plain, mass, terms = got.cpu(), plain.cpu(), mass.cpu(), terms.cpu()
    assert torch.equal(got[..., count_channels], plain[..., count_channels])
    bound = 1e-4 * mass.double() + terms.double() * rounding
    assert bool(((got.double() - plain.double()).abs() <= bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins,n0,k,C", [(256, 0, 1, 3), (64, 0, 1, 3), (256, 3, 10, 3),
                                             (64, 2, 4, 3), (256, 0, 16, 2), (256, 0, 8, 2)])
def test_node_histogram_kernel_matches_plain_on_card(cuda_device, num_bins, n0, k, C):
    """K4 against its plain version, and bitwise equal to itself across
    launches (integer sums in any order); C = 2 with k = 8 and 16 are the
    oblivious grower's levels (64 KB of shared memory a feature at k = 16)."""
    binned, vt, pos = (torch.from_numpy(a) for a in _histogram_inputs(num_bins=num_bins))
    vt = vt[:C].contiguous()
    dev = [t.to(cuda_device) for t in (binned, vt, pos)]
    before = kernel_histogram.LAUNCHES["node_histogram"]
    got = kernel_histogram.node_histogram(*dev, num_bins, n0, k)
    again = kernel_histogram.node_histogram(*dev, num_bins, n0, k)
    torch.cuda.synchronize()
    assert kernel_histogram.LAUNCHES["node_histogram"] == before + 2
    assert torch.equal(got, again)
    plain, mass, terms = (kernel_histogram.node_histogram(binned, v, pos, num_bins, n0, k)
                          for v in (vt, vt.abs(), torch.ones_like(vt)))
    _assert_within_sum_tolerance(got, plain, mass, terms,
                                 kernel_histogram.rounding_error(vt).repeat(k),
                                 slice(0, None, C))


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins,n0,k,C", [(256, 0, 1, 3), (64, 0, 1, 3), (256, 3, 10, 3),
                                             (64, 2, 4, 3), (256, 0, 16, 2), (256, 0, 8, 2),
                                             (256, 0, 2, 8)])
def test_node_histogram_kernel_equals_fixed_reference_on_card(cuda_device, num_bins, n0, k, C):
    """K4 bit for bit against its exact reference (the kernel's fixed-point
    arithmetic in plain torch) at every shape of the test above, and with 8
    channels (8 features a block)."""
    binned, vt, pos = (torch.from_numpy(a) for a in _histogram_inputs(num_bins=num_bins))
    vt = torch.cat([vt, vt[1:] * 3, vt[1:] * -5, vt[1:2] * 7])[:C].contiguous()
    dev = [t.to(cuda_device) for t in (binned, vt, pos)]
    got = kernel_histogram.node_histogram(*dev, num_bins, n0, k)
    assert torch.equal(got, kernel_histogram.node_histogram_fixed(*dev, num_bins, n0, k))
    assert torch.equal(got.cpu(), kernel_histogram.node_histogram_fixed(
        binned, vt, pos, num_bins, n0, k))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["empty node", "every doc out of range", "f_used < W",
                                  "W % 16 != 0", "int32 bins", "no docs",
                                  "shared-memory limit"])
def test_node_histogram_kernel_edges_on_card(cuda_device, case):
    """K4 bit for bit against its exact reference at the edges of the new
    layout: a node slot no doc is in, a pass with every doc outside
    [n0, n0 + k), fewer features than columns with payload bytes in the pad
    columns, a width that is no multiple of 16, int32 bin ids (with ids below
    0 and above num_bins, dropped), an empty matrix, and C * B at the most one
    block's shared memory holds (one more bin raises)."""
    W = 37 if case == "W % 16 != 0" else 40
    binned, vt, pos = _histogram_inputs(W=W)
    num_bins, n0, k, f_used = 256, 0, 4, 0
    if case == "empty node":
        pos[pos == 2] = 9
    elif case == "every doc out of range":
        n0 = 16
    elif case == "f_used < W":
        f_used = 33  # columns 33.. hold bytes that are no bins of a feature
        binned[:, 33:] = np.random.default_rng(1).integers(0, 256, size=(len(pos), W - 33))
    elif case == "int32 bins":
        binned = binned.astype(np.int32) - 2
    elif case == "no docs":
        binned, vt, pos = binned[:0], np.ascontiguousarray(vt[:, :0]), pos[:0]
    elif case == "shared-memory limit":
        # one channel; the largest B whose one-feature block fits
        num_bins = next(b for b in range(1 << 15, 0, -1)
                        if kernel_histogram.min_shared_bytes(1, b) <= kernel_histogram.SMEM_MAX)
        binned = np.random.default_rng(2).integers(-1, num_bins + 1, size=(len(pos), 2)).astype(
            np.int32)
        vt = np.ascontiguousarray(vt[1:2])
    dev = [torch.from_numpy(a).to(cuda_device) for a in (binned, vt, pos)]
    got = kernel_histogram.node_histogram(*dev, num_bins, n0, k, f_used=f_used)
    torch.cuda.synchronize()
    want = kernel_histogram.node_histogram_fixed(*dev, num_bins, n0, k, f_used=f_used)
    assert got.shape == want.shape and torch.equal(got, want)
    if case in ("every doc out of range", "no docs"):
        assert not got.any()
    if case == "empty node":
        assert not got[..., 6:9].any() and got[..., 0].any()
    if case == "shared-memory limit":
        before = kernel_histogram.LAUNCHES["node_histogram"]
        with pytest.raises(ValueError, match="shared memory"):
            kernel_histogram.node_histogram(*dev, num_bins + 32, n0, k)
        assert kernel_histogram.LAUNCHES["node_histogram"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("num_slots", [32, 9])
def test_histogram_kernel_matches_plain_on_card(cuda_device, num_slots):
    """K5 as segment sums: one column of int32 slot ids, doc-major values."""
    rng = np.random.default_rng(num_slots)
    index = torch.from_numpy(rng.integers(0, num_slots + 2, size=(50000, 1)).astype(np.int32))
    vals = torch.from_numpy(np.stack([rng.normal(size=50000),
                                      rng.uniform(size=50000)], -1).astype(np.float32))
    got = kernel_histogram.histogram(index.to(cuda_device), vals.to(cuda_device), num_slots)
    again = kernel_histogram.histogram(index.to(cuda_device), vals.to(cuda_device), num_slots)
    assert torch.equal(got, again)
    plain, mass, terms = (kernel_histogram.histogram(index, v, num_slots)
                          for v in (vals, vals.abs(), torch.ones_like(vals)))
    _assert_within_sum_tolerance(got, plain, mass, terms,
                                 kernel_histogram.rounding_error(vals.T), slice(0, 0))
    # and bit for bit against the exact reference
    assert torch.equal(got.cpu(), kernel_histogram.node_histogram_fixed(
        index, vals.T.contiguous(), None, num_slots, 0, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("growth", ["best", "level", "bestk", "oblivious", "clustered"])
def test_training_on_card_goes_through_kernels(cuda_device, growth):
    """A short LambdaMART run on the card (the default device) launches K4
    (and K5 unless level-wise, and K6 when node-clustered), and tracks the
    same run on the CPU."""
    from quickrank_tpu_torch.ops import kernel_partition

    from quickrank_tpu_torch.data.synthetic import make_train_valid_test
    from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
    from quickrank_tpu_torch.metrics import Ndcg

    train, valid, _ = make_train_valid_test(num_queries=(40, 10, 10))
    if growth == "oblivious":
        make = lambda: ObliviousLambdaMart(ntrees=3, treedepth=4)  # noqa: E731
    elif growth == "clustered":
        make = lambda: LambdaMart(ntrees=3, nleaves=16, cluster="on")  # noqa: E731
    else:
        make = lambda: LambdaMart(ntrees=3, nleaves=16, growth=growth,  # noqa: E731
                                  max_depth=4 if growth == "level" else 0)
    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    kernel_partition.LAUNCHES["partition_rows"] = 0
    card = make().learn(train, valid, Ndcg(10), verbose=False)
    assert (kernel_partition.LAUNCHES["partition_rows"] > 0) == (growth == "clustered")
    assert kernel_histogram.LAUNCHES["node_histogram"] > 0
    assert (kernel_histogram.LAUNCHES["histogram"] > 0) == (growth != "level")
    cpu = make().learn(train, valid, Ndcg(10), verbose=False, device="cpu")
    np.testing.assert_allclose(card["train"], cpu["train"], atol=1e-3)


@pytest.mark.gpu
def test_warm_start_rescore_on_card_goes_through_qs_kernel(cuda_device):
    """On the card a warm start rescoring rides K1 on the u8 bin matrix and
    reproduces the carried scores bit for bit."""
    from quickrank_tpu_torch.data.synthetic import make_train_valid_test
    from quickrank_tpu_torch.learning import LambdaMart
    from quickrank_tpu_torch.learning.mart import TrainData, rebin_ensemble, rescore_binned
    from quickrank_tpu_torch.metrics import Ndcg

    train, _, _ = make_train_valid_test(num_queries=(40, 10, 10))
    lm = LambdaMart(ntrees=4, nleaves=16)
    lm.learn(train, None, Ndcg(10), verbose=False)
    td = TrainData.build(train, lm.nthresholds)
    before = kernel_qs.LAUNCHES
    rebinned = rebin_ensemble(lm.ensemble, td.thresholds, force=True)
    got = rescore_binned(rebinned, td.step, lm._descend_depth())
    assert kernel_qs.LAUNCHES == before + 1
    assert torch.equal(got, lm.train_scores)
    # and the kernel's u8 entry equals its own plain version on those bins
    tables = ensemble_to_qs(rebinned, space="bin").to(cuda_device)
    assert torch.equal(got, score_qs(td.step.binned, tables))
    lm.ntrees = 6
    assert len(lm.learn(train, None, Ndcg(10), verbose=False, warm_start=True)["train"]) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["16 leaves", "N=129", "F=700 (unstaged)", "u8 rows",
                                  "dead slots", "slots [7, 23)", "2048 leaves",
                                  "2048 leaves, u8 rows"])
def test_qs_partial_kernel_matches_plain_on_card(cuda_device, case):
    """K1's partial entry, [N, trees] unweighted exit-leaf values, bitwise
    its plain version (trees/qs.py::partial_scores_qs) in the narrow kernel
    (staged and unstaged rows, float32 and u8) and the wide one, over all
    slots and over a range of them."""
    N = 129 if case == "N=129" else 1000
    F = 700 if case.startswith("F=700") else 24
    leaves = 2048 if case.startswith("2048") else 16
    T = 3 if leaves == 2048 else 30
    ens = random_bestfirst_ensemble(T, leaves, F, seed=len(case))
    if case == "dead slots":
        ens.num_trees = 20
    rng = np.random.default_rng(3)
    if "u8" in case:
        ens.threshold_bin = torch.from_numpy(
            rng.integers(0, 255, size=tuple(ens.threshold_bin.shape)).astype(np.int32))
        tables = ensemble_to_qs(ens, space="bin")
        X = torch.from_numpy(rng.integers(0, 256, size=(N, F)).astype(np.uint8))
    else:
        tables = ensemble_to_qs(ens)
        X = torch.from_numpy(rng.standard_normal((N, F), dtype=np.float32))
    t0, t1 = (7, 23) if case == "slots [7, 23)" else (0, T)
    before = kernel_qs.PARTIAL_LAUNCHES
    got = kernel_qs.partial_scores_qs(X.to(cuda_device), tables.to(cuda_device), t0, t1)
    torch.cuda.synchronize()
    assert kernel_qs.PARTIAL_LAUNCHES == before + 1
    assert got.shape == (N, t1 - t0)
    assert torch.equal(got.cpu(), qs_partial_plain(X, tables, t0, t1))
    if case == "dead slots":
        assert not got[:, 20:].any()


@pytest.mark.gpu
def test_dart_delta_on_card(cuda_device):
    """DART's dropped-set delta on the card: K1 on the gathered rows of the
    packed table, bitwise the plain scorer on the same gathered tables, and
    a weight changed between two deltas changes the second one."""
    from quickrank_tpu_torch.learning.dart import DropTable

    ens = random_bestfirst_ensemble(40, 16, 24, seed=4)
    rng = np.random.default_rng(4)
    ens.threshold_bin = torch.from_numpy(
        rng.integers(0, 255, size=tuple(ens.threshold_bin.shape)).astype(np.int32))
    X = torch.from_numpy(rng.integers(0, 256, size=(3000, 24)).astype(np.uint8))
    table = DropTable(ens.to(cuda_device), cuda_device)
    slots = [31, 2, 17, 9]
    w = np.array([0.1, 0.05, 0.2, 0.125], np.float32)
    before = kernel_qs.LAUNCHES
    got = table.delta(slots, w, X.to(cuda_device))
    torch.cuda.synchronize()
    assert kernel_qs.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), score_qs(X, table.gathered(slots, w).to("cpu")))
    w2 = w.copy()
    w2[1] = 0.5
    again = table.delta(slots, w2, X.to(cuda_device))
    assert not torch.equal(again, got)
    assert torch.equal(again.cpu(), score_qs(X, table.gathered(slots, w2).to("cpu")))


@pytest.mark.gpu
@pytest.mark.parametrize("sample_type,normalize_type", [("UNIFORM", "TREE"),
                                                        ("WEIGHTED", "LINESEARCH"),
                                                        ("CONTR", "CONTR")])
def test_dart_on_card_goes_through_kernels(cuda_device, sample_type, normalize_type):
    """A short DART run on the card (the default device), under three
    sampler / normalization pairs, launches K1 (the dropped-set deltas), K4
    and K5, drops the same trees as the same run on the CPU for its first
    iterations, gives its train NDCG@10 within 1e-3 before the first drop,
    as LambdaMART, and learns as well: the last iteration's within 0.05.
    After a drop the two runs drift apart: the histogram kernels' last bits
    move leaf values, and subtracting a dropped tree leaves docs that tie in
    the kept trees a last bit apart, so their rank order, and the lambdas
    with it, follows those bits (UNIFORM / TREE: 1.8e-3 apart here at most);
    LINESEARCH's argmax over NDCG plateaus turns such bits into another tree
    weight (0.023 apart)."""
    from quickrank_tpu_torch.data.synthetic import make_train_valid_test
    from quickrank_tpu_torch.learning import Dart
    from quickrank_tpu_torch.metrics import Ndcg

    train, valid, _ = make_train_valid_test(num_queries=(40, 10, 10))
    make = lambda: Dart(ntrees=6, nleaves=16, rate_drop=0.5, seed=2,  # noqa: E731
                        sample_type=sample_type, normalize_type=normalize_type)
    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    kernel_qs.LAUNCHES = 0
    card = make().learn(train, valid, Ndcg(10), verbose=False)
    assert kernel_qs.LAUNCHES > 0
    assert kernel_histogram.LAUNCHES["node_histogram"] > 0
    assert kernel_histogram.LAUNCHES["histogram"] > 0
    cpu = make().learn(train, valid, Ndcg(10), verbose=False, device="cpu")
    assert card["dropped"][:3] == cpu["dropped"][:3]
    first = next(i for i, d in enumerate(cpu["dropped"]) if d)
    np.testing.assert_allclose(card["train"][:first], cpu["train"][:first], atol=1e-3)
    assert card["train"][-1] > card["train"][0]
    assert abs(card["train"][-1] - cpu["train"][-1]) <= 0.05


def _small_folds():
    from quickrank_tpu_torch.data.synthetic import make_train_valid_test

    return make_train_valid_test(num_queries=(40, 12, 12), avg_docs_per_query=30,
                                 num_features=12)


def test_linear_and_cleaver_entry_points_need_a_card():
    """Without a card the entry points of the linear rankers, Cleaver and
    MetaCleaver raise unless the caller asks for the CPU: nothing falls back
    to the plain versions on its own."""
    from quickrank_tpu_torch.learning import CoordinateAscent, LambdaMart, LineSearch, MetaCleaver
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.optimization import Cleaver

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    train, _, _ = _small_folds()
    lm = LambdaMart(ntrees=2, nleaves=4, nthresholds=16)
    lm.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    ca = CoordinateAscent(max_iterations=1)
    ca.update_weights(np.ones(train.num_features))
    calls = [lambda: CoordinateAscent(max_iterations=1).learn(train, verbose=False),
             lambda: LineSearch(max_iterations=1).learn(train, verbose=False),
             lambda: ca.score_dataset(train),
             lambda: Cleaver().optimize(lm, train, verbose=False),
             lambda: MetaCleaver(lm, Cleaver()).learn(train, verbose=False)]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert ca.score_dataset(train, device="cpu").shape == (train.num_docs,)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["CoordinateAscent", "LineSearch"])
def test_linear_rankers_on_card_match_cpu(cuda_device, name):
    """The first feature step on the card: the candidate grid bitwise the
    CPU's, the candidate metrics within 1e-5 (the candidate matrices are the
    same bits; the metric's sort and sums are the card's); a 2-epoch run
    within 1e-2 of the CPU run's train NDCG@10."""
    from quickrank_tpu_torch.learning import linear
    from quickrank_tpu_torch.metrics import Ndcg

    train, valid, _ = _small_folds()
    F = train.num_features
    steps = {}
    for dev in ("cuda", "cpu"):
        fold = linear.Fold(train, dev)
        if name == "CoordinateAscent":
            w = np.full(F, np.float32(1.0 / F), np.float32)
            _, pts, ms, _ = linear.CoordinateAscent().feature_step(
                fold, Ndcg(10), w, 0, np.float32(10.0 / F))
        else:
            w = np.ones(F, np.float32)
            trace = []
            best = np.float32(fold.metric(Ndcg(10), fold.dot(w)))
            linear.LineSearch().iteration(fold, Ndcg(10), w, w, best, np.float32(10.0),
                                          trace=trace)
            pts, ms = trace[0]
        steps[dev] = (pts, ms, fold.dot(w).cpu())
    (gp, gm, gfull), (cp, cm, cfull) = steps["cuda"], steps["cpu"]
    np.testing.assert_array_equal(gp, cp)
    assert torch.equal(gfull, cfull)
    fin = np.isfinite(cm)
    np.testing.assert_array_equal(np.isfinite(gm), fin)
    assert np.abs(gm[fin] - cm[fin]).max() <= 1e-5
    runs = [getattr(linear, name)(max_iterations=2).learn(train, valid, Ndcg(10), verbose=False,
                                                          device=dev)
            for dev in ("cuda", "cpu")]
    assert abs(runs[0]["train"][-1] - runs[1]["train"][-1]) <= 1e-2


@pytest.mark.gpu
def test_cleaver_on_card_goes_through_k1_partial(cuda_device):
    """Cleaver's per-tree score matrix on the card comes from K1's partial
    entry, bitwise the CPU descent, and QUALITY_LOSS prunes the CPU's set
    with the metric after pruning within 1e-5."""
    import copy

    from quickrank_tpu_torch.learning import LambdaMart
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.optimization import Cleaver

    train, valid, _ = _small_folds()
    lm = LambdaMart(ntrees=12, nleaves=16, nthresholds=64, seed=1)
    lm.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    before = kernel_qs.PARTIAL_LAUNCHES
    card = Cleaver.partial_dataset(lm, train, "cuda")
    assert kernel_qs.PARTIAL_LAUNCHES > before
    np.testing.assert_array_equal(card.features, Cleaver.partial_dataset(lm, train, "cpu").features)
    infos = []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(lm)
        infos.append(Cleaver("QUALITY_LOSS", 0.5).optimize(m, train, valid, Ndcg(10),
                                                          verbose=False, device=dev))
    assert infos[0]["pruned"] == infos[1]["pruned"]
    assert abs(infos[0]["metric_after"] - infos[1]["metric_after"]) <= 1e-5
