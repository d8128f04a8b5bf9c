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

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

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
                                     (300, 7, 12, 24), (300, 30, 4, 700),
                                     (300, 5, 13, 24), (300, 3, 14, 24),
                                     (1000, 320, 13, 24), (300, 4, 13, 700),
                                     (1000, 343, 4, 24), (999, 1001, 4, 136),
                                     (33, 2051, 1, 24), (5000, 1000, 4, 700)])
def test_oblivious_kernel_matches_plain_on_card(cuda_device, N, T, D, F):
    """K3 bitwise against its plain version: one doc, one past two blocks,
    one tree, depth 1, depth 8 (several tiles of trees), depth 12 (one tree
    a tile), rows too wide to stage in shared memory, with an all-dead tree
    where there is room for one; past depth 12, where the leaf tables are
    read from global memory: depths 13 and 14, two tiles of levels (320
    trees; a tile holds 315 at depth 13), and unstaged rows; and tree
    counts that end a model tile or a group of trees in flight mid-way (a
    depth-4 tile holds 341 records, a depth-1 tile 2,048)."""
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
@pytest.mark.parametrize("depth", [*range(1, 13), 14])
def test_oblivious_kernel_scores_bins_on_card(cuda_device, depth):
    """u8 bin ids at every depth the kernel takes as a template parameter,
    and past it; 999 docs end a block mid-way, 41 trees a group in flight."""
    ens = _oblivious(41, depth, 24, seed=3, dead_tree=2)
    bins = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(999, 24))).to(
        torch.uint8)
    got = kernel_oblivious.score_oblivious(bins.to(cuda_device), ens.to(cuda_device))
    assert torch.equal(got.cpu(), plain_oblivious.score_oblivious_binned(bins, ens))


@pytest.mark.gpu
@pytest.mark.parametrize("F", [24, 700])
@pytest.mark.parametrize("D", range(1, 14))
def test_oblivious_kernel_every_depth_on_card(cuda_device, D, F):
    """Every depth the kernel takes as a template parameter (1..12), and 13
    (the runtime-depth kernel), on staged rows (F = 24) and on rows read
    from global memory (F = 700): 1,001 docs and 11 trees end a block, a
    thread's docs and a group of trees in flight mid-way; one tree dead
    past ``num_trees`` and one with every level dead."""
    ens = _oblivious(11, D, F, seed=40 + D, dead_tree=3)
    ens.num_trees = 10
    X = torch.from_numpy(np.random.default_rng(D).standard_normal((1001, F), dtype=np.float32))
    design = kernel_oblivious.design(X.to(cuda_device), ens)
    assert design["depth_path"] == ("template" if D <= 12 else "runtime")
    assert design["rows"] == ("staged" if F == 24 else "global")
    got = kernel_oblivious.score_oblivious(X.to(cuda_device), ens.to(cuda_device))
    assert torch.equal(got.cpu(), plain_oblivious.score_oblivious(X, ens))


@pytest.mark.gpu
@pytest.mark.parametrize("F", [24, 700])
@pytest.mark.parametrize("D", [3, 7, 13])
def test_oblivious_kernel_nan_inf_and_equality_on_card(cuda_device, D, F):
    """NaN goes left, +inf right of every finite threshold, -inf left, and
    a value equal to its threshold left, on the card as in the plain
    version; the tables are written before the first launch packs them."""
    ens = _oblivious(9, D, F, seed=D, dead_tree=4)
    rng = np.random.default_rng(D + F)
    X = torch.from_numpy(rng.standard_normal((700, F), dtype=np.float32))
    cells = rng.integers(0, 700 * F, size=3 * 700)
    flat = X.view(-1)
    flat[cells[:700]] = float("nan")
    flat[cells[700:1400]] = float("inf")
    flat[cells[1400:]] = float("-inf")
    for t in range(9):
        for lvl in range(D):
            X[(t * D + lvl) % 700, int(ens.fid[t, lvl])] = ens.thr[t, lvl]
    X[600:610, :] = float("nan")
    X[610:620, :] = float("inf")
    got = kernel_oblivious.score_oblivious(X.to(cuda_device), ens.to(cuda_device))
    want = plain_oblivious.score_oblivious(X, ens)
    assert torch.equal(got.cpu(), want)
    idx = plain_oblivious.leaf_index(X, ens.fid, ens.thr)
    assert (idx[600:610] == 0).all()
    live = [t for t in range(9) if t != 4]
    assert (idx[610:620][:, live] == 2 ** D - 1).all()


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
    version.  "deep": depth 32, past the kernel's 32-bit leaf index (its
    2^32-leaf table a broadcast view, so nothing is allocated)."""
    ens = _oblivious(3, 2, 8, seed=1)
    ens = ens if bad == "cpu-model" else ens.to(cuda_device)
    if bad == "deep":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=cuda_device)
        ens = ObliviousEnsemble(fid=zeros(3, 32, dtype=torch.int32), thr=zeros(3, 32),
                                thr_bin=zeros(3, 32, dtype=torch.int32),
                                leaf=zeros(1, 1).expand(3, 2 ** 32), weight=zeros(3),
                                num_trees=3)
    X = torch.zeros((16, 8), device=cuda_device)
    X = {"contiguous": torch.zeros((8, 16), device=cuda_device).T, "dtype": X.double(),
         "int32-bins": X.int(), "cpu-model": X, "deep": X}[bad]
    before = kernel_oblivious.LAUNCHES
    with pytest.raises(ValueError, match="depth 32" if bad == "deep" else ""):
        kernel_oblivious.score_oblivious(X, ens)
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
    block's shared memory holds (32 bins more take the wide-bin path, with
    the same bits as the reference)."""
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
        assert kernel_histogram.past_shared_memory(1, num_bins + 32)
        tiled = kernel_histogram.node_histogram(*dev, num_bins + 32, n0, k)
        assert torch.equal(tiled, kernel_histogram.node_histogram_fixed(
            *dev, num_bins + 32, n0, k))
        assert torch.equal(tiled[:, :num_bins], got[:, :num_bins])


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


def test_new_learner_entry_points_need_a_card():
    """RankBoost, the sampling learners, RandomForest and CustomLTR raise
    without a card unless the caller asks for the CPU."""
    from quickrank_tpu_torch.learning import (
        CustomLTR,
        LambdaMartSelective,
        RandomForest,
        RankBoost,
        StochasticNegative,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    train, _, _ = _small_folds()
    rb = RankBoost(ntrees=2, nthresholds=16)
    rb.learn(train, verbose=False, device="cpu")
    calls = [lambda: RankBoost(ntrees=1).learn(train, verbose=False),
             lambda: rb.score_dataset(train),
             lambda: CustomLTR().score_dataset(train)]
    calls += [lambda cls=cls: cls(ntrees=1, nleaves=4).learn(train, verbose=False)
              for cls in (LambdaMartSelective, RandomForest, StochasticNegative)]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1e-7, 1.0])
def test_node_histogram_kernel_one_signed_channel_on_card(cuda_device, scale):
    """K4 as RankBoost calls it: one signed channel (potentials of magnitude
    ~1/S, summing to about 0), the docs of a mask, ``f_used`` below W.  Bit
    for bit its fixed-point reference; within the rounding bound of the
    scatter-add's float32 sums."""
    from quickrank_tpu_torch.ops.histogram import masked_histogram_scatter, masked_histogram_t

    binned, vt, _ = (torch.from_numpy(a) for a in _histogram_inputs(W=40))
    mask = vt[0] > 0
    pi = torch.where(mask, vt[1] - vt[1][mask].mean(), 0.0) * scale
    dev = [t.to(cuda_device) for t in (binned, pi, mask)]
    before = kernel_histogram.LAUNCHES["node_histogram"]
    got = masked_histogram_t(dev[0], dev[1][None].contiguous(), dev[2], 256, f_used=33)
    assert kernel_histogram.LAUNCHES["node_histogram"] == before + 1
    pos = torch.where(mask, 0, 1).to(torch.int32)
    fixed = kernel_histogram.node_histogram_fixed(binned, pi[None].contiguous(), pos, 256, 0, 1,
                                                  33)
    assert got.shape == (33, 256, 1) and torch.equal(got.cpu(), fixed)
    plain, mass, terms = (masked_histogram_scatter(binned[:, :33], v[:, None], mask, 256)
                          for v in (pi, pi.abs(), torch.ones_like(pi)))
    _assert_within_sum_tolerance(got, plain, mass, terms,
                                 kernel_histogram.rounding_error(pi[None]), slice(0, 0))


@pytest.mark.gpu
def test_rankboost_on_card_matches_cpu(cuda_device):
    """RankBoost on the card: K4 once a round and two host reads a round;
    the CPU run's first five weak rankers, its train NDCG@10 within 1e-3,
    and scores within 1e-12 relative of the CPU's numpy product."""
    from quickrank_tpu_torch.learning import RankBoost, rankboost
    from quickrank_tpu_torch.metrics import Ndcg

    train, valid, test = _small_folds()
    runs = {}
    for dev in ("cuda", "cpu"):
        before = kernel_histogram.LAUNCHES["node_histogram"]
        rankboost.HOST_SYNCS = 0
        rb = RankBoost(ntrees=8, nthresholds=64)
        runs[dev] = (rb, rb.learn(train, valid, Ndcg(10), verbose=False, device=dev))
        assert rankboost.HOST_SYNCS == 16
        launched = kernel_histogram.LAUNCHES["node_histogram"] - before
        assert launched == (8 if dev == "cuda" else 0)
    (card, hk), (cpu, hc) = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(card.features_[:5], cpu.features_[:5])
    np.testing.assert_array_equal(card.thetas_[:5], cpu.thetas_[:5])
    assert abs(hk["train"][-1] - hc["train"][-1]) <= 1e-3
    got, want = card.score_dataset(test, device="cuda"), card.score_dataset(test, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.gpu
def test_samplers_on_card_match_cpu(cuda_device):
    """The presence samplers on CUDA tensors give the CPU's masks from the
    same generator state (the keys are drawn on the host), for every
    Selective strategy with and without random extras and for
    Stochastic-Negative."""
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.learning.selective import select_presence
    from quickrank_tpu_torch.learning.stochasticnegative import sample_presence

    train, _, _ = _small_folds()
    tds = {dev: TrainData.build(train, 64, device=dev) for dev in ("cuda", "cpu")}
    N = tds["cpu"].padded.num_docs_padded
    s = torch.from_numpy(np.random.default_rng(0).standard_normal(N).astype(np.float32))
    for strategy in ("RATIO", "MUL", "POS"):
        for rd in (0.0, 0.5):
            got, want = (select_presence(s.to(dev), tds[dev].step, N, strategy, 0.4, rd,
                                         torch.Generator().manual_seed(3))
                         for dev in ("cuda", "cpu"))
            assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    got, want = (sample_presence(tds[dev].step, N, 0.3, torch.Generator().manual_seed(4))
                 for dev in ("cuda", "cpu"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["LambdaMartSelective", "RandomForest", "StochasticNegative"])
def test_new_tree_learners_on_card_go_through_kernels(cuda_device, name):
    """The tree learners of this slice train on the card through K4 and
    K5, and the scores they carried are the model's kernel scores (within
    the perfect-tree path's float32 sum against the Kahan carry)."""
    from quickrank_tpu_torch import learning
    from quickrank_tpu_torch.metrics import Ndcg

    train, valid, _ = _small_folds()
    kw = dict(ntrees=3, nleaves=16, nthresholds=64, seed=1)
    kw.update({"LambdaMartSelective": dict(sampling_iterations=1, rank_sampling_factor=0.5,
                                           random_sampling_factor=0.25),
               "RandomForest": dict(subsample=0.6, max_features=0.5),
               "StochasticNegative": dict(subsample=0.3)}[name])
    before = dict(kernel_histogram.LAUNCHES)
    m = getattr(learning, name)(**kw)
    h = m.learn(train, None, Ndcg(10), verbose=False, device="cuda")
    assert all(kernel_histogram.LAUNCHES[k] > before[k] for k in before)
    assert np.isfinite(h["train"]).all()
    carried = m.train_scores[: train.num_docs].cpu().numpy()
    np.testing.assert_allclose(m.score_dataset(train, device="cuda"), carried, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(carried).max())))


def _u16(ids: torch.Tensor) -> torch.Tensor:
    """int32 ids below 65,536 as the u16 wire."""
    return ids.to(torch.int16).view(torch.uint16)


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins", [1024, 4096, 16384])
@pytest.mark.parametrize("k", [1, 4])
def test_histogram_kernels_on_the_u16_wire(cuda_device, num_bins, k):
    """K4 and K5 on u16 bin ids at 1,024 and 4,096 bins and past one block's
    shared memory (16,384 bins at C = 3: the wide-bin path), bit for bit their
    fixed-point reference; ids past num_bins are dropped."""
    g = torch.Generator(device="cpu").manual_seed(num_bins + k)
    N, W = 3001, 40
    ids = torch.randint(0, num_bins + 8, (N, W), generator=g, dtype=torch.int32)
    vt = torch.randn((3, N), generator=g)
    vt[0] = (vt[0] > -1).float()
    pos = torch.randint(0, k + 1, (N,), generator=g, dtype=torch.int32)
    binned, vt, pos = _u16(ids).to(cuda_device), vt.to(cuda_device), pos.to(cuda_device)
    assert kernel_histogram.past_shared_memory(3, num_bins) == (num_bins == 16384)
    got = kernel_histogram.node_histogram(binned, vt, pos, num_bins, 0, k)
    assert torch.equal(got, kernel_histogram.node_histogram_fixed(binned, vt, pos, num_bins,
                                                                  0, k))
    vals = vt[1:].T.contiguous()
    k5 = kernel_histogram.histogram(binned, vals, num_bins)
    assert torch.equal(k5, kernel_histogram.node_histogram_fixed(
        binned, vals.T.contiguous(), None, num_bins, 0, 1))
    assert bool(got[..., 0].sum() > 0)


def _wide_inputs(num_bins, C, k, seed, N=3 * 4096 + 37, W=7):
    """int32 ids in [0, num_bins + 8) (the last 8 dropped), C channel-major
    values (channel 0 a 0/1 count), node ids in [0, k] (slot k in no pass)
    for N docs, no multiple of a batch of a CTA's threads."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ids = torch.randint(0, num_bins + 8, (N, W), generator=g, dtype=torch.int32)
    vt = torch.randn((C, N), generator=g)
    vt[0] = (vt[0] > -1).float()
    pos = torch.randint(0, k + 1, (N,), generator=g, dtype=torch.int32)
    return ids, vt, pos


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins", [1024, 4096, 16384, 65536])
@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 4])
def test_wide_path_equals_fixed_reference(cuda_device, num_bins, C, k):
    """K4 and K5 at 1,024 to 65,536 bins, on the path each launch takes (the
    wide-bin path, ``csrc/histogram_wide.cu``, where ``past_shared_memory``:
    C = 2 and 3 from 16,384 bins, C = 1 at 65,536), bit for bit
    ``node_histogram_fixed_int``, on u16 ids and on the same ids as int32
    (ids past num_bins dropped), N no multiple of a batch; the wide-bin
    launches counted exactly there."""
    ids, vt, pos = (t.to(cuda_device) for t in _wide_inputs(num_bins, C, k, num_bins + C + k))
    N = ids.shape[0]
    bits = kernel_histogram.channel_max_bits(vt)
    before = dict(kernel_histogram.WIDE_LAUNCHES)
    for wire in (_u16(ids.clamp(max=65535)), ids):
        want = kernel_histogram.node_histogram_fixed_int(wire, vt, pos, num_bins, 0, k, bits, N)
        want5 = kernel_histogram.node_histogram_fixed_int(wire, vt, None, num_bins, 0, 1, bits, N)
        got = kernel_histogram.node_histogram_int(wire, vt, pos, num_bins, 0, k, bits, N)
        assert torch.equal(got, want)
        got5 = kernel_histogram.histogram_int(wire, vt.T.contiguous(), num_bins, bits, N)
        assert torch.equal(got5, want5)
        assert bool((want[..., 0] > 0).any())
    wide = 2 if kernel_histogram.past_shared_memory(C, num_bins) else 0
    assert wide == (2 if num_bins == 65536 or (num_bins == 16384 and C > 1) else 0)
    assert kernel_histogram.WIDE_LAUNCHES == {
        "node_histogram": before["node_histogram"] + wide, "histogram": before["histogram"] + wide}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one bin", "one bin of the last tile", "n0 > 0, f_used",
                                  "block path, same bits", "no docs", "switch point"])
def test_wide_path_edges_on_card(cuda_device, case):
    """The wide-bin path at its edges, bit for bit its reference: every doc
    in one bin (the worst case for same-address atomics) in the first and in
    the last tile of 16,384 bins, node slots from n0 > 0 with f_used < W,
    the block path's bits at 2,048 bins, an empty matrix; and the switch
    point at C = 3, 9,632 bins on the block path and 9,633 on the wide-bin
    path, each launch counted on its path."""
    num_bins, C, k, n0, f_used = 16384, 3, 1, 0, 0
    ids, vt, pos = _wide_inputs(num_bins, C, k, seed=7, N=20011, W=40)
    if case == "one bin":
        ids[:] = 3
    elif case == "one bin of the last tile":
        ids[:] = num_bins - 2
    elif case == "n0 > 0, f_used":
        k, n0, f_used = 3, 2, ids.shape[1] - 2
        pos = torch.randint(0, 6, pos.shape, dtype=torch.int32)
    elif case == "block path, same bits":
        num_bins = 2048
        ids = ids % 2052
    elif case == "no docs":
        ids, vt, pos = ids[:0], vt[:, :0].contiguous(), pos[:0]
    ids, vt, pos = ids.to(cuda_device), vt.to(cuda_device), pos.to(cuda_device)
    N = max(ids.shape[0], 1)
    bits = kernel_histogram.channel_max_bits(vt)
    sizes = (9632, 9633) if case == "switch point" else (num_bins,)
    for num_bins in sizes:
        wire = _u16(ids % (num_bins + 4))
        want = kernel_histogram.node_histogram_fixed_int(wire, vt, pos, num_bins, n0, k, bits,
                                                         N, f_used)
        before = kernel_histogram.WIDE_LAUNCHES["node_histogram"]
        got = kernel_histogram.node_histogram_int(wire, vt, pos, num_bins, n0, k, bits, N,
                                                  f_used)
        assert torch.equal(got, want), num_bins
        wide = kernel_histogram.WIDE_LAUNCHES["node_histogram"] - before
        assert wide == (0 if num_bins in (2048, 9632) else 1), num_bins
    if case.startswith("one bin"):
        b = int(ids[0, 0])
        assert bool(want[:, b].any()) and not bool(want[:, :b].any()) and not bool(
            want[:, b + 1:].any())
    if case == "no docs":
        assert not want.any()


@pytest.mark.gpu
@pytest.mark.parametrize("C", range(1, 9))
def test_wide_path_switch_point_matches_the_c_plan(cuda_device, C):
    """The launch's own choice of path (``histogram_takes_wide_path``, which
    the launch counts follow) against the Python mirror
    ``past_shared_memory`` on either side of its switch point, and at the
    bin counts the wide-bin shapes use."""
    lib = _cuda.library()
    first = next(b for b in range(257, 1 << 17) if kernel_histogram.past_shared_memory(C, b))
    for b in (256, first - 1, first, 16384, 65536):
        assert bool(lib.histogram_takes_wide_path(C, b)) == kernel_histogram.past_shared_memory(
            C, b), b
    assert not lib.histogram_takes_wide_path(C, first - 1) and lib.histogram_takes_wide_path(
        C, first)


@pytest.mark.gpu
def test_u8_u16_and_int32_wires_give_the_same_sums(cuda_device):
    """The same ids on a u8, a u16 and an int32 wire: one int64 sum under
    one scale, and the same float histograms."""
    binned, vt, pos = (torch.from_numpy(a).to(cuda_device) for a in _histogram_inputs())
    ids = binned.to(torch.int32)
    bits = kernel_histogram.channel_max_bits(vt)
    sums = [kernel_histogram.node_histogram_int(w, vt, pos, 256, 0, 16, bits, ids.shape[0])
            for w in (binned, _u16(ids), ids)]
    assert torch.equal(sums[0], sums[1]) and torch.equal(sums[0], sums[2])
    assert torch.equal(kernel_histogram.node_histogram(_u16(ids), vt, pos, 256, 0, 16),
                       kernel_histogram.node_histogram(binned, vt, pos, 256, 0, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 129, 5000])
def test_qs_kernel_u16_entries_on_card(cuda_device, N):
    """K1's u16 bin-space entries (scores and per-tree columns) bit for bit
    their plain versions, on ids up to 65,535 against bin thresholds."""
    ens = random_bestfirst_ensemble(40, 16, 24, seed=N)
    ens.threshold_bin[:] = torch.from_numpy(np.random.default_rng(N).integers(
        0, 65535, size=tuple(ens.threshold_bin.shape)).astype(np.int32))
    tables = ensemble_to_qs(ens, space="bin").to(cuda_device)
    ids = torch.from_numpy(np.random.default_rng(N + 1).integers(
        0, 65536, size=(N, 24)).astype(np.int32))
    x = ids.to(torch.int16).view(torch.uint16).to(cuda_device)
    before = (kernel_qs.LAUNCHES, kernel_qs.PARTIAL_LAUNCHES)
    got = kernel_qs.score_qs(x, tables)
    cols = kernel_qs.partial_scores_qs(x, tables)
    torch.cuda.synchronize()
    assert (kernel_qs.LAUNCHES, kernel_qs.PARTIAL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, score_qs(x, tables))
    assert torch.equal(cols, qs_partial_plain(x, tables))
    assert torch.equal(got.cpu(), score_qs(ids.float(), tables.to("cpu")))


@pytest.mark.gpu
def test_best_first_at_1023_thresholds_on_card(cuda_device):
    """A 2-tree best@1023 run on the card: the bin matrix is the u16 wire,
    K4 and K5 launch, and the run tracks the CPU's (same root split, train
    NDCG@10 within 1e-3)."""
    from quickrank_tpu_torch.data.synthetic import make_train_valid_test
    from quickrank_tpu_torch.learning import LambdaMart
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.metrics import Ndcg

    train, valid, _ = make_train_valid_test(num_queries=(40, 10, 10))
    assert TrainData.build(train, 1023).step.binned.dtype == torch.uint16
    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    card = LambdaMart(ntrees=2, nleaves=16, nthresholds=1023, seed=1)
    ch = card.learn(train, valid, Ndcg(10), verbose=False)
    assert all(v > 0 for v in kernel_histogram.LAUNCHES.values())
    cpu = LambdaMart(ntrees=2, nleaves=16, nthresholds=1023, seed=1)
    hh = cpu.learn(train, valid, Ndcg(10), verbose=False, device="cpu")
    assert [int(m.ensemble.feature[0, 0]) for m in (card, cpu)] == [
        int(cpu.ensemble.feature[0, 0])] * 2
    assert int(card.ensemble.threshold_bin[0, 0]) == int(cpu.ensemble.threshold_bin[0, 0])
    np.testing.assert_allclose(ch["train"], hh["train"], atol=1e-3)
