"""Boundaries of the port: it imports nothing of JAX or of the JAX package,
a CUDA tensor reaches a kernel or an exception (never the plain version),
and the kernels agree with their plain versions on the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.ops import _cuda, kernel_histogram, kernel_perfect, kernel_qs
from quickrank_tpu_torch.trees.perfect import ensemble_to_perfect, score_perfect
from quickrank_tpu_torch.trees.qs import ensemble_to_qs, score_qs
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
@pytest.mark.parametrize("depth", [1, 4, 5])
def test_perfect_kernel_matches_plain_on_card(cuda_device, depth):
    ens = random_balanced_ensemble(30, depth, 24, seed=depth)
    pe = ensemble_to_perfect(ens).to(cuda_device)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1000, 24), dtype=np.float32)).to(cuda_device)
    before = kernel_perfect.LAUNCHES
    got = kernel_perfect.score_perfect(X, pe)
    torch.cuda.synchronize()
    assert kernel_perfect.LAUNCHES == before + 1
    assert torch.equal(got, score_perfect(X, pe))


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
@pytest.mark.parametrize("num_bins,n0,k", [(256, 0, 1), (64, 0, 1), (256, 3, 10), (64, 2, 4)])
def test_node_histogram_kernel_matches_plain_on_card(cuda_device, num_bins, n0, k):
    """K4 against its plain version, and bitwise equal to itself across
    launches (integer sums in any order)."""
    binned, vt, pos = (torch.from_numpy(a) for a in _histogram_inputs(num_bins=num_bins))
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
                                 slice(0, None, 3))


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


@pytest.mark.gpu
@pytest.mark.parametrize("growth", ["best", "level"])
def test_training_on_card_goes_through_kernels(cuda_device, growth):
    """A short LambdaMART run on the card launches K4 (and K5 for
    best-first), and tracks the same run on the CPU."""
    from quickrank_tpu_torch.data.synthetic import make_train_valid_test
    from quickrank_tpu_torch.learning import LambdaMart
    from quickrank_tpu_torch.metrics import Ndcg

    train, valid, _ = make_train_valid_test(num_queries=(40, 10, 10))
    kw = dict(ntrees=3, nleaves=16, growth=growth, max_depth=4 if growth == "level" else 0)
    for name in kernel_histogram.LAUNCHES:
        kernel_histogram.LAUNCHES[name] = 0
    card = LambdaMart(**kw).learn(train, valid, Ndcg(10), verbose=False, device="cuda")
    assert kernel_histogram.LAUNCHES["node_histogram"] > 0
    assert (kernel_histogram.LAUNCHES["histogram"] > 0) == (growth == "best")
    cpu = LambdaMart(**kw).learn(train, valid, Ndcg(10), verbose=False, device="cpu")
    np.testing.assert_allclose(card["train"], cpu["train"], atol=1e-3)
