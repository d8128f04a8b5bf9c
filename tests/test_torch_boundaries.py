"""Boundaries of the port: it imports nothing of JAX or of the JAX package,
a CUDA tensor reaches a kernel or an exception (never the plain version),
and the kernels agree with their plain versions on the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.ops import _cuda, kernel_perfect, kernel_qs
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
