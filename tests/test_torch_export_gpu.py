"""The exported scorer (quickrank_tpu_torch/io/export.py) on the card: the
archive loaded with ``device=None`` scores as the QuickScorer kernel does,
bit for bit, and a linear or RankBoost archive as it does on the CPU.  These
need a CUDA device and skip without one; the file imports no JAX, so it runs
on the card with ``--noconftest``."""

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.io import export
from quickrank_tpu_torch.learning import CoordinateAscent, LambdaMart, RankBoost
from quickrank_tpu_torch.ops import kernel_qs
from quickrank_tpu_torch.trees.qs import ensemble_to_qs
from quickrank_tpu_torch.trees.random_ensemble import random_bestfirst_ensemble

F = 24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(n=1000):
    return np.random.default_rng(0).standard_normal((n, F), dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("leaves", [16, 64])
def test_archive_on_card_is_k1_bit_for_bit(cuda_device, leaves):
    ens = random_bestfirst_ensemble(30, leaves, F, seed=leaves)
    lm = LambdaMart(ntrees=30, nleaves=leaves)
    lm.ensemble = ens
    scorer = export.load_scorer(export.export_scorer(lm, num_features=F))  # the card
    X = torch.from_numpy(_rows()).to(cuda_device)
    want = kernel_qs.score_qs(X, ensemble_to_qs(ens).to(cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(scorer(X).view(np.int32), want.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["linear", "rankboost"])
def test_archive_on_card_is_the_cpu_archive(cuda_device, kind):
    rng = np.random.default_rng(3)
    if kind == "linear":
        model = CoordinateAscent()
        model.best_weights = rng.standard_normal(F)
    else:
        model = RankBoost()
        model.features_ = rng.integers(0, F, 40).astype(np.int32)
        model.thetas_ = rng.standard_normal(40).astype(np.float32)
        model.signs_ = rng.choice([-1, 1], 40).astype(np.int32)
        model.alphas_ = rng.random(40).astype(np.float32)
    blob = export.export_scorer(model, num_features=F)
    X = _rows()
    np.testing.assert_array_equal(export.load_scorer(blob)(X).view(np.int32),
                                  export.load_scorer(blob, device="cpu")(X).view(np.int32))
