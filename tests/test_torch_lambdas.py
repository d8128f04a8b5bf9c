"""The port's lambda gradients (quickrank_tpu_torch/ops/lambdas.py and
LambdaMart._gradients) against the JAX package on the CPU: the banded
block (DCG/NDCG with 3 * cutoff <= D), the full block (other metrics or
short lists), query chunking, and sampled slot masks that leave holes in a
query.  Inputs are numpy arrays from fixed seeds, fed to both.

Tolerance: 1e-5 relative plus 1e-6 of the largest |value|.  sigmoid and
1/log2 differ from XLA's in the last bit on a share of pairs, and the
per-doc sums over up to D pairs carry that difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.metrics import metric_factory as jax_metric_factory
from quickrank_tpu.ops.lambdas import lambda_gradients as jax_lambda_gradients
from quickrank_tpu_torch.metrics import metric_factory
from quickrank_tpu_torch.ops.lambdas import lambda_gradients

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


def _views(seed, Q=13, D=40, sample=False):
    rng = np.random.default_rng(seed)
    nvalid = rng.integers(2, D + 1, size=Q).astype(np.int32)
    nvalid[0] = D
    mask = np.arange(D)[None, :] < nvalid[:, None]
    if sample:  # a sampled subset: holes inside the queries
        mask &= rng.uniform(size=(Q, D)) < 0.7
        nvalid = mask.sum(-1).astype(np.int32)
    labels = np.where(mask, rng.integers(0, 5, size=(Q, D)), 0).astype(np.float32)
    scores = (rng.normal(size=(Q, D)) * 2).astype(np.float32)
    scores[1] = 0.0  # iteration 0: every score tied
    scores = np.where(mask, np.round(scores * 4) / 4, 0).astype(np.float32)
    return scores, labels, mask, nvalid


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("name,D", [
    ("NDCG@10", 40),   # banded
    ("DCG@5", 40),     # banded, unnormalized
    ("NDCG@10", 24),   # full block: 3 * cut > D
    ("MAP@10", 24),
    ("TNDCG@10", 24),
])
@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("sample", [False, True])
def test_lambdas_match_jax(name, D, chunk, sample):
    arrays = _views(seed=D + len(name), D=D, sample=sample)
    lam_j, w_j = jax_lambda_gradients(
        *(jnp.asarray(a) for a in arrays), jax_metric_factory(name), chunk)
    lam, w = lambda_gradients(
        *(torch.from_numpy(a) for a in arrays), metric_factory(name), chunk)
    _close(lam.numpy(), np.asarray(lam_j))
    _close(w.numpy(), np.asarray(w_j))
    mask = arrays[2]
    assert not lam.numpy()[~mask].any() and not w.numpy()[~mask].any()


def test_chunking_changes_nothing():
    """A 3-query chunk (13 queries: a ragged last chunk) gives the lambdas
    of one block, to the last bit or two (torch's CPU sums may vectorize
    differently by batch size)."""
    arrays = [torch.from_numpy(a) for a in _views(seed=3)]
    m = metric_factory("NDCG@10")
    one = lambda_gradients(*arrays, m)
    chunked = lambda_gradients(*arrays, m, query_chunk=3)
    for a, b in zip(one, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def test_lambdamart_gradients_match_jax():
    """LambdaMart._gradients over the padded training layout, with a
    sampled doc mask (query cleaning, lambdamart.cc:85-108), against the
    JAX package's, in flat padded order."""
    from quickrank_tpu.data.synthetic import make_ranking_dataset as jax_make
    from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
    from quickrank_tpu.learning.mart import TrainData as JaxTrainData
    from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
    from quickrank_tpu_torch.data.dataset import Dataset
    from quickrank_tpu_torch.learning.lambdamart import LambdaMart
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.metrics.metrics import Ndcg

    jds = jax_make(num_queries=11, num_features=5, seed=6)
    ds = Dataset(jds.features, jds.labels, jds.query_offsets, jds.qids)
    jtr = JaxTrainData.build(jds, 31)
    tr = TrainData.build(ds, 31, device="cpu")
    N = tr.padded.num_docs_padded
    rng = np.random.default_rng(4)
    scores = rng.normal(size=N).astype(np.float32)
    sample = (rng.uniform(size=N) < 0.8) & tr.padded.doc_mask.numpy()

    jl = JaxLambdaMart()
    jl._train_metric = JaxNdcg(10)
    lam_j, w_j = jl._gradients(jtr.step, jnp.asarray(scores), jnp.asarray(sample), None)
    pl = LambdaMart()
    pl._train_metric = Ndcg(10)
    lam, w = pl._gradients(tr.step, torch.from_numpy(scores), torch.from_numpy(sample))
    _close(lam.numpy(), np.asarray(lam_j))
    _close(w.numpy(), np.asarray(w_j))
