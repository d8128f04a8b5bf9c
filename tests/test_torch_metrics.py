"""The port's metrics (quickrank_tpu_torch/metrics) against the JAX package
and against a brute-force swap oracle, on the CPU.  Inputs are numpy arrays
from fixed seeds, with tied scores, fed to both packages.

Tolerances: per-query values and delta matrices agree to 1e-6 absolute
plus 1e-6 relative (discounts 1/log2(r+2) and the sums over ranks differ
from XLA's in the last bit; DCG and RMSE sums reach ~200); the closed-form deltas equal the swap oracle to 2e-5, the JAX
package's own bound for that check."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data.dataset import pack_doc_values as jax_pack
from quickrank_tpu.data.dataset import shard_and_pad as jax_shard_and_pad
from quickrank_tpu.metrics import metric_factory as jax_metric_factory
from quickrank_tpu.data.synthetic import make_ranking_dataset as jax_make
from quickrank_tpu_torch.data.dataset import Dataset, pack_doc_values, shard_and_pad
from quickrank_tpu_torch.metrics import core, metric_factory
from quickrank_tpu_torch.metrics.metrics import Dcg, Map, Ndcg, Rmse, Tndcg

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

NAMES = ["DCG@10", "NDCG@10", "NDCG@3", "NDCG", "TNDCG@10", "MAP@10", "MAP", "RMSE"]
ATOL = 1e-6
RTOL = 1e-6


def _views(seed=0, Q=9, D=24, ties=True):
    """Padded [Q, D] scores/labels/mask/nvalid with ragged lengths, graded
    labels and (when ``ties``) scores rounded so that many tie."""
    rng = np.random.default_rng(seed)
    nvalid = rng.integers(1, D + 1, size=Q).astype(np.int32)
    nvalid[0] = D
    mask = np.arange(D)[None, :] < nvalid[:, None]
    labels = np.where(mask, rng.integers(0, 5, size=(Q, D)), 0).astype(np.float32)
    labels[1] = 0.0  # a query with no relevant doc (IDCG == 0)
    scores = rng.normal(size=(Q, D)).astype(np.float32)
    if ties:
        scores = np.round(scores * 2) / 2
    scores = np.where(mask, scores, 0).astype(np.float32)
    return scores, labels, mask, nvalid


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ties", [True, False])
def test_per_query_matches_jax(name, ties):
    j_args, t_args = _both(*_views(seed=len(name), ties=ties))
    want = np.asarray(jax_metric_factory(name).evaluate_per_query(*j_args))
    got = metric_factory(name).evaluate_per_query(*t_args).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_all_zero_scores_rank_in_slot_order():
    """Iteration 0 scores every doc 0: the stable sort must keep slot order,
    and -0.0 ties with +0.0 as in JAX's sort."""
    scores, labels, mask, nvalid = _views(seed=3)
    scores[:] = 0.0
    scores[2, :5] = -0.0
    j_args, t_args = _both(scores, labels, mask, nvalid)
    from quickrank_tpu.metrics import core as jax_core

    want = np.asarray(jax_core.sort_by_score(j_args[0], j_args[2])[0])
    got = core.sort_by_score(t_args[0], t_args[2])[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.arange(scores.shape[1]))


@pytest.mark.parametrize("name", ["NDCG@10", "MAP@10", "RMSE", "TNDCG@5"])
def test_evaluate_dataset_matches_jax(name):
    """Dataset-level value (aggregate + finalize over the padded layout)."""
    jds = jax_make(num_queries=17, num_features=6, seed=4)
    ds = Dataset(jds.features, jds.labels, jds.query_offsets, jds.qids)
    s = np.random.default_rng(2).normal(size=ds.num_docs).astype(np.float32)
    jp = jax_shard_and_pad(jds)
    want = jax_metric_factory(name).evaluate_dataset(jp, jax_pack(jp, s))
    p = shard_and_pad(ds)
    got = metric_factory(name).evaluate_dataset(p, pack_doc_values(p, torch.from_numpy(s)))
    assert got == pytest.approx(want, abs=ATOL, rel=RTOL)


def _sorted_inputs(seed=5):
    scores, labels, mask, nvalid = _views(seed=seed, ties=True)
    t = torch.from_numpy
    order, sm, ss, sl = core.sort_by_score(t(scores), t(mask), t(scores), t(labels))
    sl = torch.where(sm, sl, 0.0)
    return ss, sl, sm, t(nvalid)


@pytest.mark.parametrize("metric", [Dcg(10), Ndcg(10), Ndcg(3), Tndcg(10), Map(10), Rmse()],
                         ids=repr)
def test_delta_matrix_matches_jax(metric):
    ss, sl, sm, nv = _sorted_inputs()
    want = np.asarray(jax_metric_factory(repr(metric)).delta_matrix(
        *(jnp.asarray(x.numpy()) for x in (ss, sl, sm, nv))))
    got = metric.delta_matrix(ss, sl, sm, nv).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _swap_oracle(metric, sl, sm, nv):
    """delta[q, i, j] = metric(ranks i and j swapped) - metric(ranks as
    they are), by re-evaluating the port's own metric on rank-ordered
    labels (strictly decreasing scores keep rank = slot)."""
    Q, D = sl.shape
    desc = torch.arange(D, 0, -1, dtype=torch.float32).expand(Q, D)
    base = metric.evaluate_per_query(desc, sl, sm, nv)
    out = torch.zeros(Q, D, D)
    for i in range(D):
        for j in range(D):
            sw = sl.clone()
            sw[:, i], sw[:, j] = sl[:, j], sl[:, i]
            out[:, i, j] = metric.evaluate_per_query(desc, sw, sm, nv) - base
    pair = sm[:, :, None] & sm[:, None, :]
    return torch.where(pair, out, 0.0)


@pytest.mark.parametrize("metric", [Dcg(3), Ndcg(10), Ndcg(1 << 30), Map(1 << 30)],
                         ids=repr)
def test_delta_matrix_matches_swap_oracle(metric):
    _, sl, sm, nv = _sorted_inputs(seed=8)
    brute = _swap_oracle(metric, sl, sm, nv)
    fast = metric.delta_matrix(None, sl, sm, nv)
    # the closed forms are symmetric with the upper triangle's sign
    upper = torch.triu(torch.ones_like(fast[0]), diagonal=1).bool()
    np.testing.assert_allclose(fast[:, upper].numpy(), brute[:, upper].numpy(), atol=2e-5)


def test_factory():
    assert repr(metric_factory("ndcg@10")) == "NDCG@10"
    assert isinstance(metric_factory("MAP", 5), Map) and metric_factory("MAP", 5).cutoff == 5
    assert repr(metric_factory("rmse")) == "RMSE"
    with pytest.raises(ValueError, match="unknown metric"):
        metric_factory("P@10")
