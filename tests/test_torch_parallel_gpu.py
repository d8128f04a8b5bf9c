"""The histogram kernels under a given scale, as query sharding calls them
(``ops/kernel_histogram.py``: ``node_histogram_int``, ``histogram_int``,
``to_float``): their plain version on the CPU, and on the card (``gpu``: ``chip_smoke.py`` phase 31 and phase
32's best-first case at a small size, phase 38's RankBoost and phase 46's 2-D mesh too); the per-query sum kernel
(``ops/kernel_query_sum.py``) against its plain version, and a query's
lambdas in two batches.  No JAX here, so the ``gpu`` tests run
on a host without it: ``python -m pytest tests/test_torch_parallel_gpu.py -m gpu
--noconftest``."""

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.ops import kernel_histogram as kh
from quickrank_tpu_torch.parallel.launch import run_ranks
from quickrank_tpu_torch.parallel.workers import batch_rank, save_dataset

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

#: seconds a launch of this module may take
DEADLINE = 300.0


@pytest.mark.parametrize("k,channels", [(1, 3), (4, 2)])
def test_fixed_point_shards_sum_to_the_whole(k, channels):
    """The plain version of the int64 sums: under one scale (the max bits of all
    the docs and their real count), the int64 accumulators of disjoint
    shards add up to the accumulator of all the docs bit for bit, and its
    conversion is ``node_histogram_fixed`` whenever the scale is the
    launch's own."""
    rng = np.random.default_rng(k)
    N, W, B = 3000, 6, 17
    binned = torch.from_numpy(rng.integers(0, B, (N, W)).astype(np.uint8))
    values = torch.from_numpy(rng.standard_normal((channels, N)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, k + 1, N).astype(np.int32))
    bits = torch.maximum(kh.channel_max_bits(values[:, :1000]),
                         kh.channel_max_bits(values[:, 1000:]))
    whole = kh.node_histogram_int(binned, values, pos, B, 0, k, bits, N)
    parts = sum(kh.node_histogram_int(binned[sl].contiguous(), values[:, sl].contiguous(),
                                      pos[sl].contiguous(), B, 0, k, bits, N)
                for sl in (slice(0, 1000), slice(1000, N)))
    assert torch.equal(parts, whole)  # exact: integer sums
    assert torch.equal(kh.to_float(parts, bits, N),
                       kh.node_histogram_fixed(binned, values, pos, B, 0, k))
    # K5's entry on doc-major values: the same sums with every doc in node 0
    k5 = kh.histogram_int(binned, values.T.contiguous(), B, bits, N)
    assert torch.equal(k5, kh.node_histogram_int(binned, values, torch.zeros_like(pos),
                                                 B, 0, 1, bits, N))


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,channels", [(1, 3), (16, 2)])
def test_group_entry_on_card_is_its_plain_version(k, channels):
    """``chip_smoke.py`` phase 31 at a small size: the int64 entry (K4 and
    K5) with given bits is bitwise ``node_histogram_fixed_int``; two halves'
    accumulators added as int64 and converted equal one launch over all the
    docs with the same bits (bitwise), and the conversion launch equals
    ``fixed_to_float``."""
    dev = _card()
    rng = np.random.default_rng(k)
    N, W, B = 50_000, 40, 256
    binned = torch.from_numpy(rng.integers(0, B, (N, W)).astype(np.uint8)).to(dev)
    values = torch.from_numpy(rng.standard_normal((channels, N)).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.integers(0, k + 1, N).astype(np.int32)).to(dev)
    bits = kh.channel_max_bits(values)
    whole = kh.node_histogram_int(binned, values, pos, B, 0, k, bits, N)
    assert torch.equal(whole, kh.node_histogram_fixed_int(binned, values, pos, B, 0, k,
                                                          bits, N))
    h = N // 2
    halves = [kh.node_histogram_int(binned[sl].contiguous(), values[:, sl].contiguous(),
                                    pos[sl].contiguous(), B, 0, k, bits, N)
              for sl in (slice(0, h), slice(h, N))]
    assert torch.equal(halves[0] + halves[1], whole)
    assert torch.equal(kh.to_float(whole, bits, N), kh.fixed_to_float(whole, bits, N))
    assert torch.equal(kh.to_float(whole, bits, N),
                       kh.node_histogram(binned, values, pos, B, 0, k))
    vals = values.T.contiguous()
    slots = pos[:, None].contiguous()
    k5 = kh.histogram_int(slots, vals, k + 1, bits, N)
    assert torch.equal(k5, kh.node_histogram_fixed_int(slots, values, None, k + 1, 0, 1,
                                                       bits, N))


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_equal_one_rank(tmp_path):
    """``chip_smoke.py`` phase 32's best-first case at 400 queries: two gloo
    ranks sharing the card grow the one-rank group's trees node for node,
    leaf values bit for bit, and the same train NDCG@10 bit for bit (the
    metric's per-query values are gathered in global order)."""
    _card()
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset

    train = save_dataset(make_ranking_dataset(num_queries=400, seed=3),
                         str(tmp_path / "train.npz"))
    spec = dict(learner="LambdaMart", kwargs=dict(ntrees=4, nleaves=16, seed=1),
                train=train)
    runs = {n: run_ranks(batch_rank, n, args=([("train_rank", spec)],), device="cuda",
                         backend="gloo", deadline=DEADLINE) for n in (1, 2)}
    one, two = runs[1][0][0], runs[2][0][0]
    for k, v in one["trees"].items():
        assert np.array_equal(v, two["trees"][k]), k
    assert two["history"]["train"] == one["history"]["train"]


@pytest.mark.gpu
def test_feature_mesh_on_one_card_equals_the_unsharded_run(tmp_path):
    """``chip_smoke.py`` phase 46's best-first case at 400 queries: a 1 x 2
    and a 2 x 2 gloo mesh sharing the card (one launch of four ranks, the
    1 x 2 mesh run by each query block's pair) grow the unsharded run's
    trees node for node, leaf values bit for bit, with its train NDCG@10,
    on every rank (K4 on each rank's feature block)."""
    dev = _card()
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import LambdaMart
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.parallel.workers import ensemble_arrays

    ds = make_ranking_dataset(num_queries=400, seed=3)
    train = save_dataset(ds, str(tmp_path / "train.npz"))
    kw = dict(ntrees=4, nleaves=16, seed=1)
    one = LambdaMart(**kw)
    hist = one.learn(ds, None, Ndcg(10), verbose=False, device=dev)
    want = ensemble_arrays(one)
    jobs = [("train_rank", dict(learner="LambdaMart", kwargs=kw, train=train, mesh=shape))
            for shape in ((1, 2), (2, 2))]
    out = run_ranks(batch_rank, 2, args=(jobs,), device="cuda", backend="gloo",
                    deadline=DEADLINE, num_feat_shards=2)
    for r in out:
        for run in r:
            for k, v in want.items():
                assert np.asarray(v).tobytes() == np.asarray(run["trees"][k]).tobytes(), k
            assert run["history"]["train"] == hist["train"]
            assert run["launches"]["node_histogram"] > 0


@pytest.mark.gpu
def test_rankboost_two_gloo_ranks_on_one_card_equal_one_rank(tmp_path):
    """``chip_smoke.py`` phase 38 at 400 queries: RankBoost in two gloo
    ranks sharing the card picks the one-rank group's weak rankers, and the
    same alphas and train NDCG@10, bit for bit (S is a gathered sum of
    fixed-order per-query sums, the potential histogram K4's int64 sums
    under one scale a round)."""
    _card()
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset

    train = save_dataset(make_ranking_dataset(num_queries=400, seed=3),
                         str(tmp_path / "train.npz"))
    spec = dict(learner="RankBoost", kwargs=dict(ntrees=10), train=train)
    runs = {n: run_ranks(batch_rank, n, args=([("train_rank", spec)],), device="cuda",
                         backend="gloo", deadline=DEADLINE) for n in (1, 2)}
    one = runs[1][0][0]
    for two in (r[0] for r in runs[2]):
        for k, v in one["trees"].items():
            assert np.asarray(v).tobytes() == np.asarray(two["trees"][k]).tobytes(), k
        assert two["history"]["train"] == one["history"]["train"]


@pytest.mark.gpu
def test_query_sum_kernel_is_its_plain_version():
    """The fixed-order query sum (``csrc/query_sum.cu``) equals its plain
    halving bit for bit, signed zeros included, over the last axis and the
    one before it, at every axis length from 1 to 300 and at lengths that
    fold in registers (over 4,096)."""
    from quickrank_tpu_torch.ops import kernel_query_sum as kq

    dev = _card()
    rng = np.random.default_rng(0)
    shapes = [((7, n), -1) for n in range(1, 301)] + [
        ((5, 10, 231), -1), ((5, 10, 231), -2), ((3, 5000), -1), ((2, 65536), -1)]
    for shape, dim in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        x[..., ::5] = -0.0
        x = torch.from_numpy(x).to(dev)
        got, want = kq.query_sum(x, dim), kq.pairwise_sum(x, dim)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (shape, dim)


@pytest.mark.gpu
def test_query_lambdas_equal_across_batch_compositions():
    """A query's lambda gradients and weights are the same bits whichever
    queries share its batch (all 300 in one call, or the last 100 alone
    with another chunk size): the pair sums go through the fixed-order
    query sum."""
    from quickrank_tpu_torch.data.dataset import gather_padded, shard_and_pad
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.metrics import Ndcg
    from quickrank_tpu_torch.ops.lambdas import lambda_gradients

    dev = _card()
    ds = make_ranking_dataset(num_queries=300, seed=4)
    padded = shard_and_pad(ds)
    sm = padded.slot_mask.to(dev)
    scores = torch.from_numpy(np.random.default_rng(1).standard_normal(
        padded.num_docs_padded).astype(np.float32)).to(dev)
    s = gather_padded(scores, padded.pad_index.to(dev), sm)
    labels = gather_padded(padded.labels.to(dev), padded.pad_index.to(dev), sm)
    nvalid = padded.nvalid.to(dev)
    for metric in (Ndcg(10), Ndcg(0)):
        lam, w = lambda_gradients(s, labels, sm, nvalid, metric)
        lam2, w2 = lambda_gradients(s[200:], labels[200:], sm[200:], nvalid[200:], metric,
                                    query_chunk=7)
        assert torch.equal(lam[200:].view(torch.int32), lam2.view(torch.int32))
        assert torch.equal(w[200:].view(torch.int32), w2.view(torch.int32))
