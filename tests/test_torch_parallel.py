"""Query-sharded training of the port (``quickrank_tpu_torch/parallel``)
against the JAX package's ``shard_map`` path on ``make_mesh(2)``, on the CPU.

The layout and the multi-host helpers are held against JAX's with no
process spawned.  Then ONE launch of two gloo ranks on the CPU
(``parallel/launch.py``; the rank entry points live in the port package, so
the children import neither this module nor JAX) runs, for best-first,
best-k, level-wise and oblivious LambdaMART at 60 queries:

  * three trees grown from given gradients (JAX's lambdas of fixed
    scores), each held node for node against JAX's sharded grower given the
    same gradients: on the CPU both sum each shard's histogram in XLA's
    scatter order and add the two shards in one float32 add, so the trees
    are equal bit for bit, leaf values included;
  * three boosting iterations with the port's own lambdas, held against
    JAX's ``learn(mesh=make_mesh(2))`` (NDCG@10 within 1e-4 an iteration)
    and against the port's single-device run (``tests/test_sharding.py``'s
    tolerances: 1e-2 an iteration, 6e-3 on the last train value);
  * the multi-host data path (each rank keeps its own query block).

Every rank must return the same ensemble, byte for byte.  A rank that raises
fails its launch within the launch's deadline.  The histogram kernels' group
entry and its ``gpu`` tests are in ``test_torch_parallel_gpu.py``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quickrank_tpu.data.dataset import shard_and_pad as jax_shard_and_pad
from quickrank_tpu.data.synthetic import make_train_valid_test
from quickrank_tpu.learning import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning import ObliviousLambdaMart as JaxObliviousLambdaMart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.metrics import Ndcg as JaxNdcg
from quickrank_tpu.parallel import multihost as jax_multihost
from quickrank_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quickrank_tpu.parallel.mesh import shard_map, step_data_specs
from quickrank_tpu.trees.grow import leaf_outputs as jax_leaf_outputs
from quickrank_tpu_torch.data.dataset import Dataset, shard_and_pad
from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.ops.binning import build_thresholds
from quickrank_tpu_torch.parallel import multihost
from quickrank_tpu_torch.parallel.launch import run_ranks
from quickrank_tpu_torch.parallel.workers import batch_rank, fail_rank, save_dataset

SHARDS = 2
TREES = 3
NTHR = 32
#: every launch of this module finishes well inside this (one launch of the
#: four growers takes ~30 s on a loaded CPU)
DEADLINE = 300.0
GROWERS = ("best", "bestk", "level", "oblivious")
TREE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf",
               "leaf_value")


def _port_ds(d) -> Dataset:
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


def _kw(growth):
    if growth == "oblivious":
        return dict(ntrees=TREES, treedepth=3, nthresholds=NTHR, seed=1)
    return dict(ntrees=TREES, nleaves=8, nthresholds=NTHR, seed=1, growth=growth,
                max_depth=3 if growth == "level" else 0)


def _classes(growth):
    if growth == "oblivious":
        return "ObliviousLambdaMart", JaxObliviousLambdaMart
    return "LambdaMart", JaxLambdaMart


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(60, 20, 20))


# -- the layout and the multi-host helpers (no spawn) ------------------------

@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_and_pad_is_jax_layout(folds, shards):
    """Every field of the stacked layout equals JAX's element for element
    (the port's indices are int64 where JAX's are int32), and each block
    laid out alone (a rank's data) is that layout's slice."""
    ds = folds[0]
    want = jax_shard_and_pad(ds, num_shards=shards, features_on_device=False)
    got = shard_and_pad(_port_ds(ds), shards)
    for k in ("features", "labels", "doc_mask", "pad_index", "slot_mask", "query_mask",
              "nvalid", "orig_index", "inv_q", "inv_slot"):
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got.num_shards, got.docs_per_shard, got.queries_per_shard, got.max_docs) == (
        want.num_shards, want.docs_per_shard, want.queries_per_shard, want.max_docs)
    n, q = got.docs_per_shard, got.queries_per_shard
    for s in range(shards):
        blk = shard_and_pad(_port_ds(ds), shards, block=s)
        np.testing.assert_array_equal(blk.features, got.features[s * n:(s + 1) * n])
        for k in ("labels", "doc_mask", "orig_index", "inv_q", "inv_slot"):
            assert torch.equal(getattr(blk, k), getattr(got, k)[s * n:(s + 1) * n]), k
        for k in ("pad_index", "slot_mask", "query_mask", "nvalid"):
            assert torch.equal(getattr(blk, k), getattr(got, k)[s * q:(s + 1) * q]), k


def test_multihost_helpers_match_jax(folds):
    """process_query_block gives JAX's blocks for 1-4 processes, and the
    threshold merge JAX's tables (random candidate tables with sentinels,
    fewer and more distinct values than bins)."""
    ds = folds[0]
    for procs in (1, 2, 3, 4):
        for pid in range(procs):
            want = jax_multihost.process_query_block(ds, procs, pid)
            got = multihost.process_query_block(_port_ds(ds), procs, pid)
            np.testing.assert_array_equal(got.features, want.features)
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_array_equal(got.query_offsets, want.query_offsets)
            np.testing.assert_array_equal(got.qids, want.qids)
    rng = np.random.default_rng(3)
    for per, B in ((5, 16), (40, 16), (3, 8)):
        tabs = rng.standard_normal((3, 6, per)).astype(np.float32)
        tabs = np.concatenate([np.round(tabs, 1),
                               np.full((3, 6, B - per if B > per else 1), 3.4028235e38,
                                       np.float32)], axis=-1)[..., :max(B, per)]
        tabs[:, 0] = 3.4028235e38  # a constant feature: sentinels only
        np.testing.assert_array_equal(multihost.merge_threshold_candidates(tabs),
                                      jax_multihost.merge_threshold_candidates(tabs))


# -- one launch of two ranks --------------------------------------------------

def _given_gradients(folds):
    """(grad, weight) ``[T, S * docs_per_shard]`` in the stacked layout: JAX's
    lambdas of fixed random scores on the one-shard layout (real doc i sits
    at row i there), moved to their rows in the stacked one."""
    ds = folds[0]
    one = TrainData.build(_port_ds(ds), NTHR, device="cpu")
    stacked = shard_and_pad(_port_ds(ds), SHARDS)
    names = ("labels2d", "doc_mask", "pad_index", "inv_q", "inv_slot", "slot_mask", "nvalid")
    jsd = SimpleNamespace(**{k: jnp.asarray(getattr(one.step, k).numpy()) for k in names})
    me = SimpleNamespace(_train_metric=JaxNdcg(10), query_chunk=None)
    rng = np.random.default_rng(7)
    src = np.maximum(stacked.orig_index.numpy(), 0)
    real = stacked.doc_mask.numpy()
    grads, weights = [], []
    for _ in range(TREES):
        scores = rng.standard_normal(one.padded.num_docs_padded).astype(np.float32)
        g, w = JaxLambdaMart._gradients(me, jsd, jnp.asarray(scores), jsd.doc_mask, None)
        grads.append(np.where(real, np.asarray(g)[src], 0.0).astype(np.float32))
        weights.append(np.where(real, np.asarray(w)[src], 0.0).astype(np.float32))
    return np.stack(grads), np.stack(weights)


@pytest.fixture(scope="module")
def given(folds):
    return _given_gradients(folds)


@pytest.fixture(scope="module")
def port_ranks(folds, given, tmp_path_factory):
    """The one launch: per grower the given-gradient trees and a training
    run, then the multi-host path, in two gloo ranks on the CPU."""
    tmp = tmp_path_factory.mktemp("ranks")
    train = save_dataset(_port_ds(folds[0]), str(tmp / "train.npz"))
    valid = save_dataset(_port_ds(folds[1]), str(tmp / "valid.npz"))
    grads = str(tmp / "given.npz")
    np.savez(grads, grad=given[0], weight=given[1])
    jobs = []
    for growth in GROWERS:
        name, _ = _classes(growth)
        spec = dict(learner=name, kwargs=_kw(growth), train=train, valid=valid)
        jobs += [("grow_rank", dict(spec, gradients=grads)), ("train_rank", spec)]
    # the multi-host path with the full data's tables given, and with the
    # tables merged from the blocks' own candidates
    mh = dict(learner="LambdaMart", kwargs=_kw("best"), train=train, valid=valid)
    full_thr, _ = build_thresholds(folds[0].features, NTHR)
    jobs += [("multihost_rank", dict(mh, thresholds=full_thr)), ("multihost_rank", mh)]
    t0 = time.monotonic()
    out = run_ranks(batch_rank, SHARDS, args=(jobs,), device="cpu", deadline=DEADLINE)
    assert time.monotonic() - t0 < DEADLINE
    by_growth = {g: ([r[2 * i] for r in out], [r[2 * i + 1] for r in out])
                 for i, g in enumerate(GROWERS)}
    return by_growth, [r[-2] for r in out], [r[-1] for r in out]


@pytest.fixture(scope="module")
def jax_given_trees(folds, given):
    """JAX's sharded growers on ``make_mesh(2)`` given the same gradients:
    ``_fit_and_assign`` and ``leaf_outputs`` under ``shard_map`` with the
    histograms and leaf sums ``psum``-reduced, as its boosting step runs
    them."""
    mesh = jax_make_mesh(SHARDS)
    jtr = JaxTrainData.build(folds[0], NTHR, num_shards=SHARDS)
    specs = step_data_specs(jtr.step, "data")
    out = {}
    for growth in GROWERS:
        _, cls = _classes(growth)
        jl = cls(**_kw(growth))
        cfg = jl._grow_config(jtr.num_bins, num_real_features=jtr.num_real_features)

        def fit(sd, g, w, jl=jl, cfg=cfg):
            tree, node, done = jl._fit_and_assign(sd, g, sd.doc_mask, cfg,
                                                  jax.random.PRNGKey(0), "data", weights=w)
            if not done:
                tree = jax_leaf_outputs(tree, node, g, sd.doc_mask, weights=w,
                                        axis_name="data")
            return tree, node

        fn = jax.jit(shard_map(fit, mesh, in_specs=(specs, P("data"), P("data")),
                               out_specs=(P(), P("data"))))
        out[growth] = [fn(jtr.step, jnp.asarray(given[0][m]), jnp.asarray(given[1][m]))
                       for m in range(TREES)]
    return out


@pytest.fixture(scope="module")
def jax_runs(folds):
    """JAX's own sharded training on ``make_mesh(2)``, for each grower."""
    out = {}
    for growth in GROWERS:
        _, cls = _classes(growth)
        jl = cls(**_kw(growth))
        out[growth] = jl.learn(folds[0], folds[1], JaxNdcg(10), verbose=False,
                               mesh=jax_make_mesh(SHARDS))
    return out


@pytest.mark.parametrize("growth", GROWERS)
def test_given_lambdas_trees_equal_jax_shard_map(port_ranks, jax_given_trees, growth):
    """Given the same gradients, the port's two ranks grow JAX's sharded
    trees node for node, leaf values bit for bit, and route every doc of
    each shard to JAX's node."""
    grown = port_ranks[0][growth][0]
    for m in range(TREES):
        jtree, jnode = jax_given_trees[growth][m]
        for rank in range(SHARDS):
            got = grown[rank][m]
            for k in TREE_FIELDS:
                np.testing.assert_array_equal(got["tree"][k], np.asarray(getattr(jtree, k)),
                                              err_msg=f"tree {m}, rank {rank}: {k}")
        jn = np.asarray(jnode).reshape(SHARDS, -1)
        for rank in range(SHARDS):
            np.testing.assert_array_equal(grown[rank][m]["node"], jn[rank],
                                          err_msg=f"tree {m}, rank {rank}: node of doc")


@pytest.mark.parametrize("growth", GROWERS)
def test_ranks_hold_the_same_ensemble(port_ranks, growth):
    """Every rank returns the same trees, byte for byte, and the same
    reduced metrics."""
    runs = port_ranks[0][growth][1]
    for k, v in runs[0]["trees"].items():
        for other in runs[1:]:
            assert np.asarray(v).tobytes() == np.asarray(other["trees"][k]).tobytes(), k
    for other in runs[1:]:
        assert other["history"]["train"] == runs[0]["history"]["train"]
        assert other["history"]["valid"] == runs[0]["history"]["valid"]


@pytest.mark.parametrize("growth", GROWERS)
def test_ndcg_matches_jax_sharded_run(port_ranks, jax_runs, growth):
    """With the port's own lambdas, NDCG@10 on train and valid within 1e-4
    of JAX's ``learn(mesh=make_mesh(2))`` for the three iterations (the
    lambdas differ from XLA's in the last bit, ROADMAP §C)."""
    got = port_ranks[0][growth][1][0]["history"]
    want = jax_runs[growth]
    np.testing.assert_allclose(got["train"], want["train"][:TREES], atol=1e-4)
    np.testing.assert_allclose(got["valid"], want["valid"][:TREES], atol=1e-4)


@pytest.mark.parametrize("growth", GROWERS)
def test_two_ranks_match_one(port_ranks, folds, growth):
    """The port's two ranks against its single-device run (on the CPU a
    one-rank group is that run): tests/test_sharding.py's tolerances, 1e-2
    an iteration and 6e-3 on the last train NDCG@10."""
    got = port_ranks[0][growth][1][0]["history"]
    name, _ = _classes(growth)
    model = {"LambdaMart": LambdaMart, "ObliviousLambdaMart": ObliviousLambdaMart}[name](
        **_kw(growth))
    one = model.learn(_port_ds(folds[0]), _port_ds(folds[1]), Ndcg(10), verbose=False,
                      device="cpu")
    np.testing.assert_allclose(got["train"], one["train"], atol=1e-2)
    np.testing.assert_allclose(got["valid"], one["valid"], atol=1e-2)
    assert abs(got["train"][-1] - one["train"][-1]) < 6e-3


@pytest.mark.parametrize("tables", ["given", "merged"])
def test_multihost_path_trains_the_same_model_everywhere(port_ranks, folds, tables):
    """Each rank loaded only its own query block (the blocks partition the
    docs), and the ranks agree on the tables and the geometry and hold the
    same ensemble.  With the full data's tables given, training is within
    tests/test_multihost.py's 6e-3 of the single-host group run; with the
    tables merged from the blocks' candidates (another binning) it learns."""
    mh = port_ranks[1] if tables == "given" else port_ranks[2]
    assert all(r["local_docs"] > 0 for r in mh)
    assert sum(r["local_docs"] for r in mh) == folds[0].num_docs
    for k, v in mh[0]["trees"].items():
        assert np.asarray(v).tobytes() == np.asarray(mh[1]["trees"][k]).tobytes(), k
    assert mh[0]["history"] == mh[1]["history"]
    ref = port_ranks[0]["best"][1][0]["history"]
    if tables == "given":
        np.testing.assert_allclose(mh[0]["history"]["train"], ref["train"], atol=6e-3)
    else:
        assert mh[0]["history"]["train"][-1] > mh[0]["history"]["train"][0]


@pytest.mark.parametrize("what", [
    "Dart", "RandomForest", "LambdaMartSelective", "StochasticNegative", "RankBoost",
    "CoordinateAscent", "LineSearch", "cluster-on", "MetaCleaver", "Cleaver",
    "num-feat-shards", "quicklearn-DART"])
def test_unsharded_modules_refuse_a_group_naming_item_10b(folds, what, tmp_path):
    """What this slice does not shard raises before touching data, naming
    ROADMAP.md §A item 10b: nothing falls back to one device."""
    from quickrank_tpu_torch import driver, learning
    from quickrank_tpu_torch.optimization import Cleaver
    from quickrank_tpu_torch.parallel import DataGroup

    group = DataGroup(rank=0, world_size=2, device=torch.device("cpu"), backend="gloo")
    ds = _port_ds(folds[0])
    with pytest.raises(NotImplementedError, match="item 10b"):
        if what == "cluster-on":
            LambdaMart(ntrees=1, cluster="on").learn(ds, mesh=group, device="cpu")
        elif what == "MetaCleaver":
            learning.MetaCleaver(LambdaMart(ntrees=1), Cleaver()).learn(ds, mesh=group,
                                                                        device="cpu")
        elif what == "Cleaver":
            Cleaver().optimize(LambdaMart(ntrees=1), ds, mesh=group, device="cpu")
        elif what == "num-feat-shards":
            driver.run(dict(num_feat_shards=2, train=str(tmp_path / "never-read.svml")))
        elif what == "quicklearn-DART":
            # the learner's own refusal, asked before any rank starts
            driver.run(dict(algo="DART", num_shards=2, device="cpu",
                            train=str(tmp_path / "never-read.svml")))
        else:
            getattr(learning, what)().learn(ds, mesh=group, device="cpu")


def test_a_failing_rank_fails_the_launch_within_its_deadline():
    """Rank 1 raises while rank 0 waits in a collective that only its 60 s
    timeout would end: the launch stops rank 0 and raises with rank 1's
    traceback well before the deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(fail_rank, SHARDS, args=(1,), device="cpu", deadline=45.0)
    assert time.monotonic() - t0 < 45.0
