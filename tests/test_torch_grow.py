"""The port's binning, padded layout and tree growers against the JAX
package on the CPU.

Thresholds and bin ids are bitwise equal (same native binner, same numpy
fallback).  Given the same histogram the split scan picks the same split,
bit for bit.  Given JAX's own gradients (lambdas differ from the port's in
the last bit), both growers build the same trees: equal structure and
node_of_doc, and leaf values within 1e-6 relative (in practice equal)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data import dataset as jax_dataset
from quickrank_tpu.data.synthetic import make_ranking_dataset as jax_make
from quickrank_tpu.data.synthetic import make_train_valid_test as jax_splits
from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu.ops import binning as jax_binning
from quickrank_tpu.ops import histogram as jax_hist
from quickrank_tpu.ops.scoring import tree_delta_binned as jax_tree_delta
from quickrank_tpu.trees import grow as jax_grow
from quickrank_tpu.trees.grow_level import fit_tree_levelwise as jax_fit_level
from quickrank_tpu_torch.data import dataset
from quickrank_tpu_torch.data.synthetic import make_train_valid_test
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.ops import _binning_native, binning
from quickrank_tpu_torch.ops.scoring import tree_delta_binned
from quickrank_tpu_torch.trees import grow
from quickrank_tpu_torch.trees.grow_level import fit_tree_levelwise
from quickrank_tpu_torch.trees.structs import Tree

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

NODE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf")


def _features(seed, N=600, F=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1])  # few unique values: the unique-value table
    X[:, 2] *= 1e30  # a wide range
    X[::7, 3] = np.inf
    X[::11, 4] = np.nan
    return X


@pytest.mark.parametrize("nthresholds", [0, 15, 63, 255])
@pytest.mark.parametrize("native", [True, False])
def test_thresholds_and_bins_bitwise(nthresholds, native, monkeypatch):
    """Native path against JAX's native path, numpy fallback against JAX's
    numpy fallback (they differ only in the sign of a zero threshold)."""
    from quickrank_tpu.ops import _binning_native as jax_native

    X = _features(nthresholds)
    if not native:
        def refuse(*a, **k):
            raise RuntimeError("native binner disabled")

        for mod in (_binning_native, jax_native):
            monkeypatch.setattr(mod, "build_thresholds", refuse)
            monkeypatch.setattr(mod, "apply_bins", refuse)
    want_th, want_cnt = jax_binning.build_thresholds(X, nthresholds)
    want_bins = jax_binning.apply_bins(X, want_th)
    th, cnt = binning.build_thresholds(X, nthresholds)
    np.testing.assert_array_equal(th.view(np.int32), want_th.view(np.int32))
    np.testing.assert_array_equal(cnt, want_cnt)
    np.testing.assert_array_equal(binning.apply_bins(X, th), want_bins)


def test_splits_generator_and_layout_match_jax():
    """make_train_valid_test draws the same data; shard_and_pad (one shard,
    doc_align 1024) lays it out as JAX does; TrainData's u8 wire, padded
    feature width and thresholds are JAX's."""
    jtr, jva, _ = jax_splits(num_queries=(9, 4, 4))
    tr, va, _ = make_train_valid_test(num_queries=(9, 4, 4))
    for a, b in ((jtr, tr), (jva, va)):
        for k in ("features", "labels", "query_offsets", "qids"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    jp, p = jax_dataset.shard_and_pad(jtr), dataset.shard_and_pad(tr)
    assert p.num_docs_padded == jp.num_docs_padded
    for k in ("labels", "doc_mask", "pad_index", "slot_mask", "query_mask",
              "nvalid", "orig_index", "inv_q", "inv_slot"):
        np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(getattr(jp, k)))
    jt, t = JaxTrainData.build(jtr, 255), TrainData.build(tr, 255, device="cpu")
    assert t.step.binned.dtype == torch.uint8
    np.testing.assert_array_equal(t.step.binned.numpy(), np.asarray(jt.step.binned))
    np.testing.assert_array_equal(t.thresholds, np.asarray(jt.step.thresholds))
    np.testing.assert_array_equal(t.step.labels2d.numpy(), np.asarray(jt.step.labels2d))
    s = np.arange(p.num_docs_padded, dtype=np.float32)
    np.testing.assert_array_equal(
        dataset.gather_padded(torch.from_numpy(s), p.pad_index, p.slot_mask).numpy(),
        np.asarray(jax_dataset.gather_padded(jnp.asarray(s), jp.pad_index, jp.slot_mask)))


def _hist(seed=0, F=12, B=64):
    """A real histogram (count, g, g^2) of random binned docs."""
    rng = np.random.default_rng(seed)
    N = 900
    binned = rng.integers(0, B, size=(N, F)).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    chan = np.stack([np.ones(N), g, g * g], -1).astype(np.float32)
    return np.array(jax_hist.masked_histogram_scatter(
        jnp.asarray(binned), jnp.asarray(chan), jnp.ones(N, bool), B))


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("minls", [1, 40])
@pytest.mark.parametrize("sampled", [False, True])
def test_best_split_and_node_stats_bitwise(B, minls, sampled):
    h = _hist(seed=B + minls, B=B)
    fm = np.ones(h.shape[0], bool)
    if sampled:
        fm[np.random.default_rng(1).permutation(h.shape[0])[:6]] = False
    want = jax_grow._best_split(jnp.asarray(h), jnp.asarray(fm), minls)
    got = grow._best_split(torch.from_numpy(h), torch.from_numpy(fm), minls)
    assert [int(x) for x in want[:3]] == [int(x) for x in got[:3]]
    assert np.float32(want[3]) == got[3].numpy()
    jstats = jax_grow._node_stats(jnp.asarray(h))
    stats = grow._node_stats(torch.from_numpy(h))
    assert [np.float32(x) for x in jstats] == [x.numpy() for x in stats]
    assert np.float32(jax_grow._deviance(*jstats)) == grow._deviance(*stats).numpy()


@pytest.fixture(scope="module")
def jax_problem():
    """JAX TrainData of 30 queries x 20 features and JAX's own LambdaMART
    gradients at non-trivial scores, with a sampled doc mask."""
    jds = jax_make(num_queries=30, num_features=20, seed=11)
    jtr = JaxTrainData.build(jds, 63)
    N = jtr.padded.num_docs_padded
    rng = np.random.default_rng(0)
    scores = jnp.asarray(rng.normal(size=N).astype(np.float32)) * jtr.step.doc_mask
    lm = JaxLambdaMart()
    lm._train_metric = JaxNdcg(10)
    lam, w = lm._gradients(jtr.step, scores, jtr.step.doc_mask, None)
    smask = np.asarray(jtr.step.doc_mask) & (rng.uniform(size=N) < 0.85)
    t = torch.from_numpy
    port = dict(binned=t(np.asarray(jtr.step.binned)), grad=t(np.asarray(lam)),
                weights=t(np.asarray(w)), mask=t(smask),
                thresholds=t(np.asarray(jtr.step.thresholds)))
    return jtr, lam, w, jnp.asarray(smask), port


def _assert_same_tree(jtree, tree, jnode, node):
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(tree, k).numpy(), np.asarray(getattr(jtree, k)), k)
    np.testing.assert_array_equal(node.numpy(), np.asarray(jnode))
    want = np.asarray(jtree.leaf_value)
    np.testing.assert_allclose(tree.leaf_value.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("nleaves,minls,max_depth,newton", [
    (16, 1, 0, True), (16, 20, 0, False), (8, 1, 3, True), (31, 5, 0, True)])
def test_fit_tree_matches_jax(jax_problem, nleaves, minls, max_depth, newton):
    jtr, lam, w, smask, p = jax_problem
    jcfg = jax_grow.GrowConfig(nleaves=nleaves, min_leaf_support=minls,
                               num_bins=jtr.num_bins, newton=newton, max_depth=max_depth)
    jtree, jnode = jax_grow.fit_tree(jtr.step.binned, lam, smask, jtr.step.thresholds, jcfg)
    jtree = jax_grow.leaf_outputs(jtree, jnode, lam, smask, weights=w if newton else None)
    cfg = grow.GrowConfig(nleaves=nleaves, min_leaf_support=minls,
                          num_bins=jtr.num_bins, newton=newton, max_depth=max_depth)
    tree, node = grow.fit_tree(p["binned"], p["grad"], p["mask"], p["thresholds"], cfg)
    tree = grow.leaf_outputs(tree, node, p["grad"], p["mask"],
                             weights=p["weights"] if newton else None)
    assert int((~tree.is_leaf).sum()) > 2
    _assert_same_tree(jtree, tree, jnode, node)
    # the valid-fold rescore: bin-space descent of the same tree
    np.testing.assert_array_equal(
        tree_delta_binned(p["binned"], tree, nleaves).numpy(),
        np.asarray(jax_tree_delta(jtr.step.binned, jtree, nleaves)))


def test_fit_tree_matches_jax_at_100_thresholds():
    """A best-first tree at 100 thresholds (101 bins, a width whose XLA
    reduction windows are uneven: 19, 32, 32, 18): the root's node stats,
    from which the deviances that order best-first's leaves are taken, are
    bitwise JAX's, and the tree equals JAX's node for node given JAX's
    gradients."""
    jds = jax_make(num_queries=30, num_features=20, seed=12)
    jtr = JaxTrainData.build(jds, 100)
    assert jtr.num_bins == 101
    N = jtr.padded.num_docs_padded
    scores = jnp.asarray(np.random.default_rng(1).normal(size=N).astype(np.float32))
    lm = JaxLambdaMart()
    lm._train_metric = JaxNdcg(10)
    lam, _ = lm._gradients(jtr.step, scores * jtr.step.doc_mask, jtr.step.doc_mask, None)
    mask = jtr.step.doc_mask
    jcfg = jax_grow.GrowConfig(nleaves=24, min_leaf_support=1, num_bins=101)
    jtree, jnode = jax_grow.fit_tree(jtr.step.binned, lam, mask, jtr.step.thresholds, jcfg)
    jtree = jax_grow.leaf_outputs(jtree, jnode, lam, mask)
    t = torch.from_numpy
    binned, grad = t(np.asarray(jtr.step.binned)), t(np.asarray(lam))
    pmask = t(np.asarray(mask))
    g = np.asarray(lam) * np.asarray(mask)
    chan = np.stack([np.asarray(mask), g, g * g], -1).astype(np.float32)
    root = np.asarray(jax_hist.masked_histogram_scatter(
        jtr.step.binned, jnp.asarray(chan), mask, 101))
    jstats = jax.jit(jax_grow._node_stats)(jnp.asarray(root))
    stats = grow._node_stats(t(root))
    assert [np.float32(x) for x in jstats] == [x.numpy() for x in stats]
    cfg = grow.GrowConfig(nleaves=24, min_leaf_support=1, num_bins=101)
    tree, node = grow.fit_tree(binned, grad, pmask, t(np.asarray(jtr.step.thresholds)), cfg)
    tree = grow.leaf_outputs(tree, node, grad, pmask)
    assert int((~tree.is_leaf).sum()) == 23
    _assert_same_tree(jtree, tree, jnode, node)


@pytest.mark.parametrize("depth,minls,newton", [(4, 1, True), (3, 30, False), (5, 1, True)])
def test_fit_tree_levelwise_matches_jax(jax_problem, depth, minls, newton):
    jtr, lam, w, smask, p = jax_problem
    jcfg = jax_grow.GrowConfig(nleaves=2 ** depth, min_leaf_support=minls,
                               num_bins=jtr.num_bins, newton=newton, max_depth=depth)
    jtree, jnode = jax_fit_level(jtr.step.binned, lam, smask, jtr.step.thresholds,
                                 depth, jcfg, weights=w if newton else None)
    cfg = grow.GrowConfig(nleaves=2 ** depth, min_leaf_support=minls,
                          num_bins=jtr.num_bins, newton=newton, max_depth=depth)
    tree, node = fit_tree_levelwise(p["binned"], p["grad"], p["mask"], p["thresholds"],
                                    depth, cfg, weights=p["weights"] if newton else None)
    assert int((~tree.is_leaf).sum()) > 2
    _assert_same_tree(jtree, tree, jnode, node)
    np.testing.assert_array_equal(
        tree_delta_binned(p["binned"], tree, depth + 1).numpy(),
        np.asarray(jax_tree_delta(jtr.step.binned, jtree, depth + 1)))


def test_tree_from_jax_fields():
    jt = jax_grow.Tree.empty(7)
    t = Tree.from_numpy({k.name: np.asarray(getattr(jt, k.name))
                         for k in dataclasses.fields(Tree)})
    assert t.max_nodes == 7 and bool(t.is_leaf.all()) and int(t.feature[0]) == -1
    assert jax.devices()[0].platform == "cpu"
