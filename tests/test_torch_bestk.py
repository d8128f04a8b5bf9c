"""The port's best-k grower and leaf collapse (quickrank_tpu_torch:
trees/grow_bestk.py, trees/grow.py::_collapse_leaves) on the CPU.

``k = 1`` is the port's exact best-first ``fit_tree`` bit for bit, also
under feature sampling (both draw one mask a popped leaf from the same
generator).  Given JAX's gradients, ``k > 1`` grows JAX's ``fit_tree_bestk``
tree node for node, and a collapsed tree is JAX's for the same factor.  The
leaf budget and the minimum support hold as in tests/test_bestk.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data.synthetic import make_ranking_dataset as jax_make
from quickrank_tpu.data.synthetic import make_train_valid_test as jax_splits
from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu.trees import grow as jax_grow
from quickrank_tpu.trees.grow_bestk import fit_tree_bestk as jax_fit_tree_bestk
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning import LambdaMart, Mart
from quickrank_tpu_torch.metrics.metrics import Ndcg
from quickrank_tpu_torch.ops.binning import apply_bins, build_thresholds
from quickrank_tpu_torch.trees import grow
from quickrank_tpu_torch.trees.grow_bestk import fit_tree_bestk

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

NODE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf")


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def problem():
    """tests/test_bestk.py's problem: 400 docs x 7 features, 33 bins."""
    rng = np.random.default_rng(42)
    N, F = 400, 7
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (2.0 * (X[:, 0] > 0.2) + 1.0 * (X[:, 1] > -0.5) * X[:, 2]
         + 0.1 * rng.normal(size=N)).astype(np.float32)
    thr, _ = build_thresholds(X, 32)
    t = torch.from_numpy
    return (t(apply_bins(X, thr).astype(np.int32)), t(y), torch.ones(N, dtype=torch.bool),
            t(thr), thr.shape[1])


def _assert_same(tree_a, node_a, tree_b, node_b):
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tree_a, k)),
                                      np.asarray(getattr(tree_b, k)), k)
    np.testing.assert_array_equal(np.asarray(node_a), np.asarray(node_b))


@pytest.mark.parametrize("nleaves,minls,mf,max_depth", [
    (8, 1, 1.0, 0), (10, 5, 1.0, 0), (8, 1, 0.5, 0), (16, 3, 1.0, 3)])
def test_k1_bitwise_matches_exact_bestfirst(problem, nleaves, minls, mf, max_depth):
    binned, grad, mask, thr, B = problem
    cfg = grow.GrowConfig(nleaves=nleaves, min_leaf_support=minls, num_bins=B,
                          max_features=mf, max_depth=max_depth)
    t1, n1 = grow.fit_tree(binned, grad, mask, thr, cfg, torch.Generator().manual_seed(7))
    t2, n2 = fit_tree_bestk(binned, grad, mask, thr, cfg, 1,
                            torch.Generator().manual_seed(7))
    assert int((~t1.is_leaf).sum()) >= 3
    _assert_same(t1, n1, t2, n2)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_bestk_leaf_budget_and_minls(problem, k):
    """The final leaf count is exact best-first's (rt.cc:64-90's budget),
    every doc lands on a leaf, and every leaf holds >= minls docs; a round
    costs one host sync, so k > 1 takes fewer than one a split."""
    binned, grad, mask, thr, B = problem
    minls = 3
    cfg = grow.GrowConfig(nleaves=10, min_leaf_support=minls, num_bins=B)
    grow.HOST_SYNCS = 0
    tree, node = fit_tree_bestk(binned, grad, mask, thr, cfg, k)
    syncs = grow.HOST_SYNCS
    is_leaf = tree.is_leaf.numpy()
    n_nodes = 1 + 2 * int((~is_leaf).sum())
    leaves = [i for i in range(n_nodes) if is_leaf[i]]
    assert len(leaves) == 10
    nod = node.numpy()
    assert is_leaf[nod].all()
    for i in leaves:
        assert int((nod == i).sum()) >= minls
    assert 1 <= syncs < 9


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
    port = dict(binned=t(np.array(jtr.step.binned)), grad=t(np.array(lam)),
                mask=t(smask), thresholds=t(np.array(jtr.step.thresholds)))
    return jtr, lam, jnp.asarray(smask), port


def _cfgs(jtr, **kw):
    kw = dict(num_bins=jtr.num_bins, **kw)
    return jax_grow.GrowConfig(**kw), grow.GrowConfig(**kw)


@pytest.mark.parametrize("k,nleaves,minls,max_depth", [
    (4, 16, 1, 0), (2, 10, 20, 0), (8, 16, 1, 3), (15, 16, 5, 0)])
def test_bestk_matches_jax_tree_for_tree(jax_problem, k, nleaves, minls, max_depth):
    jtr, lam, smask, p = jax_problem
    jcfg, cfg = _cfgs(jtr, nleaves=nleaves, min_leaf_support=minls, max_depth=max_depth)
    jtree, jnode = jax_fit_tree_bestk(jtr.step.binned, lam, smask, jtr.step.thresholds,
                                      jcfg, k)
    tree, node = fit_tree_bestk(p["binned"], p["grad"], p["mask"], p["thresholds"], cfg, k)
    assert int((~tree.is_leaf).sum()) > 2
    _assert_same(tree, node, jtree, jnode)


@pytest.mark.parametrize("grower", ["best", "bestk"])
@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_collapse_leaves_matches_jax(jax_problem, grower, factor):
    """A collapse merges leaves while the node count stays within factor
    times the full tree of the popped depth, and routes the docs again; the
    pruned tree and the routing are JAX's."""
    jtr, lam, smask, p = jax_problem
    jcfg, cfg = _cfgs(jtr, nleaves=16, min_leaf_support=1, collapse_factor=factor)
    _, plain_cfg = _cfgs(jtr, nleaves=16, min_leaf_support=1)
    args = (p["binned"], p["grad"], p["mask"], p["thresholds"])
    jargs = (jtr.step.binned, lam, smask, jtr.step.thresholds)
    if grower == "best":
        jtree, jnode = jax_grow.fit_tree(*jargs, jcfg)
        tree, node = grow.fit_tree(*args, cfg)
        whole, _ = grow.fit_tree(*args, plain_cfg)
    else:
        jtree, jnode = jax_fit_tree_bestk(*jargs, jcfg, 4)
        tree, node = fit_tree_bestk(*args, cfg, 4)
        whole, _ = fit_tree_bestk(*args, plain_cfg, 4)
    _assert_same(tree, node, jtree, jnode)
    assert int(tree.is_leaf.sum()) > int(whole.is_leaf.sum())
    assert bool(tree.is_leaf[node.long()].all())


def test_split_pack_1_matches_best_end_to_end():
    """Mart(growth='bestk', split_pack=1) equals Mart(growth='best') over a
    whole run: the training-loop form of the k = 1 guarantee."""
    train, valid, _ = (_port_ds(d) for d in jax_splits(num_queries=(24, 8, 8),
                                                       num_features=20))
    kw = dict(ntrees=5, nleaves=8, nthresholds=32, seed=2)
    a = Mart(growth="best", **kw).learn(train, valid, Ndcg(10), verbose=False, device="cpu")
    b = Mart(growth="bestk", split_pack=1, **kw).learn(train, valid, Ndcg(10),
                                                      verbose=False, device="cpu")
    np.testing.assert_array_equal(a["train"], b["train"])
    np.testing.assert_array_equal(a["valid"], b["valid"])


def test_bestk_lambdamart_tracks_jax():
    """LambdaMart(growth='bestk') for three iterations: the first tree is
    JAX's, NDCG@10 within 1e-4; the model round-trips its grower tags."""
    train, valid, _ = jax_splits(num_queries=(36, 12, 12), num_features=20)
    kw = dict(ntrees=3, nleaves=8, nthresholds=63, seed=1, growth="bestk", split_pack=4,
              esr=0)
    j = JaxLambdaMart(**kw)
    j.learn(train, valid, JaxNdcg(10), verbose=False)
    p = LambdaMart(**kw)
    p.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False, device="cpu")
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(p.ensemble, k)[0].numpy(),
                                      np.asarray(getattr(j.ensemble, k))[0], k)
    for key in ("train", "valid"):
        np.testing.assert_allclose(p.history[key], j.history[key], atol=1e-4, rtol=0)
    info = p._info_dict()
    assert (info["growth"], info["split_pack"]) == ("bestk", 4)
    assert Mart(growth="best-k").growth == "bestk"


def test_collapse_in_the_training_loop():
    """collapse_leaves_factor > 0 trains: carried scores stay those of the
    pruned trees (docs are routed again after a collapse)."""
    from quickrank_tpu_torch.ops.scoring import score_ensemble

    train, _, _ = (_port_ds(d) for d in jax_splits(num_queries=(24, 8, 8), num_features=20))
    lm = LambdaMart(ntrees=3, nleaves=8, nthresholds=32, seed=1, collapse_leaves_factor=0.5)
    lm.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    whole = LambdaMart(ntrees=3, nleaves=8, nthresholds=32, seed=1)
    whole.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    assert int(lm.ensemble.is_leaf[0].sum()) > int(whole.ensemble.is_leaf[0].sum())
    want = score_ensemble(torch.from_numpy(train.features), lm.ensemble, max_depth=8)
    np.testing.assert_array_equal(lm.train_scores[: train.num_docs].numpy(), want.numpy())
