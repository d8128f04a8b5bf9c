"""The port's oblivious path (quickrank_tpu_torch: trees/oblivious.py,
ops/oblivious.py, ops/kernel_oblivious.py, learning/obliviousmart.py)
against the JAX package on the CPU.

Scorer: leaf indices are exact (read out of JAX's own scorers through leaf
tables that encode the index), scores within ``1e-5 * max(1, max|ref|)`` of
JAX's XLA scorer and of its Pallas kernel in interpret mode (the three sum
the trees in different orders).  Grower: given JAX's gradients the level
tables and the doc routing are bitwise JAX's.  Learners: the first tree's
levels equal JAX's, NDCG@10 within 1e-4 for three iterations, and XML
models cross between the packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data.synthetic import make_ranking_dataset as jax_make
from quickrank_tpu.data.synthetic import make_train_valid_test as jax_splits
from quickrank_tpu.learning import ObliviousLambdaMart as JaxObliviousLambdaMart
from quickrank_tpu.learning import ObliviousMart as JaxObliviousMart
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu.ops.oblivious import score_oblivious as jax_score_oblivious
from quickrank_tpu.ops.pallas_oblivious import score_oblivious_pallas
from quickrank_tpu.trees import oblivious as jax_obl
from quickrank_tpu_torch import quickscore
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.data.svml import write_svml
from quickrank_tpu_torch.learning import LTRAlgorithm, ObliviousLambdaMart, ObliviousMart
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.metrics.metrics import Ndcg
from quickrank_tpu_torch.ops import kernel_oblivious
from quickrank_tpu_torch.ops import oblivious as plain
from quickrank_tpu_torch.ops.scoring import score_ensemble
from quickrank_tpu_torch.trees import oblivious as obl
from quickrank_tpu_torch.trees.random_ensemble import random_oblivious_ensemble

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

FLT_MAX = np.finfo(np.float32).max
FIELDS = ("fid", "thr", "thr_bin", "leaf", "weight", "num_trees")


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


def _tables(T, D, F, seed, dead=False, live=None):
    """Numpy fields of a random oblivious ensemble; with ``dead``, the last
    level of every other tree and one whole tree are dead (FLT_MAX)."""
    rng = np.random.default_rng(seed)
    d = dict(
        fid=rng.integers(0, F, size=(T, D)).astype(np.int32),
        thr=rng.normal(size=(T, D)).astype(np.float32),
        thr_bin=rng.integers(0, 8, size=(T, D)).astype(np.int32),
        leaf=rng.normal(size=(T, 2 ** D)).astype(np.float32),
        weight=rng.uniform(0.05, 0.3, size=T).astype(np.float32),
        num_trees=T if live is None else live,
    )
    if dead:
        d["thr"][::2, -1] = FLT_MAX
        d["thr"][1] = FLT_MAX
    return d


def _jax_ens(d):
    return jax_obl.ObliviousEnsemble(**{k: jnp.asarray(d[k]) for k in FIELDS})


def _ref_index(X, d):
    T, D = d["fid"].shape
    bits = X[:, d["fid"].reshape(-1)].reshape(len(X), T, D) > d["thr"][None]
    return (bits << np.arange(D - 1, -1, -1)).sum(-1)


@pytest.mark.parametrize("T,D,F,N,dead,live", [
    (5, 4, 12, 300, False, None), (6, 3, 20, 257, True, 4), (1, 1, 3, 64, False, None)])
def test_score_oblivious_matches_jax(T, D, F, N, dead, live):
    d = _tables(T, D, F, seed=T * 10 + D, dead=dead, live=live)
    X = np.random.default_rng(N).normal(size=(N, F)).astype(np.float32)
    ens = obl.ObliviousEnsemble.from_numpy(d)
    got = plain.score_oblivious(torch.from_numpy(X), ens).numpy()
    ref = np.asarray(jax_score_oblivious(jnp.asarray(X), _jax_ens(d)))
    pallas = np.asarray(score_oblivious_pallas(jnp.asarray(X), _jax_ens(d), tile_n=128,
                                               interpret=True))
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=atol)
    # the plain version is a float32 sum in tree order of leaf * weight
    idx = _ref_index(X, d)
    wl = d["leaf"] * (d["weight"] * (np.arange(T) < d["num_trees"]))[:, None].astype(np.float32)
    want = np.zeros(N, np.float32)
    for t in range(T):
        want = want + wl[t, idx[:, t]]
    np.testing.assert_array_equal(got, want)
    # tree chunks change nothing; the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        plain.score_oblivious(torch.from_numpy(X), ens, tree_chunk=2).numpy(), got)
    before = kernel_oblivious.LAUNCHES
    np.testing.assert_array_equal(
        kernel_oblivious.score_oblivious(torch.from_numpy(X), ens).numpy(), got)
    assert kernel_oblivious.LAUNCHES == before


@pytest.mark.parametrize("D", [13, 14])
def test_deep_models_match_jax_oblivious_scorer(D):
    """Depths past 12 (the card's kernel reads such leaf tables from global
    memory): the port's wrapper on the CPU, its plain path, against the JAX
    learner's scorer off the TPU (``obliviousmart._oblivious_scorer``) on
    the same numpy draws.  Scores within ``1e-5 * max(1, max|ref|)`` (JAX
    sums through a one-hot matmul), and leaf indices exactly: each tree
    alone with ``leaf[l] = l`` and weight 1 scores its own index."""
    from quickrank_tpu.learning.obliviousmart import _oblivious_scorer

    T, F, N = 4, 20, 300
    d = _tables(T, D, F, seed=D, dead=True)
    X = np.random.default_rng(D).normal(size=(N, F)).astype(np.float32)
    jax_score = _oblivious_scorer(0)
    got = kernel_oblivious.score_oblivious(torch.from_numpy(X),
                                           obl.ObliviousEnsemble.from_numpy(d)).numpy()
    ref = np.asarray(jax_score(jnp.asarray(X), _jax_ens(d)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    want = _ref_index(X, d)
    for t in range(T):
        one = dict(fid=d["fid"][t:t + 1], thr=d["thr"][t:t + 1], thr_bin=d["thr_bin"][t:t + 1],
                   leaf=np.arange(2 ** D, dtype=np.float32)[None], weight=np.ones(1, np.float32),
                   num_trees=1)
        port = kernel_oblivious.score_oblivious(torch.from_numpy(X),
                                                obl.ObliviousEnsemble.from_numpy(one)).numpy()
        np.testing.assert_array_equal(port, want[:, t].astype(np.float32))
        np.testing.assert_array_equal(np.asarray(jax_score(jnp.asarray(X), _jax_ens(one))), port)


def test_leaf_indices_equal_jax_exactly():
    """Leaf tables that encode the index (leaf[t, l] = l * 16^t, weight 1)
    make each scorer's sum spell out its leaf indices: exact in float32."""
    T, D, F, N = 5, 4, 12, 400
    d = _tables(T, D, F, seed=3, dead=True)
    d["leaf"] = (np.arange(16)[None, :] * 16.0 ** np.arange(T)[:, None]).astype(np.float32)
    d["weight"] = np.ones(T, np.float32)
    X = np.random.default_rng(0).normal(size=(N, F)).astype(np.float32)
    # features equal to their thresholds must route left
    for t in (0, 2, 3, 4):  # tree 1 is all dead
        for lvl in range(D - 1):
            X[t * D + lvl, d["fid"][t, lvl]] = d["thr"][t, lvl]
    idx = plain.leaf_index(torch.from_numpy(X), torch.from_numpy(d["fid"]),
                           torch.from_numpy(d["thr"])).numpy()
    np.testing.assert_array_equal(idx, _ref_index(X, d))
    assert all(idx[t * D, t] >> (D - 1) == 0 for t in (0, 2, 3, 4))
    assert (idx[:, 1] == 0).all()  # an all-dead tree sends every doc to leaf 0
    spelled = (idx * 16 ** np.arange(T)).sum(1).astype(np.float32)
    for scores in (jax_score_oblivious(jnp.asarray(X), _jax_ens(d)),
                   score_oblivious_pallas(jnp.asarray(X), _jax_ens(d), tile_n=128,
                                          interpret=True),
                   plain.score_oblivious(torch.from_numpy(X),
                                         obl.ObliviousEnsemble.from_numpy(d)).numpy()):
        np.testing.assert_array_equal(np.asarray(scores), spelled)


def test_random_oblivious_ensemble_draws_like_the_jax_benchmark():
    """The draws of the JAX package's scoring benchmark (bench.py:74-86),
    in its order, from one generator."""
    N, F, T, D = 512, 136, 20, 4
    feats, ens = random_oblivious_ensemble(T, D, F, seed=0, num_docs=N)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(feats, rng.normal(size=(N, F)).astype(np.float32))
    np.testing.assert_array_equal(ens.fid.numpy(), rng.integers(0, F, size=(T, D)))
    np.testing.assert_array_equal(ens.thr.numpy(), rng.normal(size=(T, D)).astype(np.float32))
    np.testing.assert_array_equal(ens.leaf.numpy(),
                                  rng.normal(size=(T, 2 ** D)).astype(np.float32))
    assert ens.num_trees == T and float(ens.weight[0]) == np.float32(0.1)
    jens = _jax_ens({k: (getattr(ens, k).numpy() if k != "num_trees" else T) for k in FIELDS})
    ref = np.asarray(jax_score_oblivious(jnp.asarray(feats), jens))
    got = plain.score_oblivious(torch.from_numpy(feats), ens).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "narrow", "device",
                                 "tables"])
def test_wrapper_rejects_bad_inputs(bad):
    ens = obl.ObliviousEnsemble.from_numpy(_tables(3, 2, 5, seed=1))
    X = torch.zeros((16, 5))
    if bad == "tables":
        ens = ens.to("meta")
    X = {"dtype": X.double(), "shape": X[None], "contiguous": torch.zeros((5, 16)).T,
         "narrow": X[:, : ens.min_features - 1].contiguous(),
         "device": X.to("meta"), "tables": X}[bad]
    if bad == "device":
        ens = ens.to("meta")
    with pytest.raises(ValueError):
        kernel_oblivious.score_oblivious(X, ens)


def test_ensemble_container():
    e = obl.ObliviousEnsemble.empty(3, 2)
    assert (e.capacity, e.depth, e.num_leaves, e.num_trees) == (3, 2, 4, 0)
    assert float(e.thr[0, 0]) == FLT_MAX and int(e.thr_bin[0, 0]) == 2 ** 30
    d = _tables(2, 2, 4, seed=2)
    for t in range(2):
        e.push(*(torch.from_numpy(d[k][t]) for k in ("fid", "thr", "thr_bin", "leaf")),
               float(d["weight"][t]))
    assert e.num_trees == 2 and e.min_features == int(d["fid"].max()) + 1
    X = torch.from_numpy(np.random.default_rng(1).normal(size=(50, 4)).astype(np.float32))
    want = plain.score_oblivious(X, obl.ObliviousEnsemble.from_numpy(d))
    np.testing.assert_array_equal(plain.score_oblivious(X, e).numpy(), want.numpy())
    with pytest.raises(ValueError, match="full"):
        for _ in range(2):
            e.push(e.fid[0], e.thr[0], e.thr_bin[0], e.leaf[0], 0.1)
    with pytest.raises(ValueError, match="leaf"):
        obl.ObliviousEnsemble.from_numpy(dict(d, leaf=d["leaf"][:, :3]))


def _score_record(X, packed, depth):
    """Scores read off the packed records alone: the records' levels, the
    thresholds' float32 bits and their wleaf, summed in tree order."""
    fid, thr_bits, wleaf = obl.unpack_oblivious(packed, depth)
    idx = plain.leaf_index(X, fid, thr_bits.view(torch.float32))
    acc = torch.zeros(X.shape[0], dtype=torch.float32)
    for t in range(fid.shape[0]):
        acc = acc + wleaf[t, idx[:, t]]
    return acc


@pytest.mark.parametrize("D", range(1, 15))
def test_packed_record_unpacks_exactly(D):
    """The kernel's table (``ObliviousEnsemble.packed``) holds fid, the
    thresholds' bits (``thr`` in value space, ``thr_bin`` in bin space) and
    ``wleaf`` exactly, dead trees past ``num_trees`` and dead levels
    included, in whole 16-byte records zero-padded at the end."""
    T, F, live = 7, 30, 5
    d = _tables(T, D, F, seed=100 + D, dead=True, live=live)
    ens = obl.ObliviousEnsemble.from_numpy(d)
    wleaf = ens.wleaf()
    assert (wleaf[live:] == 0).all()
    S = obl.record_words(D)
    assert S % 4 == 0 and 2 * D + 2 ** D <= S < 2 * D + 2 ** D + 4
    for binned, thr in ((False, ens.thr.view(torch.int32)), (True, ens.thr_bin)):
        packed = ens.packed(binned)
        assert packed.dtype == torch.int32 and tuple(packed.shape) == (T, S)
        assert ens.packed(binned) is packed  # built once
        fid, thr_bits, wl = obl.unpack_oblivious(packed, D)
        assert torch.equal(fid, ens.fid) and torch.equal(thr_bits, thr)
        assert torch.equal(wl.view(torch.int32), wleaf.view(torch.int32))
        assert (packed[:, 2 * D + 2 ** D:] == 0).all()
    X = torch.from_numpy(np.random.default_rng(D).normal(size=(64, F)).astype(np.float32))
    np.testing.assert_array_equal(_score_record(X, ens.packed(), D).numpy(),
                                  plain.score_oblivious(X, ens).numpy())


@pytest.mark.parametrize("change", ["push", "weight", "num_trees", "leaf"])
def test_packed_tables_follow_the_ensemble(change):
    """Changing the tables drops the packed records: ``push``, and an
    assignment to ``weight``, ``num_trees`` or ``leaf``.  The records'
    scores change, and equal those of a fresh ensemble of the new tables."""
    T, D, F = 6, 3, 12
    d = _tables(T, D, F, seed=7, live=4)
    ens = obl.ObliviousEnsemble.from_numpy(d)
    X = torch.from_numpy(np.random.default_rng(3).normal(size=(80, F)).astype(np.float32))
    before = _score_record(X, ens.packed(), D)
    binned_before = ens.packed(True).clone()
    if change == "push":
        e = _tables(1, D, F, seed=8)
        ens.push(*(torch.from_numpy(e[k][0]) for k in ("fid", "thr", "thr_bin", "leaf")), 0.5)
    elif change == "weight":
        ens.weight = ens.weight * 2
    elif change == "num_trees":
        ens.num_trees = 2
    else:
        ens.leaf = -ens.leaf
    fresh = obl.ObliviousEnsemble.from_numpy(
        {k: (getattr(ens, k).numpy() if k != "num_trees" else ens.num_trees) for k in FIELDS})
    after = _score_record(X, ens.packed(), D)
    assert not torch.equal(after, before)
    np.testing.assert_array_equal(after.numpy(), plain.score_oblivious(X, fresh).numpy())
    assert torch.equal(ens.packed(True), fresh.packed(True))
    assert not torch.equal(ens.packed(True), binned_before)
    # ``to`` carries no packed table: the copy packs its own
    assert ens.to("cpu")._packed is None


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


@pytest.mark.parametrize("depth,minls", [(4, 1), (3, 25), (4, 400)])
def test_fit_oblivious_tree_matches_jax(jax_problem, depth, minls):
    """Levels and routing bitwise JAX's, leaf values within 1e-6; a large
    minimum support leaves dead levels (FLT_MAX, bin B), as in JAX."""
    jtr, lam, w, smask, p = jax_problem
    jf, jt, jb, jn = jax_obl.fit_oblivious_tree(
        jtr.step.binned, lam, smask, jtr.step.thresholds, depth, min_leaf_support=minls)
    fid, thr, tbin, node = obl.fit_oblivious_tree(
        p["binned"], p["grad"], p["mask"], p["thresholds"], depth, min_leaf_support=minls)
    np.testing.assert_array_equal(fid.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(thr.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tbin.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(node.numpy(), np.asarray(jn))
    assert (np.asarray(jt) == FLT_MAX).any() == (minls == 400)
    jleaf = jax_obl.oblivious_leaf_outputs(jn, lam, smask, 2 ** depth, weights=w)
    leaf = obl.oblivious_leaf_outputs(node, p["grad"], p["mask"], 2 ** depth,
                                      weights=p["weights"])
    np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), rtol=1e-6, atol=0)
    jtree = jax_obl.oblivious_to_tree(jf, jt, jb, jleaf)
    tree = obl.oblivious_to_tree(fid, thr, tbin, leaf)
    for k in ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf"):
        np.testing.assert_array_equal(getattr(tree, k).numpy(), np.asarray(getattr(jtree, k)), k)


#: learner, depth, with a valid fold (whose rollback may keep fewer trees)
CONFIGS = [("obvlambdamart", 4, False), ("obvmart", 3, True)]


@pytest.fixture(scope="module")
def small_splits():
    return jax_splits(num_queries=(36, 12, 12), num_features=20)


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: c[0])
def runs(request, small_splits):
    """One JAX run and one port run of three iterations per learner."""
    algo, depth, with_valid = request.param
    train, valid, test = small_splits
    valid = valid if with_valid else None
    jcls, pcls = ((JaxObliviousLambdaMart, ObliviousLambdaMart) if algo == "obvlambdamart"
                  else (JaxObliviousMart, ObliviousMart))
    kw = dict(ntrees=3, treedepth=depth, nthresholds=63, seed=1, esr=0)
    j = jcls(**kw)
    j.learn(train, valid, JaxNdcg(10), verbose=False)
    p = pcls(**kw)
    p.learn(_port_ds(train), _port_ds(valid) if valid else None, Ndcg(10),
            verbose=False, device="cpu")
    return j, p, test


def test_first_tree_levels_equal_jax(runs):
    j, p, _ = runs
    jo, po = j.oblivious_ensemble(), p.oblivious_ensemble()
    for k in ("fid", "thr", "thr_bin"):
        np.testing.assert_array_equal(getattr(po, k)[0].numpy(), np.asarray(getattr(jo, k))[0], k)
    np.testing.assert_allclose(po.leaf[0].numpy(), np.asarray(jo.leaf)[0], rtol=1e-5, atol=1e-7)
    assert po.num_trees == int(jo.num_trees) == p.best_iteration + 1
    assert po.depth == p.treedepth


def test_ndcg_tracks_jax(runs):
    j, p, _ = runs
    for key in ("train", "valid"):  # valid is NaN without a valid fold
        np.testing.assert_allclose(p.history[key], j.history[key], atol=1e-4, rtol=0)
    assert len(p.history["train"]) == 3
    assert p.history["train"][-1] > p.history["train"][0]
    assert p.best_iteration == j.best_iteration


def test_scores_match_descent_and_binned_scorer(runs, small_splits):
    """The bit-OR scorer against the compensated descent of the stored
    perfect trees, and the bin-space scorer equal to the value-space one."""
    _, p, test = runs
    ds = _port_ds(test)
    got = p.score_dataset(ds, device="cpu")
    ref = score_ensemble(torch.from_numpy(ds.features), p.ensemble,
                         max_depth=p._descend_depth()).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    train = _port_ds(small_splits[0])
    td = TrainData.build(train, 63, device="cpu")
    o = p.oblivious_ensemble()
    X = torch.from_numpy(train.features)
    by_value = kernel_oblivious.score_oblivious(X, o)
    by_bin = kernel_oblivious.score_oblivious(
        td.step.binned[: train.num_docs].contiguous(), o)
    np.testing.assert_array_equal(by_bin.numpy(), by_value.numpy())
    np.testing.assert_array_equal(
        plain.score_oblivious_binned(td.step.binned[: train.num_docs].int(), o).numpy(),
        by_value.numpy())


def test_xml_crosses_between_the_packages(runs, tmp_path):
    """Port -> JAX and JAX -> port: type, depth and scores (the bit-OR
    scorers of the two packages sum in different orders: the K2 bound)."""
    j, p, test = runs
    ppath, jpath = os.path.join(tmp_path, "p.xml"), os.path.join(tmp_path, "j.xml")
    p.save(ppath)
    j.save(jpath)
    jm = JaxLTRAlgorithm.load(ppath)
    assert type(jm).NAME == p.NAME and jm.treedepth == p.treedepth
    got = p.score_dataset(_port_ds(test), device="cpu")
    want = np.asarray(jm.score_dataset(test))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    pm = LTRAlgorithm.load(jpath)
    assert type(pm) is type(p) and pm.treedepth == j.treedepth
    assert pm.scorer_path() == "oblivious"
    want = np.asarray(j.score_dataset(test))
    np.testing.assert_allclose(pm.score_dataset(_port_ds(test), device="cpu"), want,
                               rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert pm.evaluate(_port_ds(test), Ndcg(10), device="cpu") == pytest.approx(
        j.evaluate(test, JaxNdcg(10)), abs=1e-5)


def test_loaded_model_level_tables(runs, tmp_path):
    """A loaded model numbers nodes in pre-order and may hold shallower
    trees; its level tables are those of the trained model, and a tree cut
    to one level keeps dead levels below."""
    _, p, test = runs
    path = os.path.join(tmp_path, "p.xml")
    p.save(path)
    back = LTRAlgorithm.load(path)
    assert not np.array_equal(back.ensemble.left.numpy(), p.ensemble.left.numpy())
    a, b = p.oblivious_ensemble(), back.oblivious_ensemble()
    for k in ("fid", "thr", "leaf", "weight"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), getattr(b, k).numpy(), k)
    assert back.oblivious_ensemble() is b  # cached per ensemble
    np.testing.assert_array_equal(back.score_dataset(_port_ds(test), device="cpu"),
                                  p.score_dataset(_port_ds(test), device="cpu"))
    # a depth-1 tree inside a deeper model
    stump = type(p)(treedepth=p.treedepth)
    e = p.ensemble.live()
    e.is_leaf[0, 1:3] = True
    e.leaf_value[0, 1], e.leaf_value[0, 2] = 0.25, -0.5
    stump.ensemble = e
    o = stump.oblivious_ensemble()
    assert (o.thr[0, 1:] == FLT_MAX).all() and float(o.thr[0, 0]) != FLT_MAX
    L = o.num_leaves
    np.testing.assert_array_equal(o.leaf[0].numpy(), [0.25] * (L // 2) + [-0.5] * (L // 2))
    ds = _port_ds(test)
    ref = score_ensemble(torch.from_numpy(ds.features), e, max_depth=p.treedepth + 1).numpy()
    np.testing.assert_allclose(stump.score_dataset(ds, device="cpu"), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_quickscore_prints_the_oblivious_path(runs, tmp_path, capsys):
    _, p, test = runs
    svml, model = os.path.join(tmp_path, "t.svml"), os.path.join(tmp_path, "m.xml")
    write_svml(_port_ds(test), svml)
    p.save(model)
    out = os.path.join(tmp_path, "scores.txt")
    assert quickscore.main(["-d", svml, "-m", model, "-r", "2", "--device", "cpu",
                            "-s", out]) == 0
    assert "Scorer path: oblivious bit-OR kernel on cpu" in capsys.readouterr().out
    np.testing.assert_array_equal(np.loadtxt(out).astype(np.float32),
                                  p.score_dataset(_port_ds(test), device="cpu"))
