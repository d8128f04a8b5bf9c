"""Training at more than 255 thresholds in the port against the JAX package
on the CPU: the u16 bin wire (u8 up to 256 bins, u16 up to 65,536, int32
beyond, JAX's ``learning/mart.py`` wire) through the growers, the learners
and the plain histograms.

The contract is the one held at 255 thresholds: the bins are JAX's bit for
bit; given JAX's gradients every grower builds JAX's tree node for node;
three iterations of LambdaMART (best, best-k, level-wise) and of the
oblivious learner reach NDCG@10 within 1e-4 of JAX's; RankBoost picks JAX's
weak rankers; the warm-start rescore equals the carried scores bit for bit.
Every torch reader of the bin matrix gives the same result on the u16 wire
as on an int32 copy of it (torch's uint16 has no compare, gather or index
kernels: ``ops/binning.py`` reads its int16 bits).  The data have more than
1,024 distinct values in every feature, so 1,023 thresholds give 1,024
bins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data.synthetic import make_ranking_dataset as jax_make
from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.learning.obliviousmart import ObliviousLambdaMart as JaxObliviousLambdaMart
from quickrank_tpu.learning.rankboost import RankBoost as JaxRankBoost
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu.ops.scoring import descend_tree_binned_matmul as jax_descend_matmul
from quickrank_tpu.trees import grow as jax_grow
from quickrank_tpu.trees import oblivious as jax_obl
from quickrank_tpu.trees.grow_bestk import fit_tree_bestk as jax_fit_tree_bestk
from quickrank_tpu.trees.grow_level import fit_tree_levelwise as jax_fit_level
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning import mart as port_mart
from quickrank_tpu_torch.learning.dart import Dart
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.mart import TrainData, rescore_binned
from quickrank_tpu_torch.learning.obliviousmart import ObliviousLambdaMart
from quickrank_tpu_torch.learning.rankboost import RankBoost
from quickrank_tpu_torch.metrics.metrics import Ndcg
from quickrank_tpu_torch.ops import binning, kernel_histogram
from quickrank_tpu_torch.ops.histogram import masked_histogram_scatter, node_histograms_scatter
from quickrank_tpu_torch.ops.scoring import descend_tree_binned
from quickrank_tpu_torch.trees import grow
from quickrank_tpu_torch.trees import oblivious as obl
from quickrank_tpu_torch.trees import qs
from quickrank_tpu_torch.trees.grow_bestk import fit_tree_bestk
from quickrank_tpu_torch.trees.grow_level import fit_tree_levelwise
from quickrank_tpu_torch.trees.structs import EnsembleTensors

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

NTHR = 1023
NODE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf")


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def folds():
    """60 train and 20 valid queries of 12 features: 3,004 train docs, every
    feature with more than 1,024 distinct values (all but the 4,095 case
    take an equi-width table)."""
    return (jax_make(num_queries=60, avg_docs_per_query=40, num_features=12, seed=21),
            jax_make(num_queries=20, avg_docs_per_query=40, num_features=12, seed=22))


@pytest.fixture(scope="module")
def given(folds):
    """JAX's TrainData at 1,023 and 4,095 thresholds, each with JAX's own
    LambdaMART gradients at random scores and a sampled doc mask, and their
    torch tensors."""
    out = {}
    for nthr in (NTHR, 4095):
        jtr = JaxTrainData.build(folds[0], nthr)
        N = jtr.padded.num_docs_padded
        rng = np.random.default_rng(nthr)
        scores = jnp.asarray(rng.normal(size=N).astype(np.float32)) * jtr.step.doc_mask
        lm = JaxLambdaMart()
        lm._train_metric = JaxNdcg(10)
        lam, w = lm._gradients(jtr.step, scores, jtr.step.doc_mask, None)
        smask = np.asarray(jtr.step.doc_mask) & (rng.uniform(size=N) < 0.85)
        t = torch.from_numpy
        port = dict(binned=t(np.asarray(jtr.step.binned)), grad=t(np.asarray(lam)),
                    weights=t(np.asarray(w)), mask=t(smask),
                    thresholds=t(np.asarray(jtr.step.thresholds)))
        out[nthr] = (jtr, lam, w, jnp.asarray(smask), port)
    return out


@pytest.mark.parametrize("nthr", [NTHR, 4095])
def test_wire_and_bins_are_jax(folds, nthr):
    """TrainData builds JAX's u16 wire and its bins bit for bit, on the
    train fold and on the valid fold binned with the train tables."""
    train, valid = folds
    jtr = JaxTrainData.build(train, nthr)
    tr = TrainData.build(_port_ds(train), nthr, device="cpu")
    assert tr.num_bins == jtr.num_bins >= 1024
    assert tr.step.binned.dtype == torch.uint16 and np.asarray(jtr.step.binned).dtype == np.uint16
    np.testing.assert_array_equal(tr.step.binned.numpy(), np.asarray(jtr.step.binned))
    jthr = np.asarray(jtr.step.thresholds)
    np.testing.assert_array_equal(tr.thresholds, jthr)
    jva = JaxTrainData.build(valid, nthr, thresholds=jthr[: valid.num_features])
    va = port_mart.build_valid_traindata(tr, _port_ds(valid), nthr, "cpu")
    assert va.step.binned.dtype == torch.uint16
    np.testing.assert_array_equal(va.step.binned.numpy(), np.asarray(jva.step.binned))


def test_wire_dtype_follows_the_bin_count():
    """u8 up to 256 bins, u16 up to 65,536, int32 beyond."""
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    assert [binning.bin_wire(ids, b).dtype for b in (2, 256, 257, 65536, 65537)] == [
        np.uint8, np.uint8, np.uint16, np.uint16, np.int32]


def _assert_same_tree(jtree, tree, jnode, node):
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(tree, k).numpy(), np.asarray(getattr(jtree, k)), k)
    np.testing.assert_array_equal(node.numpy(), np.asarray(jnode))
    np.testing.assert_allclose(tree.leaf_value.numpy(), np.asarray(jtree.leaf_value),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("nthr", [NTHR, 4095])
@pytest.mark.parametrize("grower", ["best", "bestk", "level", "oblivious"])
def test_growers_given_jax_gradients_grow_jax_trees(given, grower, nthr):
    """Each grower on the u16 wire, given JAX's gradients, builds JAX's tree
    node for node (routing included; leaf values within 1e-6)."""
    jtr, lam, w, smask, p = given[nthr]
    B = jtr.num_bins
    jargs = (jtr.step.binned, lam, smask, jtr.step.thresholds)
    args = (p["binned"], p["grad"], p["mask"], p["thresholds"])
    if grower == "oblivious":
        jf, jt, jb, jn = jax_obl.fit_oblivious_tree(*jargs, 4)
        fid, thr, tbin, node = obl.fit_oblivious_tree(*args, 4)
        for a, b in ((fid, jf), (thr, jt), (tbin, jb), (node, jn)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(fid.unique().numel()) > 1
        return
    jcfg = jax_grow.GrowConfig(nleaves=16, min_leaf_support=1, num_bins=B, newton=True,
                               max_depth=4 if grower == "level" else 0)
    cfg = grow.GrowConfig(nleaves=16, min_leaf_support=1, num_bins=B, newton=True,
                          max_depth=4 if grower == "level" else 0)
    if grower == "best":
        jtree, jnode = jax_grow.fit_tree(*jargs, jcfg)
        tree, node = grow.fit_tree(*args, cfg)
    elif grower == "bestk":
        jtree, jnode = jax_fit_tree_bestk(*jargs, jcfg, 4)
        tree, node = fit_tree_bestk(*args, cfg, 4)
    else:
        jtree, jnode = jax_fit_level(*jargs, 4, jcfg, weights=w)
        tree, node = fit_tree_levelwise(*args, 4, cfg, weights=p["weights"])
    if grower != "level":
        jtree = jax_grow.leaf_outputs(jtree, jnode, lam, smask, weights=w)
        tree = grow.leaf_outputs(tree, node, p["grad"], p["mask"], weights=p["weights"])
    assert int((~tree.is_leaf).sum()) >= 8
    _assert_same_tree(jtree, tree, jnode, node)


CONFIGS = {
    "best": (JaxLambdaMart, LambdaMart, dict(growth="best")),
    "bestk": (JaxLambdaMart, LambdaMart, dict(growth="bestk")),
    "level": (JaxLambdaMart, LambdaMart, dict(growth="level", max_depth=4)),
    "oblivious": (JaxObliviousLambdaMart, ObliviousLambdaMart, dict(treedepth=4)),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request, folds):
    """Three iterations at 1,023 thresholds, JAX's and the port's."""
    jcls, pcls, kw = CONFIGS[request.param]
    kw = dict(kw, ntrees=3, nthresholds=NTHR, seed=1)
    if request.param != "oblivious":
        kw["nleaves"] = 16
    train, valid = folds
    j = jcls(**kw)
    j.learn(train, valid, JaxNdcg(10), verbose=False)
    p = pcls(**kw)
    p.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False, device="cpu")
    return j, p


def test_three_iterations_track_jax(runs):
    """Train and valid NDCG@10 within 1e-4 of JAX's at every iteration, and
    the first tree's splits equal."""
    j, p = runs
    for key in ("train", "valid"):
        a, b = np.array(j.history[key]), np.array(p.history[key])
        assert len(a) == len(b) == 3
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
    for k in ("feature", "threshold_bin"):
        np.testing.assert_array_equal(getattr(p.ensemble, k)[0].numpy(),
                                      np.asarray(getattr(j.ensemble, k))[0], k)
    assert int(p.ensemble.threshold_bin[0].max()) > 255


def test_descent_on_u16_equals_jax_matmul_descent(given):
    """``descend_tree_binned`` on the u16 wire routes as JAX's
    ``descend_tree_binned_matmul`` on it (its float32 dot path,
    ``tests/test_trees.py``'s u16 case), and as JAX's gather descent."""
    jtr, lam, w, smask, p = given[NTHR]
    jcfg = jax_grow.GrowConfig(nleaves=16, min_leaf_support=1, num_bins=jtr.num_bins)
    jtree, _ = jax_grow.fit_tree(jtr.step.binned, lam, smask, jtr.step.thresholds, jcfg)
    tree, _ = grow.fit_tree(p["binned"], p["grad"], p["mask"], p["thresholds"],
                            grow.GrowConfig(nleaves=16, min_leaf_support=1,
                                            num_bins=jtr.num_bins))
    want = np.asarray(jax_descend_matmul(jtr.step.binned, jtree, 16))
    got = descend_tree_binned(p["binned"], tree, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 16


def test_warm_start_rescore_equals_the_carry(folds):
    """A model trained at 1,023 thresholds, rescored on the u16 wire
    (``rescore_binned``: the bin-space descent on the CPU), gives the
    scores training carried bit for bit, and a warm start continues it."""
    ds = _port_ds(folds[0])
    lm = LambdaMart(ntrees=3, nleaves=16, nthresholds=NTHR, seed=1)
    lm.learn(ds, None, Ndcg(10), verbose=False, device="cpu")
    tr = TrainData.build(ds, NTHR, device="cpu")
    got = rescore_binned(lm.ensemble.live(), tr.step, lm._descend_depth())
    assert torch.equal(got, lm.train_scores)
    lm.ntrees = 5
    hist = lm.learn(ds, None, Ndcg(10), verbose=False, device="cpu", warm_start=True)
    assert lm.ensemble.num_trees == 5 and len(hist["train"]) == 2


def test_rankboost_weak_rankers_match_jax(folds):
    """Ten rounds at 1,023 thresholds: JAX's weak rankers (feature,
    threshold), alphas within 1e-5 relative."""
    train, valid = folds
    j = JaxRankBoost(ntrees=10, nthresholds=NTHR)
    j.learn(train, valid, JaxNdcg(10), verbose=False)
    p = RankBoost(ntrees=10, nthresholds=NTHR)
    p.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False, device="cpu")
    np.testing.assert_array_equal(p.features_, j.features_)
    np.testing.assert_array_equal(p.thetas_, j.thetas_)
    np.testing.assert_allclose(p.alphas_, j.alphas_, rtol=1e-5)


def _readers():
    """name -> f(binned, p): each plain torch reader of the bin matrix, over
    the given problem's tensors (``p["tree"]`` and ``p["tables"]`` grown on
    the int32 copy)."""
    def B(p):
        return int(p["thresholds"].shape[1])

    def hist_fixed(b, p):
        vt = torch.stack([p["mask"].float(), p["grad"] * p["mask"]])
        bits = kernel_histogram.channel_max_bits(vt)
        return kernel_histogram.node_histogram_fixed_int(
            b, vt, (p["grad"] > 0).to(torch.int32), B(p), 0, 2, bits, b.shape[0])

    return {
        "node_histograms_scatter": lambda b, p: node_histograms_scatter(
            b, torch.stack([p["grad"], p["grad"] ** 2], -1), (p["grad"] > 0).long(),
            p["mask"], 2, B(p)),
        "masked_histogram_scatter": lambda b, p: masked_histogram_scatter(
            b, p["grad"][:, None], p["mask"], B(p)),
        "node_histogram_fixed_int": hist_fixed,
        "descend_tree_binned": lambda b, p: descend_tree_binned(b, p["tree"], 16),
        "score_qs_plain": lambda b, p: qs.score_qs(binning.scorer_rows(b), p["tables"]),
        "partial_scores_qs_plain": lambda b, p: qs.partial_scores_qs(
            binning.scorer_rows(b), p["tables"]),
    }


@pytest.mark.parametrize("name", list(_readers()))
def test_readers_on_u16_equal_int32(given, name):
    """The plain readers on the u16 wire equal their result on an int32 copy
    of the same ids, bit for bit."""
    p = dict(given[NTHR][4])
    u16 = p["binned"]
    i32 = binning.widen(u16)
    assert u16.dtype == torch.uint16 and i32.dtype == torch.int32
    cfg = grow.GrowConfig(nleaves=16, num_bins=int(p["thresholds"].shape[1]))
    tree, node = grow.fit_tree(i32, p["grad"], p["mask"], p["thresholds"], cfg)
    p["tree"] = grow.leaf_outputs(tree, node, p["grad"], p["mask"])
    ens = EnsembleTensors.empty(3, p["tree"].max_nodes)
    ens.push(p["tree"], 0.5)
    ens.push(p["tree"], 0.25)
    p["tables"] = qs.ensemble_to_qs(ens, space="bin")
    fn = _readers()[name]
    a, b = fn(u16, p), fn(i32, p)
    assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool((a != 0).any())


LEARNERS = {
    "best": lambda: LambdaMart(ntrees=3, nleaves=16, nthresholds=NTHR, seed=1),
    "bestk": lambda: LambdaMart(ntrees=3, nleaves=16, nthresholds=NTHR, seed=1,
                                growth="bestk"),
    "level": lambda: LambdaMart(ntrees=3, nleaves=16, nthresholds=NTHR, seed=1,
                                growth="level", max_depth=4),
    "collapse": lambda: LambdaMart(ntrees=3, nleaves=16, nthresholds=NTHR, seed=1,
                                   collapse_leaves_factor=0.5),
    "oblivious": lambda: ObliviousLambdaMart(ntrees=3, treedepth=4, nthresholds=NTHR,
                                             seed=1),
    "dart": lambda: Dart(ntrees=4, nleaves=8, nthresholds=NTHR, rate_drop=0.5, seed=1),
    "rankboost": lambda: RankBoost(ntrees=6, nthresholds=NTHR),
}


def _model_bytes(m):
    if isinstance(m, RankBoost):
        return [np.asarray(x).tobytes() for x in (m.features_, m.thetas_, m.alphas_)]
    return [getattr(m.ensemble, k).numpy().tobytes()
            for k in ("feature", "threshold_bin", "leaf_value", "weight")]


@pytest.mark.parametrize("name", list(LEARNERS))
def test_learners_on_u16_equal_int32_wire(folds, name, monkeypatch):
    """Every learner trains the same model, bit for bit, on the u16 wire and
    on an int32 wire of the same ids (``bin_wire`` forced to int32): the
    growers, the valid-fold descent, the leaf collapse, the oblivious
    learner, DART's bin-space scoring and RankBoost's weak-ranker column."""
    train, valid = (_port_ds(f) for f in folds)
    runs = []
    for wide in (False, True):
        if wide:
            monkeypatch.setattr(binning, "bin_wire", lambda b, nb: b.astype(np.int32))
        m = LEARNERS[name]()
        h = m.learn(train, valid, Ndcg(10), verbose=False, device="cpu")
        runs.append((m, h))
    (a, ha), (b, hb) = runs
    assert _model_bytes(a) == _model_bytes(b)
    assert ha["train"] == hb["train"] and ha["valid"] == hb["valid"]
    if name == "dart":
        assert ha["dropped"] == hb["dropped"] and any(ha["dropped"])


def test_quicklearn_trains_at_1023_thresholds(folds, tmp_path):
    """quicklearn --num-thresholds 1023 trains and saves on the u16 wire, and
    the saved model scores the train file as the trained model does."""
    from quickrank_tpu_torch import cli
    from quickrank_tpu_torch.data.svml import write_svml
    from quickrank_tpu_torch.learning.base import LTRAlgorithm

    svml, model = str(tmp_path / "train.svml"), str(tmp_path / "m.xml")
    write_svml(_port_ds(folds[0]), svml)
    rc = cli.main(["--algo", "LAMBDAMART", "--train", svml, "--num-trees", "2",
                   "--num-leaves", "8", "--num-thresholds", "1023", "--model-out", model,
                   "--device", "cpu", "--quiet"])
    assert rc == 0
    m = LTRAlgorithm.load(model)
    assert m.ensemble.num_trees == 2 and m.nthresholds == 1023
    assert np.isfinite(m.score_dataset(_port_ds(folds[0]), device="cpu")).all()
