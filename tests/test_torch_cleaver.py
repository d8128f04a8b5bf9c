"""The port's Cleaver (quickrank_tpu_torch/optimization/), its driver phase
and MetaCleaver against the JAX package's, on the CPU.

Both packages load one XML model, so their per-tree score matrices are
bitwise equal (K1's partial entry and the descent) and so are the
weights.  RANDOM, RANDOM_ADV, LOW_WEIGHTS, SKIP and LAST then prune JAX's
sets exactly; QUALITY_LOSS(_ADV) and SCORE_LOSS prune JAX's sets wherever
the ranked quantities are more than their tolerance apart; the metrics
before and after agree within 1e-5."""

import copy

import numpy as np
import pytest
import torch

import quickrank_tpu.learning as JL
import quickrank_tpu_torch.learning as PL
from quickrank_tpu.cli import main as jax_main
from quickrank_tpu.data.synthetic import make_train_valid_test
from quickrank_tpu.data.svml import write_svml
from quickrank_tpu.io import xml_model as jax_xml
from quickrank_tpu.metrics import Ndcg as JaxNdcg
from quickrank_tpu.optimization import cleaver as JC
from quickrank_tpu_torch.cli import main as port_main
from quickrank_tpu_torch.data.svml import read_svml
from quickrank_tpu_torch.io import xml_model
from quickrank_tpu_torch.learning import LineSearch, MetaCleaver
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.optimization import PRUNING_METHODS, Cleaver, optimization_factory
from quickrank_tpu_torch.optimization import cleaver as PC

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

EXACT = ("RANDOM", "RANDOM_ADV", "LOW_WEIGHTS", "SKIP", "LAST")
RATE = 0.25


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(24, 12, 12), avg_docs_per_query=20,
                                 num_features=10, seed=7)


@pytest.fixture(scope="module")
def model_xml(folds, tmp_path_factory):
    """A 16-tree, 8-leaf LambdaMART trained by the JAX package."""
    jm = JL.LambdaMart(ntrees=16, nleaves=8, nthresholds=32, seed=1)
    jm.learn(folds[0], None, JaxNdcg(10), verbose=False)
    path = str(tmp_path_factory.mktemp("cleaver") / "lm16.xml")
    jm.save(path)
    return path


def _both(model_xml, folds, make, **kw):
    """Optimize the same loaded model with both packages; returns
    ((jax model, info), (port model, info))."""
    train, valid, _ = folds
    j, p = JL.LTRAlgorithm.load(model_xml), LTRAlgorithm.load(model_xml)
    ji = make(JC, JL).optimize(j, train, valid, JaxNdcg(10), verbose=False, **kw)
    pi = make(PC, PL).optimize(
        p, train, valid, Ndcg(10), verbose=False, device="cpu", **kw)
    return (j, ji), (p, pi)


def _ranked(method, ev, weights, start):
    """The quantity a quality strategy ranks (JAX side), and the order."""
    base = ev.base(weights)
    if method == "SCORE_LOSS":
        return np.asarray(ev.score_loss_sums(base, weights))[start:], 1
    return np.asarray(ev.drop_one_metrics(base, weights, start)), -1


@pytest.mark.parametrize("method", PRUNING_METHODS)
def test_strategies_match_jax(method, model_xml, folds):
    (j, ji), (p, pi) = _both(model_xml, folds,
                             lambda m, _: m.Cleaver(method, RATE, seed=3))
    T = ji["num_trees_before"]
    k = int(round(RATE * T))
    assert len(pi["pruned"]) == k and p.ensemble.num_trees == T - k
    if method in EXACT or method == "QUALITY_LOSS_ADV":
        assert pi["pruned"] == ji["pruned"]
    else:
        unpruned = JL.LTRAlgorithm.load(model_xml)
        ev = JC._PartialEval(JaxNdcg(10), JC.Cleaver._partial_dataset(unpruned, folds[0]))
        vals, sign = _ranked(method, ev, np.asarray(unpruned.get_weights()), 0)
        ranked = np.sort(sign * vals)
        tol = 1e-5 * max(1.0, np.abs(vals).max())
        if ranked[k] - ranked[k - 1] > 2 * tol:
            assert pi["pruned"] == ji["pruned"]
    for key in ("metric_before", "metric_after", "metric_after_valid"):
        assert pi[key] == pytest.approx(ji[key], abs=1e-5), key
    np.testing.assert_array_equal(p.get_weights(), np.asarray(j.get_weights(), np.float32))


def test_batch_size_does_not_change_results(model_xml, folds):
    """drop_one_metrics and mask_metrics give the same bits whether each
    candidate is evaluated alone or all in one batch."""
    algo = LTRAlgorithm.load(model_xml)
    ptrain = Cleaver.partial_dataset(algo, folds[0], "cpu")
    w = algo.get_weights()
    masks = (np.random.default_rng(0).random((7, ptrain.num_features)) < 0.3).astype(np.float32)
    out = []
    for batch_bytes in (1, 1 << 30):
        ev = PC._PartialEval(Ndcg(10), ptrain, "cpu")
        ev.fold.batch_bytes = batch_bytes
        base = ev.base(w)
        out.append((ev.fold.batch_size(), ev.drop_one_metrics(base, w, 3),
                    ev.mask_metrics(base, w, masks), ev.score_loss_sums(base, w)))
    (n1, *a), (n2, *b) = out
    assert n1 == 1 and n2 >= ptrain.num_features
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_line_search_before_and_after_pruning(model_xml, folds):
    """QUALITY_LOSS with a line search before and after pruning: JAX's pruned
    set and, on these folds, its weights; the survivors are re-weighted."""
    def make(mod, learning):
        return mod.Cleaver("QUALITY_LOSS", 0.5, seed=0,
                           line_search=learning.LineSearch(max_iterations=2, num_points=10))

    (j, ji), (p, pi) = _both(model_xml, folds, make)
    assert pi["pruned"] == ji["pruned"] and p.ensemble.num_trees == 8
    assert pi["metric_after"] == pytest.approx(ji["metric_after"], abs=1e-2)
    w = p.get_weights()
    assert not np.allclose(w, w[0])
    np.testing.assert_allclose(w, np.asarray(j.get_weights()), rtol=0, atol=1e-2)


def test_loaded_line_search_weights_are_reused(model_xml, folds):
    """A line search that already has weights is not run again: its weights
    are rescaled to the model's magnitude (cleaver.cc:265-291), and a size
    mismatch is refused in JAX's words."""
    T = 16
    lw = np.linspace(0.5, 2.0, T)

    def make(mod, learning, size=T):
        ls = learning.LineSearch(max_iterations=2)
        ls.update_weights(lw[:size] if size <= T else np.ones(size))
        return mod.Cleaver("LOW_WEIGHTS", 0.25, line_search=ls)

    (_, ji), (_, pi) = _both(model_xml, folds, make)
    assert pi["pruned"] == ji["pruned"] == [0, 1, 2, 3]
    messages = []
    for mod, learning, metric, kw in ((JC, JL, JaxNdcg(10), {}),
                                      (PC, PL, Ndcg(10), {"device": "cpu"})):
        algo = (JL.LTRAlgorithm if mod is JC else LTRAlgorithm).load(model_xml)
        with pytest.raises(ValueError, match="--line-search-model") as e:
            make(mod, learning, T + 3).optimize(algo, folds[0], None, metric, verbose=False,
                                                **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_optimizer_xml_across_packages(tmp_path):
    """An optimizer model saved by either package loads in the other, and
    both write the same bytes given the same weights."""
    w = np.random.default_rng(2).random(12)
    pc = Cleaver("SCORE_LOSS", 0.3, line_search=LineSearch(num_points=10, adaptive=True))
    jc = JC.Cleaver("SCORE_LOSS", 0.3, line_search=JL.LineSearch(num_points=10, adaptive=True))
    for c in (pc, jc):
        c.update_weights(w)
        c.line_search.update_weights(np.ones(3))
    ppath, jpath = str(tmp_path / "port.xml"), str(tmp_path / "jax.xml")
    pc.save(ppath)
    jc.save(jpath)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    for loaded in (JC.Cleaver.load(ppath), Cleaver.load(jpath)):
        assert (loaded.pruning_method, loaded.pruning_rate) == ("SCORE_LOSS", 0.3)
        assert loaded.line_search.num_points == 10 and loaded.line_search.adaptive
        np.testing.assert_allclose(loaded.weights_, w.astype(np.float32), rtol=1e-6)
    ranker = LineSearch()
    ranker.update_weights(np.ones(2))
    ranker.save(str(tmp_path / "ls.xml"))
    with pytest.raises(ValueError, match="not an optimizer model"):
        Cleaver.load(str(tmp_path / "ls.xml"))


def test_optimization_factory():
    c = optimization_factory("CLEAVER", "LAST", 3, with_line_search=True,
                             line_search_kwargs=dict(num_points=8, max_iterations=4), seed=5)
    assert (c.pruning_method, c.pruning_rate, c.seed) == ("LAST", 3.0, 5)
    assert (c.line_search.num_points, c.line_search.max_iterations) == (8, 4)
    assert optimization_factory().line_search is None
    ls = LineSearch()
    assert optimization_factory(line_search=ls).line_search is ls
    with pytest.raises(ValueError, match="unknown optimization algorithm"):
        optimization_factory("NOPE")
    with pytest.raises(ValueError, match="unknown pruning method"):
        optimization_factory(opt_method="NOPE")
    assert len(PRUNING_METHODS) == 8


def test_driver_partial_and_opt_model_flow(tmp_path, folds):
    """--train-partial writes and then reuses the per-tree SVML, --opt-model
    saves the optimizer, --opt-algo-model the pruned model (the bytes of the
    JAX CLI's from the same model), and a second run applies --opt-model as
    input without --opt-algo (driver.cc:270-324)."""
    train, valid, _ = folds
    d = tmp_path
    write_svml(train, str(d / "tr.svml"))
    write_svml(valid, str(d / "va.svml"))
    assert jax_main(["--algo", "LAMBDAMART", "--train", str(d / "tr.svml"), "--num-trees", "8",
                     "--num-leaves", "4", "--num-thresholds", "16", "--quiet",
                     "--model-out", str(d / "model.xml")]) == 0
    opt = ["--algo", "LAMBDAMART", "--model-in", str(d / "model.xml"), "--skip-train",
           "--train", str(d / "tr.svml"), "--valid", str(d / "va.svml"), "--quiet",
           "--opt-algo", "EPRUNING", "--opt-method", "QUALITY_LOSS", "--pruning-rate", "0.5"]
    for main, tag, dev in ((jax_main, "jax", []), (port_main, "port", ["--device", "cpu"])):
        assert main(opt + dev + [
            "--train-partial", str(d / f"{tag}.ptrain.svml"),
            "--valid-partial", str(d / f"{tag}.pvalid.svml"),
            "--opt-model", str(d / f"{tag}.opt.xml"),
            "--opt-algo-model", str(d / f"{tag}.pruned.xml")]) == 0
    for name in ("pruned.xml", "opt.xml"):
        assert (d / f"port.{name}").read_bytes() == (d / f"jax.{name}").read_bytes(), name
    pruned = LTRAlgorithm.load(str(d / "port.pruned.xml"))
    assert pruned.ensemble.num_trees == 4
    pt = read_svml(str(d / "port.ptrain.svml"))
    assert (pt.num_features, pt.num_docs) == (8, train.num_docs)
    np.testing.assert_array_equal(pt.features, read_svml(str(d / "jax.ptrain.svml")).features)

    # again: the partial file is read back and --opt-model is the input
    assert port_main(["--algo", "LAMBDAMART", "--model-in", str(d / "model.xml"),
                      "--skip-train", "--train", str(d / "tr.svml"),
                      "--train-partial", str(d / "port.ptrain.svml"),
                      "--opt-model", str(d / "port.opt.xml"),
                      "--opt-algo-model", str(d / "pruned2.xml"), "--quiet",
                      "--device", "cpu"]) == 0
    assert LTRAlgorithm.load(str(d / "pruned2.xml")).ensemble.num_trees <= 8


@pytest.mark.parametrize("learner,with_ls", [("Mart", False), ("Mart", True),
                                             ("LambdaMart", False)],
                         ids=["mart", "mart-linesearch", "lambdamart"])
def test_meta_cleaver_matches_jax(folds, tmp_path, learner, with_ls):
    """Two meta-rounds of 4 trees grown and half pruned: the same sizes, the
    metrics within 1e-5, the same final weights (the grown trees are
    JAX's on these folds: MART's gradients and, here, LambdaMART's are the
    same), and the composite XML loads in the other package."""
    train, valid, _ = folds
    kw = dict(ntrees=4, nleaves=8, nthresholds=32, seed=1)
    runs = []
    for jax_side in (True, False):
        learning, opt = (JL, JC) if jax_side else (PL, PC)
        ls = learning.LineSearch(max_iterations=2, num_points=10) if with_ls else None
        meta = learning.MetaCleaver(getattr(learning, learner)(**kw),
                                    opt.Cleaver("QUALITY_LOSS", line_search=ls),
                                    final_ntrees=4, ntrees_per_iter=4)
        dev = {} if jax_side else {"device": "cpu"}
        runs.append((meta, meta.learn(train, valid, (JaxNdcg if jax_side else Ndcg)(10),
                                      verbose=False, **dev)))
    (jm, jh), (pm, ph) = runs
    assert [h["size"] for h in ph["iterations"]] == [h["size"] for h in jh["iterations"]] == [2, 4]
    for a, b in zip(ph["iterations"], jh["iterations"]):
        assert a["train"] == pytest.approx(b["train"], abs=1e-5)
        assert a["valid"] == pytest.approx(b["valid"], abs=1e-5)
    np.testing.assert_array_equal(pm.get_weights(), np.asarray(jm.get_weights(), np.float32))
    path = str(tmp_path / "meta.xml")
    pm.save(path)
    back = jax_xml.load_model(path)
    assert type(back) is JL.MetaCleaver and back.ntrees_per_iter == 4
    jpath = str(tmp_path / "jmeta.xml")
    jm.save(jpath)
    loaded = xml_model.load_model(jpath)
    assert type(loaded) is MetaCleaver and loaded.final_ntrees == 4
    want = np.asarray(jm.score_dataset(folds[2]))
    np.testing.assert_allclose(loaded.score_dataset(folds[2], device="cpu"), want, rtol=0,
                               atol=2e-6 * max(1.0, np.abs(want).max()))


def test_mesh_refused(model_xml, folds):
    algo = LTRAlgorithm.load(model_xml)
    with pytest.raises(NotImplementedError, match="DataGroup .* or a parallel.mesh.Mesh2D"):
        Cleaver().optimize(algo, folds[0], mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="DataGroup .* or a parallel.mesh.Mesh2D"):
        MetaCleaver(copy.deepcopy(algo), Cleaver()).learn(folds[0], mesh=object(), device="cpu")
