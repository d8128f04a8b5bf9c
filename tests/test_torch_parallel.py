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
  * the multi-host data path (each rank keeps its own query block);
  * DART (UNIFORM / TREE, and a run sampling by WCONTR),
    CoordinateAscent, LineSearch, Cleaver (QUALITY_LOSS_ADV with a line
    search before and after) and MetaCleaver over MART, each held against
    JAX's run on ``make_mesh(2)`` and against the port's single-device run:
    the linear rankers and Cleaver bit for bit (every metric is reduced in
    one global query order), DART and MetaCleaver within
    ``tests/test_sharding.py``'s tolerances (their trees come from the CPU's
    float histograms, which two shards sum in another order than one).

Every rank must return the same model, byte for byte.  A rank that raises
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
from quickrank_tpu import learning as JL
from quickrank_tpu.learning import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning import ObliviousLambdaMart as JaxObliviousLambdaMart
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.metrics import Ndcg as JaxNdcg
from quickrank_tpu.parallel import multihost as jax_multihost
from quickrank_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quickrank_tpu.parallel.mesh import shard_map, step_data_specs
from quickrank_tpu.trees.grow import leaf_outputs as jax_leaf_outputs
from quickrank_tpu_torch import learning as PL
from quickrank_tpu_torch.data.dataset import Dataset, shard_and_pad
from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.ops.binning import build_thresholds
from quickrank_tpu_torch.ops.histogram import scale_doc_count
from quickrank_tpu_torch.parallel import multihost
from quickrank_tpu_torch.parallel.mesh import BlockOrder
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


#: the learners of ROADMAP §A 10b parts 1-2 in the launch: name -> (class
#: name, constructor kwargs; Cleaver's and MetaCleaver's are built by
#: :func:`_build`).  The DART runs drop trees from their third iteration and
#: their draws need no ``jax.random`` (subsample 1); the second samples by
#: WCONTR, so the contributions cross ranks.  X-DART's keep decisions are left
#: to the card (``chip_smoke.py`` phase 35): on the CPU two shards' float
#: histograms flip them at these folds, in JAX's runs too
LEARNERS = {
    "dart": ("Dart", dict(ntrees=5, nleaves=8, nthresholds=NTHR, rate_drop=0.25, seed=7)),
    "dart-wcontr": ("Dart", dict(ntrees=5, nleaves=8, nthresholds=NTHR, rate_drop=0.5,
                                 seed=1, sample_type="WCONTR")),
    "coordasc": ("CoordinateAscent", dict(num_points=8, max_iterations=2)),
    "linesearch": ("LineSearch", dict(num_points=8, max_iterations=3)),
    "cleaver": ("Cleaver", dict(pruning_method="QUALITY_LOSS_ADV", pruning_rate=0.25,
                                seed=3, line_search=dict(num_points=8, max_iterations=3))),
    "metacleaver": ("MetaCleaver", dict(
        ltr_algo=dict(learner="Mart", kwargs=dict(ntrees=4, nleaves=8, nthresholds=NTHR,
                                                  seed=1)),
        cleaver=dict(pruning_method="QUALITY_LOSS", line_search=None),
        final_ntrees=8, ntrees_per_iter=4)),
}


def _build(pkg, opt, name):
    """LEARNERS[name] built from the JAX package (``pkg``, ``opt``) or the
    port's."""
    cls, kw = LEARNERS[name]
    kw = dict(kw)
    if cls == "Cleaver":
        ls = kw.pop("line_search")
        return opt.Cleaver(line_search=pkg.LineSearch(**ls), **kw)
    if cls == "MetaCleaver":
        inner, cl = kw.pop("ltr_algo"), kw.pop("cleaver")
        return pkg.MetaCleaver(getattr(pkg, inner["learner"])(**inner["kwargs"]),
                               opt.Cleaver(**cl), **kw)
    return getattr(pkg, cls)(**kw)


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
def cleaver_model(folds, tmp_path_factory):
    """The model Cleaver prunes: 8 port LambdaMART trees, saved as XML (both
    packages load it; their per-tree matrices are equal bit for bit)."""
    lm = LambdaMart(ntrees=8, nleaves=8, nthresholds=NTHR, seed=1)
    lm.learn(_port_ds(folds[0]), _port_ds(folds[1]), Ndcg(10), verbose=False, device="cpu")
    path = str(tmp_path_factory.mktemp("cleaver") / "lm.xml")
    lm.save(path)
    return path


@pytest.fixture(scope="module")
def port_ranks(folds, given, cleaver_model, tmp_path_factory):
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
    n_growth = len(jobs)
    for name, (cls, kw) in LEARNERS.items():
        if cls == "Cleaver":
            jobs.append(("optimize_rank", dict(model=cleaver_model, cleaver=kw, train=train,
                                               valid=valid)))
        else:
            jobs.append(("train_rank", dict(learner=cls, kwargs=kw, train=train,
                                            valid=valid)))
    t0 = time.monotonic()
    out = run_ranks(batch_rank, SHARDS, args=(jobs,), device="cpu", deadline=DEADLINE)
    assert time.monotonic() - t0 < DEADLINE
    by_growth = {g: ([r[2 * i] for r in out], [r[2 * i + 1] for r in out])
                 for i, g in enumerate(GROWERS)}
    learners = {name: [r[n_growth + i] for r in out] for i, name in enumerate(LEARNERS)}
    return by_growth, [r[n_growth - 2] for r in out], [r[n_growth - 1] for r in out], learners


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


def _drawn_dart(dart):
    """Record the dropped set a JAX ``Dart`` draws each iteration (its
    history has none)."""
    drawn = []
    count, select = dart._trees_to_dropout, dart._select_dropout

    def trees_to_dropout(*a):
        drawn.append([])
        return count(*a)

    def select_dropout(*a):
        drawn[-1] = select(*a)
        return drawn[-1]

    dart._trees_to_dropout, dart._select_dropout = trees_to_dropout, select_dropout
    return drawn


def _learner_run(pkg, opt, name, folds, model_path, **learn):
    """(result, model) of LEARNERS[name] run by the JAX package or the port
    on the module's folds; Cleaver prunes ``model_path``'s model."""
    obj = _build(pkg, opt, name)
    train, valid = folds[0], folds[1]
    metric = (JaxNdcg if pkg is JL else Ndcg)(10)
    if name == "cleaver":
        model = (JaxLTRAlgorithm if pkg is JL else LTRAlgorithm).load(model_path)
        info = obj.optimize(model, train, valid, metric, verbose=False, **learn)
        return {"info": info, "weights": obj.weights_}, obj
    drawn = _drawn_dart(obj) if pkg is JL and LEARNERS[name][0] == "Dart" else None
    hist = obj.learn(train, valid, metric, verbose=False, **learn)
    if drawn is not None:
        hist = dict(hist, dropped=drawn)
    out = {"history": hist}
    if hasattr(obj, "best_weights"):
        out["weights"] = np.asarray(obj.get_weights())
    return out, obj


@pytest.fixture(scope="module")
def jax_learner_runs(folds, cleaver_model):
    """JAX's runs of LEARNERS on ``make_mesh(2)``."""
    from quickrank_tpu import optimization

    return {name: _learner_run(JL, optimization, name, folds, cleaver_model,
                               mesh=jax_make_mesh(SHARDS))
            for name in LEARNERS}


@pytest.fixture(scope="module")
def port_unsharded(folds, cleaver_model):
    """The port's single-device runs of LEARNERS on the CPU."""
    from quickrank_tpu_torch import optimization

    pf = tuple(_port_ds(f) for f in folds)
    # one intra-op thread, as each rank has (parallel/launch.py): a step is
    # thousands of small ops, which a thread pool on a loaded host slows down
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: _learner_run(PL, optimization, name, pf, cleaver_model, device="cpu")
                for name in LEARNERS}
    finally:
        torch.set_num_threads(threads)


def _model_bytes(result) -> dict:
    """A rank's model as bytes: its trees or its weights."""
    if "trees" in result:
        return {k: np.asarray(v).tobytes() for k, v in result["trees"].items()}
    return {"weights": np.asarray(result["weights"]).tobytes()}


@pytest.mark.parametrize("name", list(LEARNERS))
def test_learner_ranks_hold_the_same_model(port_ranks, name):
    """Every rank returns the same model (trees or weights) byte for byte,
    the same history (metrics, dropped sets) and Cleaver's pruned set."""
    runs = port_ranks[3][name]
    for other in runs[1:]:
        assert _model_bytes(other) == _model_bytes(runs[0])
        if name == "cleaver":
            assert other["info"]["pruned"] == runs[0]["info"]["pruned"]
            assert other["info"]["metric_after"] == runs[0]["info"]["metric_after"]
        else:
            for k in ("train", "valid", "dropped", "iterations"):
                assert other["history"].get(k) == runs[0]["history"].get(k), k


@pytest.mark.parametrize("name", list(LEARNERS))
def test_learner_matches_jax_sharded_run(port_ranks, jax_learner_runs, name):
    """Two gloo ranks against JAX's run on ``make_mesh(2)``, with
    ``tests/test_sharding.py``'s tolerances: DART the same dropped sets and
    NDCG@10 within 1e-3; the linear rankers within 2e-3, weights within
    1e-4; Cleaver the same pruned set, weights within 1e-4; MetaCleaver
    (over MART, whose gradients both packages compute alike) the same
    sizes, NDCG@10 within 1e-5 and the same weights."""
    got = port_ranks[3][name][0]
    want, jmodel = jax_learner_runs[name]
    if name == "cleaver":
        assert got["info"]["pruned"] == want["info"]["pruned"]
        np.testing.assert_allclose(got["weights"], want["weights"], atol=1e-4)
        assert abs(got["info"]["metric_after"] - want["info"]["metric_after"]) < 2e-3
        return
    g, w = got["history"], want["history"]
    if name == "metacleaver":
        assert [h["size"] for h in g["iterations"]] == [h["size"] for h in w["iterations"]]
        for a, b in zip(g["iterations"], w["iterations"]):
            assert a["train"] == pytest.approx(b["train"], abs=1e-5)
            assert a["valid"] == pytest.approx(b["valid"], abs=1e-5)
        np.testing.assert_array_equal(got["trees"]["weight"],
                                      np.asarray(jmodel.get_weights(), np.float32))
        return
    dart = LEARNERS[name][0] == "Dart"
    tol = 1e-3 if dart else 2e-3
    np.testing.assert_allclose(g["train"], w["train"], atol=tol)
    np.testing.assert_allclose(g["valid"], w["valid"], atol=tol)
    if dart:
        assert g["dropped"] == w["dropped"]
        assert any(g["dropped"])
    else:
        np.testing.assert_allclose(got["weights"], want["weights"], atol=1e-4)


@pytest.mark.parametrize("name", list(LEARNERS))
def test_learner_two_ranks_match_one(port_ranks, port_unsharded, name):
    """Two gloo ranks against the port's single-device run: the linear
    rankers and Cleaver bit for bit (weights, metrics, pruned set: every
    metric is one rank's through the gathered per-query reduction); DART
    the same dropped sets and NDCG@10 within 1e-3, MetaCleaver the same
    sizes and the last train NDCG@10 within ``tests/test_sharding.py``'s
    1e-2 (on the CPU two shards' float histograms add in another order than
    one's; on the card they are int64 sums and the runs are equal bit for
    bit, ``chip_smoke.py`` phases 35-36)."""
    got = port_ranks[3][name][0]
    want, _ = port_unsharded[name]
    if name == "cleaver":
        assert got["info"]["pruned"] == want["info"]["pruned"]
        assert got["info"]["metric_after"] == want["info"]["metric_after"]
        assert np.asarray(got["weights"]).tobytes() == np.asarray(want["weights"]).tobytes()
        return
    g, w = got["history"], want["history"]
    if name == "metacleaver":
        # JAX's own runs differ as much: QUALITY_LOSS prunes other trees of
        # MART's tied few-leaf trees once their leaf values move a last bit
        assert [h["size"] for h in g["iterations"]] == [h["size"] for h in w["iterations"]]
        assert g["iterations"][-1]["train"] == pytest.approx(
            w["iterations"][-1]["train"], abs=1e-2)
        return
    if LEARNERS[name][0] == "Dart":
        assert g["dropped"] == w["dropped"]
        np.testing.assert_allclose(g["train"], w["train"], atol=1e-3)
        np.testing.assert_allclose(g["valid"], w["valid"], atol=1e-3)
        return
    assert g["train"] == w["train"] and g["valid"] == w["valid"]
    assert np.asarray(got["weights"]).tobytes() == np.asarray(want["weights"]).tobytes()


class _Blocks:
    """A stand-in for a group's ranks in one process: ``all_gather`` returns
    what every rank sends (``parallel.mesh.DataGroup``'s contract), the
    per-query doc counts (int64) or the per-query values, each block padded
    to the longest."""

    def __init__(self, counts, values):
        self.counts, self.values = counts, values

    def all_gather(self, t):
        return torch.stack(self.counts if t.dtype == torch.int64 else self.values)


def test_gathered_query_reduction_is_one_bit_pattern():
    """The metric reduction of a group (``BlockOrder``: every rank's real
    queries gathered in global order, then one rank's sum) gives one bit
    pattern over 1, 2 and 3 blocks of unequal query counts, padded to the
    longest block, and that of the unsharded sum of the same queries."""
    from quickrank_tpu_torch.learning.mart import reduce_queries

    rng = np.random.default_rng(5)
    pq = torch.from_numpy(rng.uniform(0, 1, 997).astype(np.float32) ** 3)
    metric = Ndcg(10)
    sd = SimpleNamespace(query_mask=torch.ones(997, dtype=torch.bool),
                         doc_mask=torch.ones(997 * 3, dtype=torch.bool))
    want = reduce_queries(metric, pq, sd)
    for cuts in ([], [400], [100, 651]):
        parts = np.split(np.arange(997), cuts)
        n = max(len(p) for p in parts)
        counts = [torch.tensor(np.pad(np.full(len(p), 3), (0, n - len(p)))) for p in parts]
        values = [torch.nn.functional.pad(pq[p], (0, n - len(p))) for p in parts]
        group = _Blocks(counts, values)
        for rank in range(len(parts)):
            sd_r = SimpleNamespace(queries=BlockOrder.build(group, counts[rank]))
            assert sd_r.queries.total == 3 * 997
            got = reduce_queries(metric, values[rank], sd_r, group=group)
            assert got.numpy().tobytes() == want.numpy().tobytes(), (cuts, rank)


def test_scale_counts_real_docs_across_a_power_of_two(folds):
    """The card's fixed-point scale counts the real docs on one device as in
    a group: at a doc count whose padded rows cross a power of two (130,500
    real docs, 131,072 rows) the rows would shift the scale by a bit.  On
    the CPU ``histogram_scale`` is None (float histograms)."""
    from quickrank_tpu_torch.ops.histogram import histogram_scale

    real, rows = 130_500, -(-(130_500 + 1) // 1024) * 1024
    assert (rows, real.bit_length(), rows.bit_length()) == (131_072, 17, 18)
    group = SimpleNamespace(num_docs=real)
    assert scale_doc_count(rows, None, real) == scale_doc_count(rows, group) == real
    assert scale_doc_count(rows) == rows  # no count given: every row is a doc
    td = TrainData.build(_port_ds(folds[0]), NTHR, device="cpu")
    assert td.num_docs == folds[0].num_docs < td.padded.num_docs_padded
    assert histogram_scale(torch.zeros(3, rows), None, real) is None


@pytest.mark.parametrize("what", [
    "RandomForest", "LambdaMartSelective", "StochasticNegative", "RankBoost",
    "cluster-on", "num-feat-shards"])
def test_unsharded_modules_refuse_a_group_naming_item_10b(folds, what, tmp_path):
    """What this slice does not shard raises before touching data, naming
    ROADMAP.md §A item 10b: nothing falls back to one device."""
    from quickrank_tpu_torch import driver, learning
    from quickrank_tpu_torch.parallel import DataGroup

    group = DataGroup(rank=0, world_size=2, device=torch.device("cpu"), backend="gloo")
    ds = _port_ds(folds[0])
    with pytest.raises(NotImplementedError, match="item 10b"):
        if what == "cluster-on":
            LambdaMart(ntrees=1, cluster="on").learn(ds, mesh=group, device="cpu")
        elif what == "num-feat-shards":
            driver.run(dict(num_feat_shards=2, train=str(tmp_path / "never-read.svml")))
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
