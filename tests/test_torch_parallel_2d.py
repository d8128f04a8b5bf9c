"""The 2-D data x feature mesh of the port (``parallel/mesh.py::Mesh2D``,
``--num-feat-shards``) on the CPU, against the port's unsharded and 1-D
runs and against the JAX package's ``make_mesh_2d``.

ONE launch of four gloo ranks (a 2 x 2 world, ``parallel/launch.py``) runs
every job; inside it a job runs on the whole 2 x 2 mesh, on its data axis
alone (a 2 x 1 group) or on its feature axis alone (two 1 x 2 meshes, one a
query block, each over all the data), ``parallel/workers.py::sub_mesh``:

  * best-first, best-k, level-wise and oblivious LambdaMART, DART and X-DART:
    a 1 x 2 feature mesh is the unsharded run node for node and bit for bit
    (no data-axis reduction: the feature axis adds no float sum), and the
    2 x 2 mesh is the 2 x 1 group bit for bit (the data axis sums the same
    shard histograms);
  * ``cluster="on"`` grows in dataset order under the mesh; RandomForest,
    LambdaMART-Selective and Stochastic-Negative draw one draw over the data
    (a 1 x 2 mesh is the unsharded run), and every rank of a mesh holds the
    same model, feature sampling included;
  * three trees grown from given gradients on 2 x 2, node for node JAX's
    ``shard_map`` growers on ``make_mesh_2d(2, 2)`` given the same gradients;
  * the layout: a rank's bin block is the 1-D layout's columns (its block,
    behind the stats column), JAX's ``make_mesh_2d`` block, and the same
    through the multi-host path;
  * the owner-routed descent (DART's train delta) is the QuickScorer sum bit
    for bit; doc subsampling's masks are the unsharded ones; Cleaver on a
    2 x 2 mesh runs over its data axis and prunes the 2 x 1 group's set.

Then the refusals of JAX's exclusion matrix (PARITY.md "known exclusions"),
with JAX's messages, and quicklearn ``--num-feat-shards`` on the CPU.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quickrank_tpu.data.synthetic import make_train_valid_test
from quickrank_tpu.learning import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning import ObliviousLambdaMart as JaxObliviousLambdaMart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from quickrank_tpu.parallel.mesh import shard_map, step_data_specs
from quickrank_tpu.trees.grow import leaf_outputs as jax_leaf_outputs
from quickrank_tpu_torch import driver
from quickrank_tpu_torch import learning as PL
from quickrank_tpu_torch.cli import build_parser
from quickrank_tpu_torch.data.dataset import Dataset, shard_and_pad
from quickrank_tpu_torch.data.svml import write_svml
from quickrank_tpu_torch.learning import LambdaMart
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.dart import WARM_START_2D as DART_WARM_2D
from quickrank_tpu_torch.learning.linear import ONE_D as LINEAR_ONE_D
from quickrank_tpu_torch.learning.mart import COLLAPSE_2D, WARM_START_2D, Mart, TrainData
from quickrank_tpu_torch.learning.rankboost import ONE_D as RANKBOOST_ONE_D
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.ops.binning import build_thresholds
from quickrank_tpu_torch.optimization import Cleaver
from quickrank_tpu_torch.parallel.launch import run_ranks
from quickrank_tpu_torch.parallel.mesh import DataGroup, FeatureShard, Mesh2D
from quickrank_tpu_torch.parallel.workers import batch_rank, ensemble_arrays, save_dataset

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

SHARDS, FEAT = 2, 2
TREES = 3
NTHR = 32
#: one launch of the four ranks takes ~1 min on a loaded CPU
DEADLINE = 600.0
TREE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf",
               "leaf_value")
GROWERS = ("best", "bestk", "level", "oblivious")
_TREE_KW = dict(ntrees=TREES, nleaves=8, nthresholds=NTHR, seed=1)
#: name -> (class name, kwargs, the meshes it runs on)
ALL3 = ((1, 2), (2, 2), (2, 1))
LEARNERS = {
    "best": ("LambdaMart", dict(_TREE_KW), ALL3),
    "bestk": ("LambdaMart", dict(_TREE_KW, growth="bestk"), ALL3),
    "level": ("LambdaMart", dict(_TREE_KW, growth="level", max_depth=3), ALL3),
    "oblivious": ("ObliviousLambdaMart", dict(ntrees=TREES, treedepth=3, nthresholds=NTHR,
                                              seed=1), ALL3),
    # DART drops from its third iteration; X-DART keeps some drops for good;
    # both run past iteration 10, where a new best ends in the full rescore
    "dart": ("Dart", dict(ntrees=14, nleaves=8, nthresholds=NTHR, rate_drop=0.25, seed=1),
             ALL3),
    "xdart": ("Dart", dict(ntrees=14, nleaves=8, nthresholds=NTHR, rate_drop=0.2, seed=5,
                           keep_drop=True, best_on_train=True), ALL3),
    # the clustered grower keeps the feature axis whole: dataset order here
    "cluster-on": ("LambdaMart", dict(_TREE_KW, cluster="on"), ((1, 2), (2, 2))),
    # one draw over the data (no feature sampling: a 1 x 2 mesh samples
    # over another padded width than one device)
    "randomforest": ("RandomForest", dict(_TREE_KW, subsample=0.6), ((1, 2), (2, 2))),
    "selective": ("LambdaMartSelective", dict(
        _TREE_KW, subsample=0.7, sampling_iterations=1, rank_sampling_factor=0.5,
        random_sampling_factor=0.25, negative_strategy="RATIO"), ((1, 2), (2, 2))),
    "stochasticnegative": ("StochasticNegative", dict(_TREE_KW, subsample=0.5),
                           ((1, 2), (2, 2))),
    # feature sampling over the global padded width, one draw for the mesh
    "randomforest-mf": ("RandomForest", dict(_TREE_KW, subsample=0.6, max_features=0.5),
                        ((2, 2),)),
}
#: the learners whose 2 x 2 run is held against the 2 x 1 group
DATA_AXIS = ("best", "bestk", "level", "oblivious", "dart", "xdart")
#: the learners whose 1 x 2 run is held against the unsharded run, and the
#: unsharded learner it equals
UNSHARDED = {name: name for name in
             ("best", "bestk", "level", "oblivious", "dart", "xdart", "randomforest",
              "selective", "stochasticnegative")}
UNSHARDED["cluster-on"] = "best"
DESCENT_SLOTS = [3, 0, 5, 1]
#: the owner-routed descent's all-reduce budgets (int64 words a block): 64
#: cuts the docs into blocks of 64 (one slot a block), 12,000 only the slots
#: (one or two a block over a rank's ~4,300 or ~8,600 rows)
DESCENT_WORDS = (64, 12000)
SUBSAMPLE_ITERATIONS = (0, 1)


def _port_ds(d) -> Dataset:
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(60, 20, 20))


@pytest.fixture(scope="module")
def full_thresholds(folds):
    return build_thresholds(folds[0].features, NTHR)[0]


def _given_gradients(folds):
    """(grad, weight) ``[T, 2 * docs_per_shard]`` in the 2-shard stacked
    layout: JAX's lambdas of fixed random scores on the one-shard layout,
    moved to their rows in the stacked one."""
    from types import SimpleNamespace

    from quickrank_tpu.metrics import Ndcg as JaxNdcg

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
def descent_model(folds, tmp_path_factory):
    """A model whose trees the owner-routed descent sums: 6 unsharded
    LambdaMART trees of 8 leaves, saved as XML, and their weights."""
    lm = LambdaMart(ntrees=6, nleaves=8, nthresholds=NTHR, seed=3)
    lm.learn(_port_ds(folds[0]), None, Ndcg(10), verbose=False, device="cpu")
    path = str(tmp_path_factory.mktemp("descent") / "lm.xml")
    lm.save(path)
    weights = np.random.default_rng(5).uniform(0.1, 1.0, len(DESCENT_SLOTS)).astype(np.float32)
    return path, weights


@pytest.fixture(scope="module")
def ranks(folds, given, full_thresholds, descent_model, tmp_path_factory):
    """The one launch of the 2 x 2 world: every job, results by key."""
    tmp = tmp_path_factory.mktemp("ranks2d")
    train = save_dataset(_port_ds(folds[0]), str(tmp / "train.npz"))
    valid = save_dataset(_port_ds(folds[1]), str(tmp / "valid.npz"))
    grads = str(tmp / "given.npz")
    np.savez(grads, grad=given[0], weight=given[1])
    keys, jobs = [], []

    def add(key, entry, spec):
        keys.append(key)
        jobs.append((entry, spec))

    for name, (cls, kw, shapes) in LEARNERS.items():
        for shape in shapes:
            add(("train", name, shape), "train_rank",
                dict(learner=cls, kwargs=kw, train=train, valid=valid, mesh=shape))
    for growth in GROWERS:
        cls, kw, _ = LEARNERS[growth]
        add(("grow", growth), "grow_rank", dict(learner=cls, kwargs=kw, train=train,
                                                gradients=grads, mesh=(2, 2)))
    add(("layout",), "layout_rank", dict(train=train, nthresholds=NTHR,
                                         thresholds=full_thresholds, mesh=(2, 2)))
    for shape in ((1, 2), (2, 2)):
        add(("descend", shape), "descend_rank", dict(
            model=descent_model[0], train=train, slots=DESCENT_SLOTS,
            weights=descent_model[1], words=DESCENT_WORDS, mesh=shape))
    add(("sample",), "sample_rank", dict(kwargs=dict(nthresholds=NTHR, subsample=0.5, seed=3),
                                         train=train, iterations=SUBSAMPLE_ITERATIONS,
                                         mesh=(2, 2)))
    for shape in ((2, 2), (2, 1)):
        add(("cleaver", shape), "optimize_rank", dict(
            model=descent_model[0], train=train, valid=valid, mesh=shape,
            cleaver=dict(pruning_method="QUALITY_LOSS", pruning_rate=0.5,
                         line_search=dict(num_points=8, max_iterations=2))))
    t0 = time.monotonic()
    out = run_ranks(batch_rank, SHARDS, args=(jobs,), device="cpu", deadline=DEADLINE,
                    num_feat_shards=FEAT)
    assert time.monotonic() - t0 < DEADLINE
    return {key: [r[i] for r in out] for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def unsharded(folds):
    """The port's single-device runs (histories and trees)."""
    out = {}
    for name in sorted(set(UNSHARDED.values())):
        cls, kw, _ = LEARNERS[name]
        model = getattr(PL, cls)(**kw)
        hist = model.learn(_port_ds(folds[0]), _port_ds(folds[1]), Ndcg(10), verbose=False,
                           device="cpu")
        out[name] = (hist, ensemble_arrays(model))
    return out


def _same_model(a, b) -> bool:
    return (all(np.asarray(v).tobytes() == np.asarray(b["trees"][k]).tobytes()
                for k, v in a["trees"].items())
            and a["history"]["train"] == b["history"]["train"]
            and a["history"]["valid"] == b["history"]["valid"]
            and a["history"].get("dropped") == b["history"].get("dropped")
            and a["history"].get("rescored") == b["history"].get("rescored"))


# -- the feature axis and the data axis ---------------------------------------

@pytest.mark.parametrize("name", list(UNSHARDED))
def test_feature_mesh_equals_unsharded(ranks, unsharded, name):
    """A 1 x 2 feature mesh grows the unsharded run's trees node for node and
    bit for bit, with its metrics (and DART's dropped sets), on every rank."""
    hist, trees = unsharded[UNSHARDED[name]]
    for r in ranks[("train", name, (1, 2))]:
        for k, v in trees.items():
            assert np.asarray(r["trees"][k]).tobytes() == np.asarray(v).tobytes(), k
        assert r["history"]["train"] == hist["train"]
        assert r["history"]["valid"] == hist["valid"]
        if "dropped" in hist:
            assert r["history"]["dropped"] == hist["dropped"]
            assert r["history"]["rescored"] == hist["rescored"]


@pytest.mark.parametrize("name", DATA_AXIS)
def test_data_by_feature_mesh_equals_data_axis_group(ranks, name):
    """The 2 x 2 mesh equals the 2 x 1 group bit for bit (trees, metrics,
    dropped sets): the feature axis changes no bit of the data axis's run."""
    for a, b in zip(ranks[("train", name, (2, 2))], ranks[("train", name, (2, 1))]):
        assert _same_model(a, b)


@pytest.mark.parametrize("name", list(LEARNERS))
def test_every_rank_holds_the_same_model(ranks, name):
    """Every rank of every mesh returns the same model, byte for byte (one
    feature-sampling draw and one doc draw shared by the whole mesh), and
    the 2 x 2 run went through the feature axis's collectives."""
    for shape in LEARNERS[name][2]:
        runs = ranks[("train", name, shape)]
        assert all(_same_model(runs[0], r) for r in runs[1:]), shape
    if (2, 2) in LEARNERS[name][2]:
        assert ranks[("train", name, (2, 2))][0]["collectives"]["calls"] > 0


def test_dart_drops_under_the_feature_mesh(ranks):
    """DART's dropped-set delta ran on the feature blocks: trees were dropped
    in the 1 x 2 and 2 x 2 runs of DART and X-DART."""
    for name in ("dart", "xdart"):
        for shape in ((1, 2), (2, 2)):
            assert sum(len(d) for d in ranks[("train", name, shape)][0]["history"]["dropped"])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["dart", "xdart"])
def test_dart_rescores_under_the_feature_mesh(ranks, name, shape):
    """The periodic full rescore of the train fold (every capacity slot,
    owner-routed over the feature blocks) ran in the 1 x 2 and 2 x 2 runs of
    DART and X-DART, at the unsharded run's iterations; the runs equal the
    unsharded one bit for bit after it (``test_feature_mesh_equals_unsharded``,
    ``test_data_by_feature_mesh_equals_data_axis_group``)."""
    for r in ranks[("train", name, shape)]:
        assert r["history"]["rescored"], (name, shape)
        assert len(r["history"]["train"]) > r["history"]["rescored"][0] + 1


# -- against JAX's make_mesh_2d -------------------------------------------------

@pytest.fixture(scope="module")
def jax_given_trees(folds, given):
    """JAX's growers on ``make_mesh_2d(2, 2)`` given the same gradients, as
    its boosting step runs them under ``shard_map``."""
    mesh = jax_make_mesh_2d(SHARDS, FEAT)
    jtr = JaxTrainData.build(folds[0], NTHR, num_shards=SHARDS, num_feat_shards=FEAT)
    specs = step_data_specs(jtr.step, "data", "feat")
    out = {}
    for growth in GROWERS:
        cls, kw, _ = LEARNERS[growth]
        jcls = JaxObliviousLambdaMart if cls == "ObliviousLambdaMart" else JaxLambdaMart
        jl = jcls(**kw)
        cfg = jl._grow_config(jtr.num_bins, "feat", FEAT,
                              num_real_features=jtr.num_real_features)

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
    return jtr, out


@pytest.mark.parametrize("growth", GROWERS)
def test_given_lambdas_trees_equal_jax_mesh_2d(ranks, jax_given_trees, growth):
    """Given the same gradients, the port's 2 x 2 mesh grows JAX's
    ``make_mesh_2d(2, 2)`` trees node for node (split features in global
    ids, bins, thresholds, leaf values) on every rank, and routes every doc
    to JAX's node."""
    _, trees = jax_given_trees
    grown = ranks[("grow", growth)]
    for m in range(TREES):
        jtree, jnode = trees[growth][m]
        jn = np.asarray(jnode).reshape(SHARDS, -1)
        for rank, got in enumerate(grown):
            for k in TREE_FIELDS:
                np.testing.assert_array_equal(got[m]["tree"][k], np.asarray(getattr(jtree, k)),
                                              err_msg=f"tree {m}, rank {rank}: {k}")
            np.testing.assert_array_equal(got[m]["node"], jn[rank // FEAT],
                                          err_msg=f"tree {m}, rank {rank}: node of doc")


def test_layout_is_jax_make_mesh_2d_blocks(ranks, jax_given_trees, full_thresholds):
    """Rank (d, f)'s bin block is JAX's ``make_mesh_2d`` block ``(d, f)`` of
    the same tables (``f_blk`` columns, the padding at the global end), behind
    the stats column (global column 0), and its host tables are JAX's global
    padded table."""
    jtr, _ = jax_given_trees
    jb = np.asarray(jtr.step.binned)
    n = jb.shape[0] // SHARDS
    for rank, r in enumerate(ranks[("layout",)]):
        d, f = divmod(rank, FEAT)
        lay = r[("whole", "mesh")]
        lo, width = lay["feat"]
        assert (lo, width) == (f * width, jb.shape[1] // FEAT)
        want = jb[d * n:(d + 1) * n]
        np.testing.assert_array_equal(lay["binned"][:, 0], want[:, 0])
        np.testing.assert_array_equal(lay["binned"][:, 1:], want[:, lo:lo + width])
        np.testing.assert_array_equal(lay["host_thresholds"], np.asarray(jtr.step.thresholds))


@pytest.mark.parametrize("path", ["whole", "multihost"])
def test_layout_is_the_data_axis_layout_by_feature_block(ranks, path):
    """Through ``TrainData.build`` and through the multi-host path (each rank
    loads only its query block), a 2 x 2 rank's data is its data axis's
    1-D layout: the same rows, doc ids, queries and doc count, and the bin
    columns of its feature block behind global column 0."""
    for r in ranks[("layout",)]:
        mesh, one = r[(path, "mesh")], r[(path, "data")]
        lo, width = mesh["feat"]
        assert one["feat"] is None and mesh["num_docs"] == one["num_docs"]
        for k in ("labels", "doc_mask", "doc_ids", "nvalid"):
            np.testing.assert_array_equal(mesh[k], one[k], err_msg=k)
        cols = one["binned"].shape[1]
        block = np.zeros((one["binned"].shape[0], width), one["binned"].dtype)
        real = max(0, min(width, cols - lo))
        block[:, :real] = one["binned"][:, lo:lo + real]
        np.testing.assert_array_equal(mesh["binned"][:, 0], one["binned"][:, 0])
        np.testing.assert_array_equal(mesh["binned"][:, 1:], block)
        np.testing.assert_array_equal(mesh["host_thresholds"][:cols], one["host_thresholds"])


def test_multihost_refuses_a_query_block_split_over_hosts(ranks):
    """Each host runs whole data rows (JAX multihost.py:151-157): when the
    ranks of a query block load different blocks, every rank refuses."""
    for r in ranks[("layout",)]:
        assert "must load the same block" in r["mismatch"]


# -- the owner-routed descent, the draws, Cleaver ---------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_owner_routed_descent_is_the_quickscorer_sum(ranks, shape):
    """DART's train delta over a feature block (the owners' node tests, one
    all-reduce, then the Kahan chain) is the QuickScorer sum over the whole
    bin matrix, bit for bit, on every rank."""
    for r in ranks[("descend", shape)]:
        assert r["owned"].tobytes() == r["qs"].tobytes()
        assert np.abs(r["qs"]).max() > 0


@pytest.mark.parametrize("words", DESCENT_WORDS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_owner_routed_descent_in_blocks_is_the_same_sum(ranks, shape, words):
    """Cut into blocks of docs and of slots, one all-reduce of at most
    ``words`` int64 a block, the owner-routed sum is the one-block sum bit
    for bit (each doc's Kahan chain still runs over the slots in order)."""
    for r in ranks[("descend", shape)]:
        assert r["chunked"][words].tobytes() == r["owned"].tobytes()


def test_owner_routed_descent_equals_the_unsharded_delta(ranks, folds, descent_model):
    """The 1 x 2 mesh's owner-routed delta is the unsharded run's dropped-set
    delta (``DropTable.delta`` on the one-device bin matrix) bit for bit."""
    from quickrank_tpu_torch.learning.dart import DropTable
    from quickrank_tpu_torch.learning.mart import rebin_ensemble
    from quickrank_tpu_torch.ops.binning import scorer_rows

    model = LTRAlgorithm.load(descent_model[0])
    td = TrainData.build(_port_ds(folds[0]), NTHR, device="cpu")
    ens = rebin_ensemble(model.ensemble, td.thresholds, force=True)
    want = DropTable(ens, "cpu").delta(DESCENT_SLOTS, descent_model[1],
                                       scorer_rows(td.step.binned)).numpy()
    for r in ranks[("descend", (1, 2))]:
        assert r["owned"].tobytes() == want.tobytes()


def test_doc_subsampling_is_one_draw_over_the_data(ranks, folds):
    """Under the 2 x 2 mesh doc subsampling keeps the unsharded masks: each
    data block's ranks keep the same slice, and the blocks' slices make the
    one-device mask."""
    model = Mart(nthresholds=NTHR, subsample=0.5, seed=3)
    td = TrainData.build(_port_ds(folds[0]), NTHR, device="cpu")
    sd = td.step
    narrow = sd.doc_mask & ((sd.labels > 0) | (sd.doc_ids % 3 == 0))
    want = [sd.doc_ids[model._sample_mask(td, m, pool, narrowed=nw)].numpy()
            for m in SUBSAMPLE_ITERATIONS for pool, nw in ((sd.doc_mask, False), (narrow, True))]
    got = ranks[("sample",)]
    for i, w in enumerate(want):
        for d in range(SHARDS):
            block = got[d * FEAT]
            assert all(np.array_equal(block[i], got[d * FEAT + f][i]) for f in range(FEAT))
        np.testing.assert_array_equal(np.concatenate([got[d * FEAT][i] for d in range(SHARDS)]),
                                      w)


def test_cleaver_runs_over_the_data_axis(ranks):
    """Cleaver under a 2 x 2 mesh prunes over its data axis (JAX's ``Fold``
    takes the mesh's first axis): the 2 x 1 group's pruned set, metrics and
    weights, on every rank."""
    for a, b in zip(ranks[("cleaver", (2, 2))], ranks[("cleaver", (2, 1))]):
        for k in ("pruned", "metric_before", "metric_after", "metric_before_valid",
                  "metric_after_valid"):
            assert a["info"][k] == b["info"][k], k
        assert np.asarray(a["weights"]).tobytes() == np.asarray(b["weights"]).tobytes()
    assert len(ranks[("cleaver", (2, 2))][0]["info"]["pruned"]) > 0


# -- the feature shard's arithmetic (no spawn) ---------------------------------------

class _Gathered:
    """A feature group whose ``all_gather`` returns the given ranks' rows."""

    def __init__(self, rank, rows):
        self.rank, self.world_size, self.rows = rank, len(rows), rows

    def all_gather(self, t):
        out = torch.stack([torch.as_tensor(r, dtype=t.dtype) for r in self.rows])
        assert torch.equal(out[self.rank], t)
        return out


def test_feature_shard_maps_global_and_local_ids():
    """Rank f's columns are the stats column, then global ``[f * width, (f +
    1) * width)``: masks slice to it, ids map both ways, other ranks' ids and
    a leaf's -1 map to -1."""
    fs = FeatureShard(_Gathered(1, [[0.0]] * 3), 4)
    assert (fs.lo, fs.global_width, fs.index, fs.size) == (4, 12, 1, 3)
    gmask = torch.arange(12) % 3 == 0
    np.testing.assert_array_equal(fs.local_mask(gmask).numpy(),
                                  [False] + [bool(x) for x in gmask[4:8]])
    np.testing.assert_array_equal(fs.local_mask(torch.stack([gmask, ~gmask])).shape, (2, 5))
    ids = torch.tensor([-1, 0, 3, 4, 7, 8, 11])
    np.testing.assert_array_equal(fs.local_ids(ids).numpy(), [-1, -1, -1, 1, 4, -1, -1])
    np.testing.assert_array_equal(fs.to_global(torch.tensor([1, 4])).numpy(), [4, 7])


def test_feature_shard_best_takes_the_first_maximum():
    """The gathered winner is the first maximum over the ranks that have a
    candidate: on a tie the lower rank (the lower global feature id); a rank
    without a candidate never wins; no candidate anywhere: no split."""
    # per rank: (has, gain, global f, t) for two candidates
    rows = [[[1, 2.0, 1, 3], [0, -np.inf, 1, 0], [1, 1.5, 2, 1]],
            [[1, 2.0, 5, 0], [0, -np.inf, 6, 0], [1, 2.5, 7, 2]]]
    for rank in (0, 1):
        fs = FeatureShard(_Gathered(rank, rows), 4)
        mine = torch.tensor(rows[rank], dtype=torch.float64)
        has = mine[:, 0] > 0
        got = fs.best(has, mine[:, 1].float(), mine[:, 2].long() - fs.lo + 1,
                      mine[:, 3].long())
        np.testing.assert_array_equal(got[0].numpy(), [True, False, True])
        np.testing.assert_array_equal(got[2].numpy()[[0, 2]], [1, 7])
        np.testing.assert_array_equal(got[3].numpy()[[0, 2]], [3, 2])
        assert got[1].dtype == torch.float32 and float(got[1][2]) == 2.5


# -- JAX's exclusion matrix -------------------------------------------------------

def _mesh2d(n=SHARDS, k=FEAT) -> Mesh2D:
    """A rank's 2-D mesh for the refusals, which raise before any collective."""
    def g(w):
        return DataGroup(rank=0, world_size=w, device=torch.device("cpu"), backend="gloo")
    return Mesh2D(world=g(n * k), data=g(n), feat=g(k))


@pytest.mark.parametrize("case", ["rankboost", "coordasc", "linesearch", "metacleaver",
                                  "warm-start", "collapse", "dart-warm-start"])
def test_learners_refuse_what_jax_refuses(folds, case):
    """Each exclusion of PARITY.md raises JAX's message, with its reason,
    before touching the data; a 1-D mesh is still taken by every learner."""
    ds = _port_ds(folds[0])
    runs = {
        "rankboost": (lambda: PL.RankBoost(ntrees=1).learn(ds, mesh=_mesh2d(), device="cpu"),
                      RANKBOOST_ONE_D),
        "coordasc": (lambda: PL.CoordinateAscent().learn(ds, mesh=_mesh2d(), device="cpu"),
                     LINEAR_ONE_D),
        "linesearch": (lambda: PL.LineSearch().learn(ds, mesh=_mesh2d(), device="cpu"),
                       LINEAR_ONE_D),
        "metacleaver": (lambda: PL.MetaCleaver(LambdaMart(ntrees=2), Cleaver()).learn(
            ds, mesh=_mesh2d(), device="cpu"), WARM_START_2D),
        "warm-start": (lambda: LambdaMart(ntrees=1).learn(ds, mesh=_mesh2d(), device="cpu",
                                                          warm_start=True), WARM_START_2D),
        "collapse": (lambda: LambdaMart(ntrees=1, collapse_leaves_factor=0.5).learn(
            ds, mesh=_mesh2d(), device="cpu"), COLLAPSE_2D),
        "dart-warm-start": (lambda: PL.Dart(ntrees=1).learn(ds, mesh=_mesh2d(), device="cpu",
                                                            warm_start=True), DART_WARM_2D),
    }
    fn, message = runs[case]
    with pytest.raises(NotImplementedError) as e:
        fn()
    assert str(e.value) == message and "PARITY.md known exclusions" in message


@pytest.mark.parametrize("flags,message", [
    (dict(algo="RANKBOOST"), "--num-feat-shards: RANKBOOST supports 1-D (data) meshes only"),
    (dict(algo="COORDASC"), "--num-feat-shards: COORDASC supports 1-D (data) meshes only"),
    (dict(algo="LINESEARCH"), "--num-feat-shards: LINESEARCH supports 1-D (data) meshes only"),
    (dict(restart_train=True), "--num-feat-shards with --restart-train is not supported"),
    (dict(collapse_leaves_factor=0.5),
     "--num-feat-shards with --collapse-leaves-factor is not supported"),
], ids=["rankboost", "coordasc", "linesearch", "restart-train", "collapse"])
def test_driver_refuses_what_jax_refuses(tmp_path, flags, message):
    """quicklearn's excluded ``--num-feat-shards`` combinations raise JAX's
    messages (driver.py:203-232) before anything is read or spawned."""
    with pytest.raises(NotImplementedError) as e:
        driver.run(dict(num_shards=2, num_feat_shards=2,
                        train=str(tmp_path / "never-read.svml"), **flags))
    assert str(e.value).startswith(message) and "PARITY.md known exclusions" in str(e.value)


# -- quicklearn --num-feat-shards ----------------------------------------------------

@pytest.fixture(scope="module")
def svml(folds, tmp_path_factory):
    d = tmp_path_factory.mktemp("svml2d")
    for name, ds in zip(("train", "valid", "test"), folds):
        write_svml(_port_ds(ds), str(d / f"{name}.svml"))
    return d


def _quicklearn(svml, extra):
    """quicklearn's parse and pipeline (cli.main's), with a deadline on the
    ranks' launch."""
    args = vars(build_parser().parse_args(
        ["--train", str(svml / "train.svml"), "--valid", str(svml / "valid.svml"),
         "--test", str(svml / "test.svml"), "--num-trees", "3", "--num-leaves", "8",
         "--num-thresholds", str(NTHR), "--partial", "0", "--device", "cpu", "--quiet"]
        + extra))
    return driver.run({**{k: v for k, v in args.items() if v is not None},
                       "deadline": DEADLINE})


def test_quicklearn_feature_mesh_writes_the_unsharded_model(svml, tmp_path):
    """``--num-shards 1 --num-feat-shards 2``: two ranks train, rank 0 writes
    the model file and the test scores, both the unsharded run's byte for
    byte."""
    for tag, extra in (("one", []), ("mesh", ["--num-shards", "1", "--num-feat-shards", "2"])):
        _quicklearn(svml, extra + ["--model-out", str(tmp_path / f"{tag}.xml"),
                                   "--scores", str(tmp_path / f"{tag}.txt")])
    for ext in ("xml", "txt"):
        assert (tmp_path / f"mesh.{ext}").read_bytes() == (tmp_path / f"one.{ext}").read_bytes()


def test_quicklearn_on_a_2x2_mesh_trains_and_scores(svml, tmp_path):
    """``--num-shards 2 --num-feat-shards 2``: four ranks train; rank 0
    writes one model and its test scores (the saved model's own), and a
    scoring-only run of that model on the mesh (``--model-in``, its doc rows
    spread over the four ranks) writes the same scores."""
    model, scores, again = (tmp_path / n for n in ("m.xml", "s.txt", "again.txt"))
    _quicklearn(svml, ["--num-shards", "2", "--num-feat-shards", "2", "--model-out",
                       str(model), "--scores", str(scores)])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.xml", "s.txt"]
    lm = LTRAlgorithm.load(str(model))
    assert lm.NAME == "LAMBDAMART" and lm.ensemble.num_trees >= 1
    from quickrank_tpu_torch.data.svml import read_svml

    test = read_svml(str(svml / "test.svml"))
    np.testing.assert_array_equal(np.loadtxt(scores).astype(np.float32),
                                  lm.score_dataset(test, device="cpu"))
    args = vars(build_parser().parse_args(
        ["--model-in", str(model), "--test", str(svml / "test.svml"), "--scores", str(again),
         "--num-shards", "2", "--num-feat-shards", "2", "--device", "cpu", "--quiet"]))
    driver.run({**{k: v for k, v in args.items() if v is not None}, "deadline": DEADLINE})
    assert again.read_bytes() == scores.read_bytes()
