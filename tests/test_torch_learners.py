"""The port's sampling learners (LambdaMART-Selective, Stochastic-Negative),
RandomForest and CustomLTR against the JAX package's, on the CPU, and all
five new ``--algo`` values through quicklearn and quickscore.

Presence masks without a random draw (Selective with
``random_sampling_factor`` 0) are JAX's exactly on the same scores.  The
random draws come from ``torch.Generator`` and cannot be ``jax.random``'s, so
where a draw enters, the rule is held exactly (every positive kept, the
negatives counted as the rule says) and the trees are held to JAX's given an
injected presence.  The port's lambdas differ from XLA's in the last bit
(ROADMAP.md §C), so tree-for-tree runs of the lambda learners take JAX's
lambdas (``_jax_lambdas``).  RandomForest's gradients are the labels, so its
trees are JAX's as they come."""

import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data.dataset import scatter_flat as jax_scatter_flat
from quickrank_tpu.data.synthetic import make_train_valid_test
from quickrank_tpu.data.svml import write_svml
from quickrank_tpu.io import xml_model as jax_xml
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.custom import CustomLTR as JaxCustom
from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.learning.randomforest import RandomForest as JaxRandomForest
from quickrank_tpu.learning.selective import LambdaMartSelective as JaxSelective
from quickrank_tpu.learning.selective import _select_presence as jax_select_presence
from quickrank_tpu.learning.stochasticnegative import StochasticNegative as JaxSN
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu.trees import random_ensemble as jax_random
from quickrank_tpu_torch import quickscore
from quickrank_tpu_torch.cli import main as port_main
from quickrank_tpu_torch.data.dataset import Dataset, scatter_flat
from quickrank_tpu_torch.learning import (
    CustomLTR,
    LambdaMartSelective,
    RandomForest,
    RankBoost,
    StochasticNegative,
)
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.factory import ltr_algorithm_factory
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.learning.selective import select_presence
from quickrank_tpu_torch.learning.stochasticnegative import sample_presence
from quickrank_tpu_torch.metrics.metrics import Ndcg
from quickrank_tpu_torch.trees import random_ensemble

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf", "leaf_value")
_KW = dict(ntrees=3, nleaves=8, nthresholds=32, seed=3, esr=0)


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(30, 10, 10))


@pytest.fixture(scope="module")
def layouts(folds):
    """The train fold laid out by both packages (32 thresholds)."""
    return JaxTrainData.build(folds[0], 32), TrainData.build(_port_ds(folds[0]), 32,
                                                              device="cpu")


def _jax_lambdas(cls):
    """``cls`` fed JAX's lambda gradients of the same scores."""

    class WithJaxLambdas(cls):
        def _gradients(self, sd, scores, sample_mask, full_mask=False):
            names = ("labels2d", "doc_mask", "pad_index", "inv_q", "inv_slot", "slot_mask",
                     "nvalid")
            jsd = SimpleNamespace(**{k: jnp.asarray(getattr(sd, k).numpy()) for k in names})
            me = SimpleNamespace(_train_metric=JaxNdcg(10), query_chunk=None)
            g, w = JaxLambdaMart._gradients(me, jsd, jnp.asarray(scores.numpy()),
                                            jnp.asarray(sample_mask.numpy()), None)
            return torch.tensor(np.asarray(g)), torch.tensor(np.asarray(w))

    return WithJaxLambdas


def _record_presence(model):
    """Wrap ``model._update_presence`` to keep every mask it returns."""
    seen, hook = [], model._update_presence

    def update(*a):
        out = hook(*a)
        seen.append(None if out is None else np.asarray(out))
        return out

    model._update_presence = update
    return seen


def _assert_same_trees(port_model, jax_model):
    got = port_model.ensemble.numpy()
    T = port_model.ensemble.num_trees
    assert T == int(jax_model.ensemble.num_trees)
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(got[k][:T], np.asarray(getattr(jax_model.ensemble, k))[:T],
                                      err_msg=k)


def test_scatter_flat_matches_jax(layouts):
    jt, pt = layouts
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(tuple(pt.step.slot_mask.shape)).astype(np.float32)
    want = jax_scatter_flat(jnp.asarray(vals), jt.padded.pad_index_global,
                            jt.padded.slot_mask, jt.padded.num_docs_padded)
    got = scatter_flat(torch.from_numpy(vals), pt.step.pad_index, pt.step.slot_mask,
                       pt.padded.num_docs_padded)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strategy,rank_factor", [
    ("RATIO", 0.5), ("RATIO", 0.25), ("MUL", 0.5), ("MUL", 1.0), ("POS", 0.5), ("POS", 1.0)])
def test_selective_presence_equals_jax(layouts, strategy, rank_factor):
    """With no random extras, the masks of every strategy are JAX's on the
    same scores (stable descending ranks, float32 counts rounded half to
    even); ties in the scores included."""
    jt, pt = layouts
    rng = np.random.default_rng(7)
    s = np.round(rng.standard_normal(pt.padded.num_docs_padded), 1).astype(np.float32)
    want = jax_select_presence(jnp.asarray(s), jax.random.PRNGKey(0), jnp.float32(rank_factor),
                               jnp.float32(0.0), jt.padded.pad_index_global, jt.padded.labels,
                               jt.padded.slot_mask, jt.padded.num_docs_padded, strategy)
    got = select_presence(torch.from_numpy(s), pt.step, pt.padded.num_docs_padded, strategy,
                          rank_factor, 0.0, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(pt.step.doc_mask.sum())


def _per_query(mask, sd):
    """(kept positives, positives, kept negatives, negatives) per query."""
    kept = mask[sd.pad_index] & sd.slot_mask
    pos = (sd.labels2d > 0) & sd.slot_mask
    neg = (sd.labels2d <= 0) & sd.slot_mask
    return ((kept & pos).sum(1), pos.sum(1), (kept & neg).sum(1), neg.sum(1))


@pytest.mark.parametrize("strategy", ["RATIO", "MUL", "POS"])
def test_selective_random_extras_follow_the_rule(layouts, strategy):
    """With random extras: every positive and the n_top best-scored
    negatives are kept, and n_top + n_rand negatives in all."""
    _, pt = layouts
    sd = pt.step
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.standard_normal(pt.padded.num_docs_padded).astype(np.float32))
    keep = select_presence(s, sd, pt.padded.num_docs_padded, strategy, 0.3, 0.4,
                           torch.Generator().manual_seed(5))
    none = select_presence(s, sd, pt.padded.num_docs_padded, strategy, 0.3, 0.0,
                           torch.Generator().manual_seed(5))
    rand = select_presence(s, sd, pt.padded.num_docs_padded, strategy, 0.0, 0.4,
                           torch.Generator().manual_seed(5))
    kp, npos, kn, nneg = _per_query(keep, sd)
    assert torch.equal(kp, npos)
    assert not bool((none & ~keep).any()), "a top-scored negative was dropped"
    n_top = _per_query(none, sd)[2]
    n_rand = _per_query(rand, sd)[2]
    assert torch.equal(kn, torch.minimum(n_top + n_rand, nneg))
    assert int((keep & ~none).sum()) > 0


@pytest.mark.parametrize("frac", [0.3, 0.5, 3.0])
def test_stochastic_negative_presence_follows_the_rule(layouts, frac):
    """Every positive, and floor(frac * nneg) negatives a query
    (min(int(frac), nneg) above 1); another generator state draws others."""
    _, pt = layouts
    sd = pt.step
    keep = sample_presence(sd, pt.padded.num_docs_padded, frac, torch.Generator().manual_seed(1))
    kp, npos, kn, nneg = _per_query(keep, sd)
    assert torch.equal(kp, npos)
    want = (torch.clamp(nneg, max=int(frac)) if frac > 1
            else torch.floor(np.float32(frac) * nneg.float()).long())
    assert torch.equal(kn, want)
    other = sample_presence(sd, pt.padded.num_docs_padded, frac, torch.Generator().manual_seed(2))
    assert not torch.equal(keep, other)
    assert not bool((keep & ~sd.doc_mask).any())


@pytest.mark.parametrize("strategy", ["RATIO", "MUL", "POS"])
def test_selective_run_matches_jax(folds, strategy):
    """Given JAX's lambdas, three iterations sampled every iteration: the
    presence masks and the trees are JAX's."""
    train = folds[0]
    kw = dict(_KW, sampling_iterations=1, rank_sampling_factor=0.5, negative_strategy=strategy)
    j = JaxSelective(**kw)
    jseen = _record_presence(j)
    j.learn(train, None, JaxNdcg(10), verbose=False)
    p = _jax_lambdas(LambdaMartSelective)(**kw)
    pseen = _record_presence(p)
    p.learn(_port_ds(train), None, Ndcg(10), verbose=False, device="cpu")
    assert len(pseen) == len(jseen) == 3 and pseen[0] is None and jseen[0] is None
    for got, want in zip(pseen[1:], jseen[1:]):
        np.testing.assert_array_equal(got, want)
    _assert_same_trees(p, j)


def test_stochastic_negative_run_matches_jax_given_presence(folds, layouts):
    """An injected presence (the port's own draw, handed to both) and JAX's
    lambdas: the trees are JAX's."""
    train = folds[0]
    _, pt = layouts
    masks = [sample_presence(pt.step, pt.padded.num_docs_padded, 0.4,
                             torch.Generator().manual_seed(m)) for m in range(3)]
    j = JaxSN(**_KW, subsample=0.4)
    j._update_presence = lambda m, *a: jnp.asarray(masks[m].numpy())
    j.learn(train, None, JaxNdcg(10), verbose=False)
    p = _jax_lambdas(StochasticNegative)(**_KW, subsample=0.4)
    p._update_presence = lambda m, *a: masks[m]
    p.learn(_port_ds(train), None, Ndcg(10), verbose=False, device="cpu")
    _assert_same_trees(p, j)


def test_random_forest_matches_jax_tree_for_tree(folds):
    """subsample 1 and max_features 1: no draw matters, the gradients are
    the labels, and every tree is JAX's."""
    train, valid, _ = folds
    j = JaxRandomForest(**_KW)
    jh = j.learn(train, valid, JaxNdcg(10), verbose=False)
    p = RandomForest(**_KW)
    ph = p.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False, device="cpu")
    _assert_same_trees(p, j)
    np.testing.assert_allclose(ph["train"], jh["train"], rtol=0, atol=1e-6)


def test_custom_scores_and_xml_equal_jax(folds, tmp_path):
    train, _, test = folds
    p, j = CustomLTR(), JaxCustom()
    ph = p.learn(_port_ds(train), None, Ndcg(10), verbose=False, device="cpu")
    jh = j.learn(train, None, JaxNdcg(10), verbose=False)
    np.testing.assert_allclose(ph["train"], jh["train"], rtol=0, atol=1e-6)
    scores = p.score_dataset(_port_ds(test), device="cpu")
    assert scores.dtype == np.float64 and np.all(scores == 666.0)
    p.save(str(tmp_path / "p.xml"))
    j.save(str(tmp_path / "j.xml"))
    assert (tmp_path / "p.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()


_SAVED = {
    "RANDOMFOREST": (RandomForest, JaxRandomForest, dict(subsample=0.6, max_features=0.5)),
    "LAMBDAMART-SELECTIVE": (LambdaMartSelective, JaxSelective, dict(
        sampling_iterations=2, rank_sampling_factor=0.75, random_sampling_factor=0.5,
        normalization_factor=7, adaptive_strategy="MIX", negative_strategy="POS")),
    "STOCHASTIC-NEGATIVE": (StochasticNegative, JaxSN, dict(subsample=0.3)),
}


@pytest.mark.parametrize("name", sorted(_SAVED))
def test_xml_bytes_equal_jax_and_round_trip(name, tmp_path):
    """The port writes the JAX package's bytes for the same model, and each
    package loads the other's file into the same hyperparameters (the
    negative fraction of STOCHASTIC-NEGATIVE included)."""
    cls, jcls, kw = _SAVED[name]
    p, j = cls(ntrees=9, nleaves=4, **kw), jcls(ntrees=9, nleaves=4, **kw)
    p.ensemble = random_ensemble.random_balanced_ensemble(3, 2, 5, seed=1)
    j.ensemble = jax_random.random_balanced_ensemble(3, 2, 5, seed=1)
    p.save(str(tmp_path / "p.xml"))
    jax_xml.save_model(j, str(tmp_path / "j.xml"))
    assert (tmp_path / "p.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()
    back, jback = LTRAlgorithm.load(str(tmp_path / "j.xml")), JaxLTRAlgorithm.load(
        str(tmp_path / "p.xml"))
    assert type(back) is cls and type(jback) is jcls
    for attr in ("subsample", "max_features", "negative_fraction", "sampling_iterations",
                 "rank_sampling_factor", "random_sampling_factor", "normalization_factor",
                 "adaptive_strategy", "negative_strategy"):
        assert getattr(back, attr, None) == getattr(p, attr, None) == getattr(jback, attr, None)


def test_factory_builds_every_learner():
    built = {name: ltr_algorithm_factory(name, num_trees=5, subsample=0.4,
                                         negative_strategy="MUL", sampling_iterations=3)
             for name in ("RANKBOOST", "LAMBDAMART-SELECTIVE", "STOCHASTIC-NEGATIVE",
                          "RANDOMFOREST", "CUSTOM")}
    assert type(built["RANKBOOST"]) is RankBoost and built["RANKBOOST"].T == 5
    sel = built["LAMBDAMART-SELECTIVE"]
    assert (sel.negative_strategy, sel.sampling_iterations, sel.subsample) == ("MUL", 3, 0.4)
    sn = built["STOCHASTIC-NEGATIVE"]
    assert (sn.negative_fraction, sn.subsample) == (0.4, 1.0)
    assert type(built["RANDOMFOREST"]) is RandomForest and type(built["CUSTOM"]) is CustomLTR


@pytest.fixture(scope="module")
def svml_dir(tmp_path_factory, folds):
    d = tmp_path_factory.mktemp("learners_cli")
    for name, ds in zip(("train", "valid", "test"), folds):
        write_svml(ds, str(d / f"{name}.svml"))
    return d


CLI_RUNS = {
    "RANKBOOST": ["--num-trees", "6"],
    "LAMBDAMART-SELECTIVE": ["--sampling-iterations", "1", "--rank-sampling-factor", "0.5",
                             "--random-sampling-factor", "0.25", "--negative-strategy", "POS",
                             "--adaptive-strategy", "MIX"],
    "STOCHASTIC-NEGATIVE": ["--subsample", "0.3"],
    "RANDOMFOREST": ["--subsample", "0.6", "--max-features", "0.5"],
    "CUSTOM": [],
}


@pytest.mark.parametrize("algo", sorted(CLI_RUNS))
def test_cli_trains_saves_and_quickscore_serves(algo, svml_dir, tmp_path):
    """quicklearn --algo trains on the CPU, saves a model of the learner's
    type (which the JAX package loads too), and quickscore's scores of it
    equal quicklearn's --scores."""
    d = svml_dir
    model, scores = tmp_path / "m.xml", tmp_path / "s.txt"
    flags = ["--algo", algo, "--train", str(d / "train.svml"), "--valid", str(d / "valid.svml"),
             "--test", str(d / "test.svml"), "--num-trees", "3", "--num-leaves", "8",
             "--num-thresholds", "32", "--model-out", str(model), "--scores", str(scores),
             "--partial", "0", "--device", "cpu", "--quiet"] + CLI_RUNS[algo]
    with redirect_stdout(io.StringIO()):
        assert port_main(flags) == 0
        assert quickscore.main(["-d", str(d / "test.svml"), "-m", str(model), "-r", "1",
                                "--device", "cpu", "-s", str(tmp_path / "q.txt")]) == 0
    loaded = LTRAlgorithm.load(str(model))
    assert loaded.NAME == algo == JaxLTRAlgorithm.load(str(model)).NAME
    got, want = np.loadtxt(tmp_path / "q.txt"), np.loadtxt(scores)
    assert np.isfinite(got).all() and np.array_equal(got, want)
