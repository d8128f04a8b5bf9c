"""The per-tree score surface of the port against the JAX package, on the
CPU: per-tree columns (trees/qs.py::partial_scores_qs, ops/scoring.py::
partial_scores, the QuickScorer wrapper's partial entry), the packed table
built one tree at a time, and Mart's partial_scores_dataset, update_weights
and feature_importances on one model in both packages.  Inputs are made with
numpy from fixed seeds and fed to both."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.ops.scoring import partial_scores as jax_partial_scores
from quickrank_tpu.trees import qs as jax_qs
from quickrank_tpu.trees.random_ensemble import (
    random_bestfirst_ensemble as jax_bestfirst,
)
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.dart import DropTable
from quickrank_tpu_torch.ops import kernel_qs
from quickrank_tpu_torch.ops.scoring import partial_scores
from quickrank_tpu_torch.trees import qs
from quickrank_tpu_torch.trees.perfect import tree_depths
from quickrank_tpu_torch.trees.random_ensemble import random_bestfirst_ensemble
from quickrank_tpu_torch.trees.structs import FIELDS, EnsembleTensors

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


def _port(jens) -> EnsembleTensors:
    return EnsembleTensors.from_numpy({k: np.asarray(getattr(jens, k)) for k in FIELDS})


def _features(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f), dtype=np.float32)


#: trees, leaves, features; JAX's dense QS masks are [T, I, L] bf16 and its
#: block-diagonal product [G*L, G*I], which the CPU holds up to 64 leaves
#: here: from 1,024 leaves JAX's reference is its descent, which its own
#: tests hold bitwise equal to partial_scores_qs
PARTIAL_SHAPES = [(12, 8, 10), (5, 64, 40), (3, 1024, 30), (2, 2048, 30)]


@pytest.mark.parametrize("T,leaves,F", PARTIAL_SHAPES)
def test_partial_scores_bitwise_match_jax(T, leaves, F):
    """Per-tree columns of the port's plain QuickScorer version, of its
    descent, and of the wrapper on CPU tensors equal JAX's bit for bit, dead
    slots included (zero columns)."""
    jens = jax_bestfirst(T, leaves, F, seed=leaves)
    jens = jens.replace(num_trees=jnp.asarray(T - 1, jnp.int32))  # one dead slot
    pens = _port(jens)
    X = _features(257, F, seed=T)
    md = int(tree_depths(pens).max()) + 1
    want = np.asarray(jax_partial_scores(jnp.asarray(X), jens, max_depth=md))
    if leaves <= 64:
        want_qs = np.asarray(jax_qs.partial_scores_qs(jnp.asarray(X),
                                                      jax_qs.ensemble_to_qs(jens)))
        np.testing.assert_array_equal(want_qs, want)
    tables = qs.ensemble_to_qs(pens)
    Xt = torch.from_numpy(X)
    got_qs = qs.partial_scores_qs(Xt, tables).numpy()
    got_descent = partial_scores(Xt, pens, max_depth=md).numpy()
    got_wrapper = kernel_qs.partial_scores_qs(Xt, tables).numpy()
    assert got_qs.shape == want.shape == (257, T)
    np.testing.assert_array_equal(got_qs, want)
    np.testing.assert_array_equal(got_descent, want)
    np.testing.assert_array_equal(got_wrapper, want)
    assert not want[:, T - 1].any()


def test_partial_scores_qs_slot_range():
    """A range of slots is those columns of the whole, and the plain
    scorer's weighted Kahan sum is rebuilt from the columns to float32
    rounding."""
    ens = random_bestfirst_ensemble(20, 16, 12, seed=3)
    tables = qs.ensemble_to_qs(ens)
    X = torch.from_numpy(_features(300, 12, seed=3))
    whole = kernel_qs.partial_scores_qs(X, tables)
    assert torch.equal(kernel_qs.partial_scores_qs(X, tables, 5, 13), whole[:, 5:13])
    assert kernel_qs.partial_scores_qs(X, tables, 7, 7).shape == (300, 0)
    summed = (whole.double() * tables.weight.double()).sum(1)
    np.testing.assert_allclose(qs.score_qs(X, tables).numpy(), summed.numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="slots"):
        kernel_qs.partial_scores_qs(X, tables, 3, 21)
    with pytest.raises(ValueError, match="device"):
        kernel_qs.partial_scores_qs(X.to("meta"), tables.to("meta"))


def _bin_ensemble(T, leaves, F, seed):
    ens = random_bestfirst_ensemble(T, leaves, F, seed=seed)
    rng = np.random.default_rng(seed)
    ens.threshold_bin = torch.from_numpy(
        rng.integers(0, 255, size=tuple(ens.threshold.shape)).astype(np.int32))
    return ens


@pytest.mark.parametrize("leaves", [16, 100])
def test_table_grown_one_tree_at_a_time_equals_pack_tables(leaves):
    """Rows of tree_to_qs_row pushed one tree at a time, and DART's
    DropTable fed the same way, equal pack_tables(ensemble_to_qs(ens,
    "bin")) byte for byte after every push (dead rows included)."""
    src = _bin_ensemble(9, leaves, 20, seed=leaves)
    ens = EnsembleTensors.empty(12, src.max_nodes)
    grown = qs.pack_tables(qs.ensemble_to_qs(ens, space="bin"))
    table = DropTable(ens, "cpu")
    for t in range(src.num_trees):
        tree, w = src.tree(t), float(src.weight[t])
        ens.push(tree, w)
        grown[t] = qs.tree_to_qs_row(tree, w)
        table.append(t, tree, w)
        want = qs.pack_tables(qs.ensemble_to_qs(ens, space="bin"))
        assert torch.equal(grown, want), t
        assert torch.equal(table.rows, want), t
    # and the rows read back as the tables they came from
    back = qs.table_from_packed(grown, src.max_nodes)
    full = qs.ensemble_to_qs(ens, space="bin")
    for f in ("fid", "thr", "excl", "leafval", "weight"):
        assert torch.equal(getattr(back, f), getattr(full, f)), f


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def model_path(splits, tmp_path_factory):
    """One JAX LambdaMART model, saved; each test loads it in both packages."""
    train, _, _ = splits
    j = JaxLambdaMart(ntrees=6, nleaves=16, nthresholds=32, seed=1, esr=0)
    j.learn(train, None, verbose=False)
    path = os.path.join(tmp_path_factory.mktemp("partial"), "m.xml")
    j.save(path)
    return path


def test_partial_scores_dataset_matches_jax(model_path, splits):
    test = splits[2]
    want = np.asarray(JaxLTRAlgorithm.load(model_path).partial_scores_dataset(test))
    got = LTRAlgorithm.load(model_path).partial_scores_dataset(_port_ds(test), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (test.num_docs, 6)
    np.testing.assert_array_equal(got, want)


def test_update_weights_matches_jax(model_path, splits):
    """Zero-weighted trees are dropped and the rest keep their order, in
    both packages, and the two score the test fold the same."""
    test = splits[2]
    jm, pm = JaxLTRAlgorithm.load(model_path), LTRAlgorithm.load(model_path)
    w = np.asarray(jm.get_weights()).copy()
    w[[1, 4]] = 0.0
    w[2] = 0.37
    jm.update_weights(w)
    pm.update_weights(w)
    assert pm.ensemble.num_trees == int(jm.ensemble.num_trees) == 4
    for f in FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(pm.ensemble, f).numpy(),
                                      np.asarray(getattr(jm.ensemble, f)), f)
    np.testing.assert_array_equal(pm.get_weights(), np.asarray(jm.get_weights()))
    np.testing.assert_array_equal(pm.score_dataset(_port_ds(test), device="cpu"),
                                  np.asarray(jm.score_dataset(test)))


@pytest.mark.parametrize("num_features,normalize", [(None, True), (40, False), (3, True)])
def test_feature_importances_match_jax(model_path, num_features, normalize):
    jm, pm = JaxLTRAlgorithm.load(model_path), LTRAlgorithm.load(model_path)
    got = pm.feature_importances(num_features, normalize)
    np.testing.assert_array_equal(got, jm.feature_importances(num_features, normalize))
    assert got.dtype == np.float64 and got.sum() > 0


def test_oblivious_partial_scores_dataset_matches_jax(splits, tmp_path):
    """ObliviousMart inherits partial_scores_dataset in both packages: the
    columns of its stored perfect trees, bitwise JAX's."""
    from quickrank_tpu.learning.obliviousmart import (
        ObliviousLambdaMart as JaxObliviousLambdaMart,
    )
    from quickrank_tpu_torch.learning.obliviousmart import ObliviousLambdaMart

    train, _, test = splits
    j = JaxObliviousLambdaMart(ntrees=4, treedepth=3, nthresholds=32, seed=1, esr=0)
    j.learn(train, None, verbose=False)
    path = str(tmp_path / "obv.xml")
    j.save(path)
    p = LTRAlgorithm.load(path)
    assert type(p) is ObliviousLambdaMart
    got = p.partial_scores_dataset(_port_ds(test), device="cpu")
    np.testing.assert_array_equal(got, np.asarray(JaxLTRAlgorithm.load(path)
                                                  .partial_scores_dataset(test)))


def test_learner_hooks(splits):
    """Mart.learn calls _post_init once, _update_presence before and
    _post_iteration after every iteration (JAX mart.py:854, 919, 959); a
    pool of every doc trains the trees of no pool, and a smaller pool other
    trees."""
    from quickrank_tpu_torch.learning.lambdamart import LambdaMart
    from quickrank_tpu_torch.metrics.metrics import Ndcg

    calls = []

    class Hooked(LambdaMart):
        pool = "all"

        def _post_init(self, tr):
            calls.append(("init", tr.padded.num_docs_padded))

        def _update_presence(self, m, tr, scores_tr, generator):
            calls.append(("presence", m))
            if self.pool == "all":
                return tr.step.doc_mask.clone()
            return tr.step.doc_mask & (torch.arange(tr.step.doc_mask.shape[0]) % 2 == 0)

        def _post_iteration(self, m, improved):
            calls.append(("post", m, improved))

    train = _port_ds(splits[0])
    kw = dict(ntrees=3, nleaves=8, nthresholds=32, seed=1)
    plain = LambdaMart(**kw)
    plain.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    hooked = Hooked(**kw)
    hooked.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    assert [c[:2] for c in calls] == [("init", calls[0][1]), ("presence", 0), ("post", 0),
                                      ("presence", 1), ("post", 1), ("presence", 2),
                                      ("post", 2)]
    for f in FIELDS[:-1]:
        assert torch.equal(getattr(hooked.ensemble, f), getattr(plain.ensemble, f)), f
    half = Hooked(**kw)
    half.pool = "half"
    half.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    assert not torch.equal(half.ensemble.leaf_value, plain.ensemble.leaf_value)
