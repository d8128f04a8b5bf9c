"""Warm start in the port (quickrank_tpu_torch/learning/mart.py:
``learn(warm_start=True)``, ``rebin_ensemble``, ``rescore_binned``,
``_copy_into``; trees/qs.py bin-space tables) on the CPU, after
tests/test_algorithms.py's warm-start tests and against the JAX package.

The rescoring pass keeps the fused Kahan step of the training carry, so it
reproduces the carried scores bit for bit, by the per-tree descent scan and
through bin-space QuickScorer tables alike."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data.synthetic import make_train_valid_test as jax_splits
from quickrank_tpu.learning.mart import rebin_ensemble as jax_rebin_ensemble
from quickrank_tpu.trees.qs import ensemble_to_qs as jax_ensemble_to_qs
from quickrank_tpu.trees.qs import score_qs as jax_score_qs
from quickrank_tpu.trees.structs import EnsembleTensors as JaxEnsemble
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
from quickrank_tpu_torch.learning import LambdaMart, LTRAlgorithm, ObliviousLambdaMart
from quickrank_tpu_torch.learning.mart import TrainData, rebin_ensemble, rescore_binned
from quickrank_tpu_torch.metrics.metrics import Ndcg
from quickrank_tpu_torch.ops import kernel_qs
from quickrank_tpu_torch.ops.binning import build_thresholds
from quickrank_tpu_torch.trees.qs import ensemble_to_qs, score_qs
from quickrank_tpu_torch.trees.structs import FIELDS

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

KW = dict(nleaves=8, nthresholds=32, seed=1)


@pytest.fixture(scope="module")
def folds():
    tr, va, _ = jax_splits(num_queries=(36, 12, 12), num_features=20)
    return tuple(Dataset(d.features, d.labels, d.query_offsets, d.qids) for d in (tr, va))


@pytest.fixture(scope="module")
def model(folds):
    lm = LambdaMart(ntrees=4, **KW)
    lm.learn(folds[0], None, Ndcg(10), verbose=False, device="cpu")
    return lm


def _jax_ens(ens):
    h = ens.numpy()
    return JaxEnsemble(**{k: jnp.asarray(h[k]) for k in FIELDS})


def test_warm_start_continues(folds, model):
    lm = LambdaMart(ntrees=7, **KW)
    lm.ensemble = model.ensemble
    info = lm.learn(folds[0], None, Ndcg(10), verbose=False, device="cpu", warm_start=True)
    assert model.ensemble.num_trees == 4 and lm.ensemble.num_trees == 7
    assert len(info["train"]) == 3  # only the new iterations
    for k in ("feature", "threshold", "leaf_value"):
        np.testing.assert_array_equal(getattr(lm.ensemble, k)[:4].numpy(),
                                      getattr(model.ensemble, k).numpy(), k)
    # without warm_start the model is dropped and training starts over
    again = LambdaMart(ntrees=4, **KW)
    again.ensemble = model.ensemble
    assert len(again.learn(folds[0], None, Ndcg(10), verbose=False,
                           device="cpu")["train"]) == 4


def test_warm_start_equals_uninterrupted_run(folds, model):
    """4 trees and then 3 more against 7 in one go: the restart's scores are
    the carried ones bit for bit, so the first new tree is the same tree, and
    train NDCG@10 ends within 1e-4 (the Kahan term restarts at zero, so later
    trees may differ in the last bits of their gradients)."""
    lm = LambdaMart(ntrees=7, **KW)
    lm.ensemble = model.ensemble
    resumed = lm.learn(folds[0], None, Ndcg(10), verbose=False, device="cpu",
                       warm_start=True)
    whole = LambdaMart(ntrees=7, **KW)
    straight = whole.learn(folds[0], None, Ndcg(10), verbose=False, device="cpu")
    for k in ("feature", "threshold_bin", "left", "right"):
        np.testing.assert_array_equal(getattr(lm.ensemble, k)[4].numpy(),
                                      getattr(whole.ensemble, k)[4].numpy(), k)
    np.testing.assert_allclose(resumed["train"], straight["train"][4:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_valid", [False, True])
def test_rescore_equals_carried_scores_bitwise(folds, with_valid):
    """The descent scan and the bin-space QuickScorer tables both reproduce
    the scores training carried, bit for bit, on the binned matrix."""
    lm = LambdaMart(ntrees=5, esr=2, **KW)
    lm.learn(folds[0], folds[1] if with_valid else None, Ndcg(10), verbose=False,
             device="cpu")
    td = TrainData.build(folds[0], 32, device="cpu")
    ens = rebin_ensemble(lm.ensemble, td.thresholds, force=True)
    scan = rescore_binned(ens, td.step, lm._descend_depth())
    np.testing.assert_array_equal(scan.numpy(), lm.train_scores.numpy())
    tables = ensemble_to_qs(ens, space="bin")
    before = kernel_qs.LAUNCHES
    by_qs = kernel_qs.score_qs(td.step.binned, tables)  # u8 bins, plain version here
    assert kernel_qs.LAUNCHES == before and td.step.binned.dtype == torch.uint8
    np.testing.assert_array_equal(by_qs.numpy(), scan.numpy())
    np.testing.assert_array_equal(score_qs(td.step.binned.float(), tables).numpy(),
                                  scan.numpy())


def test_bin_space_tables_match_jax(folds, model):
    td = TrainData.build(folds[0], 32, device="cpu")
    ens = rebin_ensemble(model.ensemble, td.thresholds, force=True)
    a, b = ensemble_to_qs(ens, space="bin"), jax_ensemble_to_qs(_jax_ens(ens), space="bin")
    T, I = a.fid.shape
    np.testing.assert_array_equal(a.fid.numpy(), np.asarray(b.fid)[:T])
    np.testing.assert_array_equal(a.thr.numpy(), np.asarray(b.thr)[:T])
    np.testing.assert_array_equal(a.leafval.numpy(), np.asarray(b.leafval)[:T])
    want = np.asarray(jax_score_qs(jnp.asarray(td.step.binned.numpy()), b))
    np.testing.assert_array_equal(score_qs(td.step.binned, a).numpy(), want)
    with pytest.raises(ValueError, match="space"):
        ensemble_to_qs(ens, space="bins")


def test_warm_start_rebins_against_new_tables(folds, model):
    """Every bin-space split id is recomputed against the resumed run's
    tables; against the same tables that changes nothing; JAX's
    ``rebin_ensemble`` gives the same ids."""
    ens = model.ensemble
    other = make_ranking_dataset(num_queries=40, avg_docs_per_query=25, num_features=20,
                                 seed=77)
    thrB, _ = build_thresholds(other.features, 32)
    re = rebin_ensemble(ens, thrB, force=True)
    h = ens.numpy()
    checked = 0
    for t in range(ens.num_trees):
        for n in range(ens.max_nodes):
            if h["is_leaf"][t, n] or h["feature"][t, n] < 0:
                continue
            want = max(int((thrB[h["feature"][t, n]] <= h["threshold"][t, n]).sum()) - 1, 0)
            assert int(re.threshold_bin[t, n]) == want
            checked += 1
    assert checked > 0
    assert not torch.equal(re.threshold_bin, ens.threshold_bin)
    np.testing.assert_array_equal(
        re.threshold_bin.numpy(),
        np.asarray(jax_rebin_ensemble(_jax_ens(ens), thrB, force=True).threshold_bin))
    thrA, _ = build_thresholds(folds[0].features, 32)
    same = rebin_ensemble(ens, thrA, force=True)
    np.testing.assert_array_equal(same.threshold_bin.numpy(), ens.threshold_bin.numpy())
    assert rebin_ensemble(ens, thrB) is ens  # nothing missing: nothing to fill
    # end to end: a warm start on the other dataset stays sane
    lm = LambdaMart(ntrees=6, **KW)
    lm.ensemble = ens
    info = lm.learn(other, None, Ndcg(10), verbose=False, device="cpu", warm_start=True)
    assert np.isfinite(info["train"]).all() and lm.ensemble.num_trees == 6


def test_save_load_restart_continues_identically(folds, model, tmp_path):
    """A loaded model carries no bin ids (-1) and pre-order node numbers; the
    restart rebuilds the bins and continues as the in-process restart does."""
    path = os.path.join(tmp_path, "m.xml")
    model.save(path)
    loaded = LTRAlgorithm.load(path)
    assert int(loaded.ensemble.threshold_bin.max()) == -1
    loaded.ntrees = 6
    a = loaded.learn(folds[0], folds[1], Ndcg(10), verbose=False, device="cpu",
                     warm_start=True)
    inproc = LambdaMart(ntrees=6, **KW)
    inproc.ensemble = model.ensemble
    b = inproc.learn(folds[0], folds[1], Ndcg(10), verbose=False, device="cpu",
                     warm_start=True)
    np.testing.assert_array_equal(a["train"], b["train"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert loaded.best_iteration == inproc.best_iteration >= 4
    np.testing.assert_array_equal(loaded.train_scores.numpy(), inproc.train_scores.numpy())


def test_warm_start_needs_room_for_the_model(folds, model):
    lm = LambdaMart(ntrees=3, **KW)
    lm.ensemble = model.ensemble
    with pytest.raises(ValueError, match="raise ntrees"):
        lm.learn(folds[0], None, Ndcg(10), verbose=False, device="cpu", warm_start=True)


def test_oblivious_warm_start(folds):
    ol = ObliviousLambdaMart(ntrees=2, treedepth=3, nthresholds=32, seed=1)
    ol.learn(folds[0], None, Ndcg(10), verbose=False, device="cpu")
    carried = ol.train_scores.clone()
    ol.ntrees = 4
    info = ol.learn(folds[0], None, Ndcg(10), verbose=False, device="cpu", warm_start=True)
    assert ol.ensemble.num_trees == 4 and len(info["train"]) == 2
    td = TrainData.build(folds[0], 32, device="cpu")
    first_two = ol.ensemble.live()
    first_two.num_trees = 2
    first_two = first_two.live()
    np.testing.assert_array_equal(
        rescore_binned(first_two, td.step, ol._descend_depth()).numpy(), carried.numpy())
