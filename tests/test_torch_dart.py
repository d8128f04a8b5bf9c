"""DART / X-DART in the port (quickrank_tpu_torch/learning/dart.py) against
the JAX package on the CPU, part one: the host machinery called on the same
inputs and random state in both packages (the 10 samplers, the 8 schedules,
C rounding, the compaction with its best-snapshot protection), the
dropped-set delta against both of JAX's formulations, the warm start's
per-tree contributions, and DART XML both ways.  Whole training runs are in
``tests/test_torch_dart_runs.py``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.dart import Dart as JaxDart
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.learning.mart import rebin_ensemble as jax_rebin
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu.ops.scoring import tree_delta_binned as jax_tree_delta
from quickrank_tpu.trees import qs as jax_qs
from quickrank_tpu.trees.structs import EnsembleTensors as JaxEnsemble
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.dart import (
    ADAPTIVE_TYPES,
    NORMALIZATION_TYPES,
    SAMPLING_TYPES,
    Dart,
    DropTable,
)
from quickrank_tpu_torch.learning.mart import TrainData, rebin_ensemble
from quickrank_tpu_torch.metrics.metrics import Ndcg
from quickrank_tpu_torch.trees import qs
from quickrank_tpu_torch.trees.random_ensemble import random_bestfirst_ensemble
from quickrank_tpu_torch.trees.structs import FIELDS, EnsembleTensors

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


def _jax_ens(ens: EnsembleTensors) -> JaxEnsemble:
    h = ens.numpy()
    return JaxEnsemble(**{k: jnp.asarray(h[k]) for k in FIELDS[:-1]},
                       num_trees=jnp.asarray(h["num_trees"], jnp.int32))


def test_option_tables_match_jax():
    from quickrank_tpu.learning import dart as jax_dart

    assert SAMPLING_TYPES == jax_dart.SAMPLING_TYPES
    assert NORMALIZATION_TYPES == jax_dart.NORMALIZATION_TYPES
    assert ADAPTIVE_TYPES == jax_dart.ADAPTIVE_TYPES
    with pytest.raises(ValueError, match="unknown DART option"):
        Dart(sample_type="NOPE")
    with pytest.raises(NotImplementedError, match="DataGroup .* or a parallel.mesh.Mesh2D"):
        Dart(ntrees=2).learn(None, mesh=object())


@pytest.mark.parametrize("sample_type", SAMPLING_TYPES)
def test_select_dropout_matches_jax(sample_type):
    """The same weights (a quarter of them zero), contributions, count and
    random state give the same dropped set and leave the same random state,
    over 40 draws of each."""
    j, p = JaxDart(sample_type=sample_type), Dart(sample_type=sample_type)
    data = np.random.default_rng(len(sample_type))
    for trial in range(40):
        T = int(data.integers(1, 40))
        w = data.uniform(0.01, 0.2, T).astype(np.float32)
        w[data.random(T) < 0.25] = 0.0
        contributions = [float(np.float32(c)) for c in data.uniform(0.0, 2.0, T)]
        k = int(data.integers(1, T + 1))
        ra, rb = np.random.default_rng(trial), np.random.default_rng(trial)
        want = j._select_dropout(ra, w, contributions, k)
        got = p._select_dropout(rb, w, contributions, k)
        assert got == want, (trial, T, k)
        assert ra.bit_generator.state == rb.bit_generator.state


@pytest.mark.parametrize("rate_drop", [0.1, 0.5, 3.0])
@pytest.mark.parametrize("adaptive_type", ADAPTIVE_TYPES)
def test_trees_to_dropout_matches_jax(adaptive_type, rate_drop):
    """A 60-step schedule with skips, model sizes that grow and shrink and a
    metric that improves and stalls: the same counts and factor history."""
    kw = dict(adaptive_type=adaptive_type, rate_drop=rate_drop, skip_drop=0.2)
    j, p = JaxDart(**kw), Dart(**kw)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    fa, fb, perf = [0.0], [0.0], [0.0]
    best = -np.inf
    data = np.random.default_rng(8)
    for step in range(60):
        size = int(data.integers(0, 50))
        want = j._trees_to_dropout(ra, size, fa, list(perf), best)
        got = p._trees_to_dropout(rb, size, fb, list(perf), best)
        assert got == want, step
        assert fb == fa
        m = float(data.choice([best if np.isfinite(best) else 0.5, data.random()]))
        perf.append(m)
        best = max(best, m)


def test_dropout_rounding_matches_reference():
    """dart.cc:1176-1181: C round() (half away from zero) and an integer
    half-model cap, as JAX's test_dart_dropout_rounding_matches_reference."""

    class _R:  # a random state whose skip draw never skips
        def random(self):
            return 1.0

    assert Dart(rate_drop=0.1)._trees_to_dropout(_R(), 25, [0.0], [0.0], -np.inf) == 3
    assert Dart(rate_drop=0.5)._trees_to_dropout(_R(), 7, [0.0], [0.0], -np.inf) == 3
    assert Dart(rate_drop=0.5)._trees_to_dropout(_R(), 5, [0.0], [0.0], -np.inf) == 2


@pytest.mark.parametrize("protect", [0, 3])
def test_compaction_matches_jax_and_protects_best_snapshot(protect):
    """The compaction keeps zero-weighted trees inside the protected prefix,
    moves the kept slots to the head in order, as JAX's does, and takes the
    packed table with it."""
    cap, T = 8, 6
    ens = EnsembleTensors.empty(cap, 7)
    for t in range(T):
        tree = random_bestfirst_ensemble(1, 4, 5, seed=t).tree(0)
        tree.threshold_bin = torch.arange(7, dtype=torch.int32)
        ens.push(tree, 0.1)
    # the learner keeps the ensemble's weights equal to its host weights
    w_host = np.array([0.3, 0.0, 0.2, 0.0, 0.0, 0.4, 0.0, 0.0], np.float32)
    ens.weight = torch.from_numpy(w_host.copy())
    jens = _jax_ens(ens)
    contributions = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    table = DropTable(ens, "cpu")
    want = JaxDart._compact_zero_weights(jens, contributions, w_host, T, protect=protect)
    got = Dart._compact_zero_weights(ens, contributions, w_host, T, protect=protect,
                                     table=table)
    new_T = want[3]
    assert got[3] == new_T == (4 if protect else 3)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    for f in FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(got[0], f)[:new_T].numpy(),
                                      np.asarray(getattr(want[0], f))[:new_T], f)
    assert not got[0].weight[new_T:].any()
    assert torch.equal(table.rows, qs.pack_tables(qs.ensemble_to_qs(got[0], space="bin")))


def _bin_ensemble(T, leaves, F, seed):
    ens = random_bestfirst_ensemble(T, leaves, F, seed=seed)
    rng = np.random.default_rng(seed)
    ens.threshold_bin = torch.from_numpy(
        rng.integers(0, 255, size=tuple(ens.threshold.shape)).astype(np.int32))
    return ens


@pytest.mark.parametrize("dropped", [[5], [5, 1, 7], [11, 0, 3, 9, 2, 8, 6]])
def test_delta_matches_jax(dropped):
    """The port's delta (rows gathered from the packed table, Kahan chain in
    drop order) against JAX's descent scan (plain sum in drop order) and its
    QS path (QRTPU_DART_QS_DELTA: Kahan in slot order with zero weights on
    the kept slots): within 1e-6 * max(1, max|delta|), bitwise for one tree."""
    ens = _bin_ensemble(12, 16, 20, seed=len(dropped))
    ens.weight = torch.from_numpy(
        np.random.default_rng(1).uniform(0.02, 0.3, 12).astype(np.float32))
    jens = _jax_ens(ens)
    binned = np.random.default_rng(2).integers(0, 256, size=(700, 20)).astype(np.uint8)
    w = ens.weight.numpy()
    got = DropTable(ens, "cpu").delta(dropped, w[dropped], torch.from_numpy(binned)).numpy()
    scan = jnp.zeros((700,), jnp.float32)
    for t in dropped:
        scan = scan + w[t] * jax_tree_delta(jnp.asarray(binned), jens.tree(t), 16)
    qs_t = jax_qs.ensemble_to_qs(jens, space="bin")
    wvec = np.zeros(qs_t.weight.shape[0], np.float32)  # JAX pads to its scan group
    wvec[dropped] = w[dropped]
    via_qs = jax_qs.score_qs(jnp.asarray(binned), qs_t.replace(weight=jnp.asarray(wvec)))
    for want in (np.asarray(scan), np.asarray(via_qs)):
        tol = 1e-6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        if len(dropped) == 1:
            np.testing.assert_array_equal(got, want)


def test_delta_reads_the_weights_it_is_given():
    """The table's stored weight words are stale by design: every delta
    writes the weights it is given, so a changed weight changes the next
    delta, and the table itself is left as it was."""
    ens = _bin_ensemble(10, 16, 20, seed=4)
    table = DropTable(ens, "cpu")
    before = table.rows.clone()
    binned = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, size=(500, 20)).astype(np.uint8))
    w = np.array([0.1, 0.2, 0.3], np.float32)
    first = table.delta([2, 6, 4], w, binned)
    w[1] = 0.05
    second = table.delta([2, 6, 4], w, binned)
    assert not torch.equal(first, second)
    want = torch.zeros(500)
    for t, wt in zip([2, 6, 4], w):
        one = np.zeros(10, np.float32)
        one[t] = 1.0
        single = qs.ensemble_to_qs(ens, space="bin")
        single.weight = torch.from_numpy(one)
        want = want + wt * qs.score_qs(binned, single)
    np.testing.assert_allclose(second.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(table.rows, before)


@pytest.fixture(scope="module")
def jax_dart(splits, tmp_path_factory):
    """One JAX DART model, saved: (path, model)."""
    train, valid, _ = splits
    j = JaxDart(ntrees=6, nleaves=8, nthresholds=32, rate_drop=0.3, seed=1,
                sample_type="WCONTR", normalize_type="FOREST", keep_drop=True)
    j.learn(train, valid, JaxNdcg(10), verbose=False)
    path = os.path.join(tmp_path_factory.mktemp("dart"), "jax_dart.xml")
    j.save(path)
    return path, j


def test_warm_start_contributions_match_jax(jax_dart, splits):
    """The per-tree mean |output| a warm start rebuilds (from the per-tree
    columns of the packed table) equals JAX's _contribs_j bit for bit."""
    path, _ = jax_dart
    train = splits[0]
    jm = JaxLTRAlgorithm.load(path)
    jtd = JaxTrainData.build(train, 32)
    jens = jax_rebin(jm.ensemble, np.asarray(jtd.step.thresholds), force=True)
    n_real = jtd.padded.doc_mask.sum()
    want = np.asarray(JaxDart._contribs_j(jens, jtd.step.binned, jtd.step.doc_mask,
                                          jnp.float32(n_real), 16))
    pm = LTRAlgorithm.load(path)
    td = TrainData.build(_port_ds(train), 32, device="cpu")
    ens = rebin_ensemble(pm.ensemble, td.thresholds, force=True)
    got = Dart._contributions(DropTable(ens, "cpu"), ens.num_trees, td.step.binned,
                              td.step.doc_mask, int(td.padded.doc_mask.sum()))
    assert len(got) == ens.num_trees > 0
    np.testing.assert_array_equal(np.asarray(got, np.float32), want[: ens.num_trees])


def _scores_agree(port_model, got, want):
    if port_model.scorer_path() == "qs":
        np.testing.assert_array_equal(got, want)
    else:  # float32 sum against JAX's compensated descent
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * max(1.0, np.abs(want).max()))


def test_jax_dart_xml_loads_in_port(jax_dart, splits):
    path, j = jax_dart
    test = splits[2]
    p = LTRAlgorithm.load(path)
    assert type(p) is Dart
    for k in ("sample_type", "normalize_type", "adaptive_type", "rate_drop", "skip_drop",
              "keep_drop", "best_on_train", "random_keep", "drop_on_best", "nleaves"):
        assert getattr(p, k) == getattr(j, k), k
    _scores_agree(p, p.score_dataset(_port_ds(test), device="cpu"),
                  np.asarray(j.score_dataset(test)))


def test_port_dart_xml_loads_in_jax(splits, tmp_path):
    train, valid, test = splits
    p = Dart(ntrees=6, nleaves=8, nthresholds=32, rate_drop=0.3, seed=1,
             sample_type="TOP_FIFTY", normalize_type="WEIGHTED", adaptive_type="PLUS1_DIV2",
             drop_on_best=True, random_keep=0.25)
    p.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False, device="cpu")
    path = str(tmp_path / "port_dart.xml")
    p.save(path)
    j = JaxLTRAlgorithm.load(path)
    assert type(j) is JaxDart
    for k in ("sample_type", "normalize_type", "adaptive_type", "rate_drop",
              "random_keep", "drop_on_best", "keep_drop"):
        assert getattr(j, k) == getattr(p, k), k
    _scores_agree(p, p.score_dataset(_port_ds(test), device="cpu"),
                  np.asarray(j.score_dataset(test)))
    back = LTRAlgorithm.load(path)
    np.testing.assert_array_equal(back.score_dataset(_port_ds(test), device="cpu"),
                                  p.score_dataset(_port_ds(test), device="cpu"))
