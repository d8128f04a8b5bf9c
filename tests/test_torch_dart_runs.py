"""DART / X-DART in the port against the JAX package on the CPU, part two:
whole training runs, snapshots and resumes, and quicklearn --algo DART.

Every normalization is held in a short run against JAX's.  Those runs give
the port JAX's lambda gradients (``_JaxLambdas``): the port's own lambdas
differ from XLA's in the last bit (tests/test_torch_train.py), and DART turns
such bits into other trees.  Subtracting a dropped tree's delta leaves docs
that tie in the kept trees a last bit apart, their rank order then follows
those bits, and the lambdas with it.  With JAX's lambdas the runs hold
everything else: the dropped sets, the tree weights of each normalization,
the deltas and the restored scores.  ``test_port_run_tracks_jax`` runs the
port as it is, and holds it to what survives that: the same dropped sets,
JAX's NDCG@10 until the first drop, and the same quality.

Runs are 4 trees of 8 leaves at 32 thresholds with ``subsample`` and
``max_features`` 1 (no ``jax.random`` draw matters) and ``rate_drop`` 1, so
one tree is dropped from iteration 3 on."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.dart import Dart as JaxDart
from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu_torch import cli
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.data.svml import read_svml, write_svml
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.dart import NORMALIZATION_TYPES, Dart
from quickrank_tpu_torch.metrics.metrics import Ndcg

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


class _JaxLambdas(Dart):
    """The port's DART fed JAX's lambda gradients of the same scores."""

    def _gradients(self, sd, scores, sample_mask, full_mask=False):
        names = ("labels2d", "doc_mask", "pad_index", "inv_q", "inv_slot", "slot_mask",
                 "nvalid")
        jsd = SimpleNamespace(**{k: jnp.asarray(getattr(sd, k).numpy()) for k in names})
        me = SimpleNamespace(_train_metric=JaxNdcg(10), query_chunk=None)
        g, w = JaxLambdaMart._gradients(me, jsd, jnp.asarray(scores.numpy()),
                                        jnp.asarray(sample_mask.numpy()), None)
        return torch.tensor(np.asarray(g)), torch.tensor(np.asarray(w))


def _jax_run(kw, train, valid):
    """JAX's run, with the dropped sets it drew."""
    j = JaxDart(**kw)
    drawn = []
    count, select = j._trees_to_dropout, j._select_dropout

    def trees_to_dropout(*a):  # once an iteration
        drawn.append([])
        return count(*a)

    def select_dropout(*a):
        drawn[-1] = select(*a)
        return drawn[-1]

    j._trees_to_dropout, j._select_dropout = trees_to_dropout, select_dropout
    h = j.learn(train, valid, JaxNdcg(10), verbose=False)
    return j, h, drawn


_KW = dict(ntrees=4, nleaves=8, nthresholds=32, rate_drop=1, seed=3, esr=0)
#: every normalization, plus JAX's QS delta path (QRTPU_DART_QS_DELTA), a
#: keep_drop run and a run with several trees dropped an iteration
RUNS = [(n, {}) for n in NORMALIZATION_TYPES] + [
    ("TREE", {"qs_delta": True}),
    ("TREE", {"keep_drop": True, "random_keep": 0.5}),
    ("FOREST", {"rate_drop": 0.5, "sample_type": "WEIGHTED", "ntrees": 6}),
]


@pytest.mark.parametrize("norm,extra", RUNS,
                         ids=[f"{n}-{'-'.join(e) or 'default'}" for n, e in RUNS])
def test_normalization_run_matches_jax(norm, extra, splits, monkeypatch):
    """The same dropped sets in every iteration, and train and valid
    NDCG@10 within 1e-4 of JAX's for the first three iterations (the third
    is the first with a drop)."""
    train, valid, _ = splits
    extra = dict(extra)
    if extra.pop("qs_delta", False):
        monkeypatch.setenv("QRTPU_DART_QS_DELTA", "force")  # the JAX side only
    kw = {**_KW, "normalize_type": norm, **extra}
    _, jh, jax_dropped = _jax_run(kw, train, valid)
    ph = _JaxLambdas(**kw).learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False,
                                 device="cpu")
    assert ph["dropped"] == jax_dropped
    assert ph["dropped"][2], "no tree was dropped at iteration 3"
    for key in ("train", "valid"):
        np.testing.assert_allclose(ph[key][:3], jh[key][:3], rtol=0, atol=1e-4)
    assert len(ph["train"]) == len(jh["train"])


def test_port_run_tracks_jax(splits):
    """The port with its own lambdas: the same dropped sets, JAX's NDCG@10
    until the first drop, and at the end of a 12-tree run the quality of
    JAX's DART test (test NDCG@10 >= 0.55) within 0.05 of JAX's.  After a
    drop the last bits of the lambdas move the trees (module note): over
    seeds 3 to 6 the two runs end 0.047, 0.003, 0.001 and 0.002 apart on
    this test fold, while the port given JAX's lambdas ends equal to JAX in
    all four."""
    train, valid, test = splits
    kw = {**_KW, "ntrees": 12}
    j, jh, jax_dropped = _jax_run(kw, train, valid)
    p = Dart(**kw)
    ph = p.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False, device="cpu")
    assert ph["dropped"] == jax_dropped
    first = next(i for i, d in enumerate(jax_dropped) if d)
    for key in ("train", "valid"):
        np.testing.assert_allclose(ph[key][:first], jh[key][:first], rtol=0, atol=1e-4)
    ndcg = p.evaluate(_port_ds(test), Ndcg(10), device="cpu")
    assert ndcg >= 0.55
    assert abs(ndcg - j.evaluate(test, JaxNdcg(10))) <= 0.05
    assert ph["train"][-1] > ph["train"][0]


def test_partial_saves_and_resume(splits, tmp_path):
    """DART snapshots (<base>.T<k>.xml) and a resume from one, as JAX's
    test_dart_partial_saves_and_resume drives them."""
    train = _port_ds(splits[0])
    base = str(tmp_path / "dart")
    kw = dict(ntrees=6, nleaves=4, nthresholds=16, seed=3, rate_drop=0.3)
    Dart(**kw).learn(train, None, Ndcg(10), verbose=False, device="cpu", partial_save=2,
                     output_basename=base)
    snaps = sorted(p for p in os.listdir(tmp_path) if ".T" in p)
    assert snaps == ["dart.T2.xml", "dart.T4.xml", "dart.T6.xml"]
    partial = LTRAlgorithm.load(str(tmp_path / "dart.T4.xml"))
    assert type(partial) is Dart
    n0 = partial.ensemble.num_trees
    resumed = Dart(**kw)
    resumed.import_model_state(partial)
    info = resumed.learn(train, None, Ndcg(10), verbose=False, device="cpu", warm_start=True)
    # the rollback keeps the best model, never worse than the imported one
    assert resumed.ensemble.num_trees >= n0
    assert info["train"] and np.isfinite(resumed.score_dataset(train, device="cpu")).all()


def test_quicklearn_dart_partial_detailed_restart(splits, tmp_path):
    """quicklearn --algo DART on the CPU: snapshots every 2 iterations, a
    model JAX loads, --detailed per-tree scores bitwise JAX's
    partial_scores_dataset of that model, and --restart-train from a
    snapshot."""
    train, valid, test = splits
    paths = {n: str(tmp_path / f"{n}.svml") for n in ("train", "valid", "test")}
    for n, d in zip(paths, (train, valid, test)):
        write_svml(_port_ds(d), paths[n])
    model, detailed = str(tmp_path / "dart.xml"), str(tmp_path / "detailed.svml")
    common = ["--algo", "DART", "--num-trees", "6", "--num-leaves", "8",
              "--num-thresholds", "32", "--rate-drop", "0.3", "--device", "cpu", "--quiet"]
    rc = cli.main(common + ["--train", paths["train"], "--valid", paths["valid"],
                            "--test", paths["test"], "--partial", "2", "--model-out", model,
                            "--detailed", detailed])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "dart.T2.xml"))
    jm = JaxLTRAlgorithm.load(model)
    assert type(jm) is JaxDart
    cols = read_svml(detailed)
    want = np.asarray(jm.partial_scores_dataset(read_svml(paths["test"])))
    np.testing.assert_array_equal(cols.features, want)
    np.testing.assert_array_equal(cols.labels, test.labels)
    resumed = str(tmp_path / "resumed.xml")
    rc = cli.main(common + ["--train", paths["train"], "--model-in",
                            str(tmp_path / "dart.T2.xml"), "--restart-train",
                            "--model-out", resumed])
    assert rc == 0
    back = LTRAlgorithm.load(resumed)
    assert type(back) is Dart
    assert back.ensemble.num_trees >= LTRAlgorithm.load(
        str(tmp_path / "dart.T2.xml")).ensemble.num_trees
