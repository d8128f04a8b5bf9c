"""The port's scoring slice end to end on the CPU: SVML + XML model ->
``quickrank_tpu_torch.quickscore`` -> scores file, held against the JAX
package's ``load(...).score_dataset(ds)`` on the same files."""

import numpy as np
import pytest
import torch

from quickrank_tpu.data.svml import read_svml as jax_read_svml
from quickrank_tpu.data.synthetic import (
    make_ranking_dataset as jax_make_ranking_dataset,
)
from quickrank_tpu.learning import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.metrics.metrics import Ndcg
from quickrank_tpu_torch import quickscore
from quickrank_tpu_torch.data.svml import read_svml, write_svml
from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
from quickrank_tpu_torch.learning import LambdaMart, Mart
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.trees import random_ensemble
from quickrank_tpu_torch.trees.perfect import tree_depths

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One SVML file and three XML models: a best-first 20 x 16-leaf model
    (QuickScorer path), a balanced 20 x depth-4 model (perfect path), and a
    small LambdaMART trained by the JAX package."""
    d = tmp_path_factory.mktemp("slice")
    svml = str(d / "data.svml")
    write_svml(make_ranking_dataset(num_queries=12, avg_docs_per_query=24,
                                    num_features=136, seed=3), svml)
    models = {}
    for name, ens in (
        ("bestfirst", random_ensemble.random_bestfirst_ensemble(20, 16, 136, seed=1)),
        ("balanced", random_ensemble.random_balanced_ensemble(20, 4, 136, seed=2)),
    ):
        m = LambdaMart()
        m.ensemble = ens
        models[name] = str(d / f"{name}.xml")
        m.save(models[name])
    # the configuration of tests/test_qs.py's trained model
    train = jax_make_ranking_dataset(num_queries=40, avg_docs_per_query=20, seed=0)
    lm = JaxLambdaMart(ntrees=10, nleaves=8, shrinkage=0.2, nthresholds=63,
                       esr=0, seed=3)
    lm.learn(train, None, Ndcg(10), verbose=False)
    models["trained"] = str(d / "trained.xml")
    lm.save(models["trained"])
    return svml, models, d


def _run(svml, model, out, capsys):
    assert quickscore.main(["-d", svml, "-m", model, "-r", "2",
                            "--device", "cpu", "-s", out]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["bestfirst", "balanced", "trained"])
def test_quickscore_matches_jax(files, name, capsys):
    """Scores file equals JAX's score_dataset (its compensated descent on
    the CPU): bitwise on the QuickScorer path, to float32 summation
    tolerance on the perfect path."""
    svml, models, d = files
    out = str(d / f"{name}.scores")
    printed = _run(svml, models[name], out, capsys)
    got = np.loadtxt(out).astype(np.float32)
    want = JaxLTRAlgorithm.load(models[name]).score_dataset(jax_read_svml(svml))

    model = LTRAlgorithm.load(models[name])
    # the trained model's trees reach depth 7: QuickScorer, like best-first
    deep = {"bestfirst": True, "balanced": False, "trained": True}[name]
    assert (tree_depths(model.ensemble).max() > 5) == deep
    assert model.scorer_path() == ("qs" if deep else "perfect")
    assert ("QuickScorer kernel" if deep else "perfect-tree kernel") in printed
    assert "Avg.    Doc. scoring time" in printed
    assert got.shape == want.shape == (read_svml(svml).num_docs,)
    if deep:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(
            got, want, atol=2e-6 * max(1.0, np.abs(want).max()), rtol=0)
    np.testing.assert_array_equal(
        got, model.score_dataset(read_svml(svml), device="cpu"))


def test_quickscore_refuses_unported_type(files, capsys):
    """Every ranker type the JAX package writes is served now: a RankBoost
    model scores its weak rankers (quickscore's -s equals score_dataset);
    a type neither package knows is refused."""
    from quickrank_tpu_torch.learning import RankBoost

    svml, models, d = files
    rb = RankBoost(ntrees=3)
    rb.best_T, rb.features_ = 2, np.asarray([0, 5], np.int32)
    rb.thetas_ = np.asarray([0.0, -0.5], np.float32)
    rb.signs_, rb.alphas_ = np.ones(2, np.int32), np.asarray([0.75, 0.25], np.float32)
    rb.save(str(d / "rankboost.xml"))
    out = d / "rankboost.scores"
    assert quickscore.main(["-d", svml, "-m", str(d / "rankboost.xml"), "-r", "1",
                            "--device", "cpu", "-s", str(out)]) == 0
    assert "Scorer path: RankBoost weak rankers" in capsys.readouterr().out
    want = rb.score_dataset(read_svml(svml), device="cpu")
    np.testing.assert_allclose(np.loadtxt(out), want, rtol=1e-14, atol=0)
    bad = d / "nosuch.xml"
    with open(models["balanced"]) as f:
        bad.write_text(f.read().replace("<type>LAMBDAMART</type>", "<type>NOSUCH</type>"))
    with pytest.raises(ValueError, match="unknown ranker type"):
        quickscore.main(["-d", svml, "-m", str(bad), "--device", "cpu"])


def test_quickscore_cuda_without_card_is_an_error(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    svml, models, _ = files
    with pytest.raises(SystemExit) as e:
        quickscore.main(["-d", svml, "-m", models["bestfirst"], "--device", "cuda"])
    assert e.value.code != 0


def test_svml_round_trip_matches_jax_reader(files):
    svml, _, _ = files
    a, b = read_svml(svml), jax_read_svml(svml)
    for k in ("features", "labels", "query_offsets", "qids"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    from quickrank_tpu_torch.data.svml import _read_numpy

    c = _read_numpy(svml)
    np.testing.assert_array_equal(a.features, c.features)
    np.testing.assert_array_equal(a.query_offsets, c.query_offsets)


def test_synthetic_matches_jax():
    a = make_ranking_dataset(num_queries=9, avg_docs_per_query=15,
                             num_features=12, seed=5)
    b = jax_make_ranking_dataset(num_queries=9, avg_docs_per_query=15,
                                 num_features=12, seed=5)
    for k in ("features", "labels", "query_offsets", "qids"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_mart_type_round_trip(files, tmp_path):
    _, models, _ = files
    m = LTRAlgorithm.load(models["bestfirst"])
    m2 = Mart(ntrees=3)
    m2.ensemble = m.ensemble
    m2.save(str(tmp_path / "m.xml"))
    assert type(LTRAlgorithm.load(str(tmp_path / "m.xml"))) is Mart
    np.testing.assert_array_equal(m.get_weights(), np.full(20, 0.1, np.float32))
