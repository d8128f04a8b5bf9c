"""The port's AOT scorer export (quickrank_tpu_torch/io/export.py) against the
JAX package's (quickrank_tpu/io/export.py), on the CPU.

Each model is trained by the port on the ``splits`` fixture, saved as XML and
loaded by both packages; the port's ``torch.export`` archive, loaded back,
must score the test split bit for bit as JAX's StableHLO artifact does, at
any batch size, and load in a process that imports torch alone."""

import io
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from quickrank_tpu.cli import main as jax_main
from quickrank_tpu.io import export as jax_export
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.meta import MetaCleaver as JaxMetaCleaver
from quickrank_tpu.optimization.cleaver import Cleaver as JaxCleaver
from quickrank_tpu_torch.cli import main as port_main
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.io import export
from quickrank_tpu_torch.learning import (
    CoordinateAscent,
    Dart,
    LambdaMart,
    LineSearch,
    MetaCleaver,
    ObliviousMart,
    RankBoost,
)
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.optimization.cleaver import Cleaver
from quickrank_tpu_torch.trees.qs import ensemble_to_qs, score_qs
from quickrank_tpu_torch.trees.random_ensemble import random_bestfirst_ensemble

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

TREES = ("lambdamart", "oblivious", "dart", "metacleaver")
NAMES = TREES + ("coordasc", "linesearch", "rankboost")


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


def _learners():
    return {
        "lambdamart": LambdaMart(ntrees=5, nleaves=32, nthresholds=32, seed=1),
        "oblivious": ObliviousMart(ntrees=5, treedepth=3, nthresholds=32, seed=1),
        "dart": Dart(ntrees=5, nleaves=32, nthresholds=32, rate_drop=0.5, seed=1),
        "coordasc": CoordinateAscent(),
        "linesearch": LineSearch(),
        "rankboost": RankBoost(ntrees=5, nthresholds=16),
    }


def _wrap(name, model, jax: bool):
    """MetaCleaver scores through its inner ranker: wrap the LambdaMART."""
    if name != "metacleaver":
        return model
    return JaxMetaCleaver(model, JaxCleaver()) if jax else MetaCleaver(model, Cleaver())


@pytest.fixture(scope="module")
def models(splits, tmp_path_factory):
    """name -> (XML path, the port's model, JAX's model, JAX's artifact's
    scores of the test split): the tree models and RankBoost trained by the
    port, the linear models' weights drawn from a seed, each loaded by both
    packages from one XML file."""
    d = tmp_path_factory.mktemp("export")
    train = _port_ds(splits[0])
    X = splits[2].features.astype(np.float32)
    out = {}
    rng = np.random.default_rng(15)
    for name, model in _learners().items():
        if name in ("coordasc", "linesearch"):
            # a linear model's export reads its weights alone: seeded ones
            # spare the tier-1 time of a training run
            model.best_weights = rng.standard_normal(train.num_features)
        else:
            model.learn(train, None, Ndcg(10), verbose=False, device="cpu")
        path = str(d / f"{name}.xml")
        model.save(path)
        out[name] = path
    out["metacleaver"] = out["lambdamart"]
    res = {}
    for name in NAMES:
        port = _wrap(name, LTRAlgorithm.load(out[name]), jax=False)
        jax = _wrap(name, JaxLTRAlgorithm.load(out[name]), jax=True)
        F = jax_export._model_num_features(jax_export._unwrap(jax))
        want = jax_export.load_scorer(jax_export.export_scorer(jax))(X[:, :F])
        res[name] = (out[name], port, jax, want)
    return res


@pytest.fixture(scope="module")
def archives(models):
    """name -> the port's archive of the model."""
    return {name: export.export_scorer(m[1]) for name, m in models.items()}


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_archive_is_jax_artifact_bit_for_bit(models, archives, splits, name):
    """At batches 0, 1, 7 and all rows the archive gives JAX's artifact's
    scores bit for bit (the symbolic batch); tree models also give the
    port's plain QuickScorer scorer's bit for bit."""
    _, port, _, want = models[name]
    F = export._model_num_features(export._unwrap(port))
    X = splits[2].features[:, :F].astype(np.float32)
    scorer = export.load_scorer(archives[name], device="cpu")
    for n in (0, 1, 7, X.shape[0]):
        got = scorer(X[:n])
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want[:n]), err_msg=f"batch {n}")
    # a tensor in, the same scores out
    np.testing.assert_array_equal(_bits(scorer(torch.from_numpy(X))), _bits(want))
    if name in TREES:
        ens = export._unwrap(port)._require_model()
        plain = score_qs(torch.from_numpy(X), ensemble_to_qs(ens)).numpy()
        np.testing.assert_array_equal(_bits(want), _bits(plain))


@pytest.mark.parametrize("name", ["lambdamart", "dart"])
def test_archive_is_score_dataset_on_the_qs_path(models, archives, splits, name):
    """Trees deeper than 5 score through QuickScorer in ``score_dataset``:
    the archive gives its scores bit for bit.  (Shallower trees take the
    perfect-tree or oblivious path, a plain float32 sum, held against the
    descent within 1e-5 * max(1, max|s|) by their own tests.)"""
    _, port, _, want = models[name]
    assert port.scorer_path() == "qs"
    F = export._model_num_features(port)
    test = _port_ds(splits[2])
    got = export.load_scorer(archives[name], device="cpu")(test.features[:, :F])
    np.testing.assert_array_equal(_bits(got), _bits(port.score_dataset(test, device="cpu")))


def test_fixed_batch_and_wider_num_features(models, splits):
    """batch=7 fixes the leading dim (the program's guard refuses another);
    num_features above the model's width reads the extra columns not at
    all."""
    _, port, _, want = models["lambdamart"]
    X = splits[2].features.astype(np.float32)
    blob = export.export_scorer(port, num_features=X.shape[1], batch=7)
    got = export.load_scorer(blob, device="cpu")(X[:7])
    np.testing.assert_array_equal(_bits(got), _bits(want[:7]))
    with pytest.raises(AssertionError, match="Guard failed"):
        export.load_scorer(blob, device="cpu")(X[:8])


def test_narrow_num_features_and_untrained_rankboost_raise(models):
    port = models["lambdamart"][1]
    F = export._model_num_features(port)
    assert F >= 2
    with pytest.raises(ValueError, match="narrower"):
        export.export_scorer(port, num_features=F - 1)
    with pytest.raises(RuntimeError, match="RANKBOOST: no trained model to export"):
        export.export_scorer(RankBoost())


def _graph_nodes(program) -> int:
    return sum(len(m.graph.nodes) for m in program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule))


def test_tree_scorer_is_one_scan_whatever_the_trees():
    """The graph of 200 trees is the graph of 5 (a scan, not an unrolled
    loop), and the program moves to another device whole (no constant
    pinned to the CPU inside the scan's body)."""
    from torch.export.passes import move_to_device_pass

    counts = []
    for T in (5, 200):
        lm = LambdaMart(ntrees=T, nleaves=16)
        lm.ensemble = random_bestfirst_ensemble(T, 16, 12, seed=T)
        program = torch.export.load(io.BytesIO(export.export_scorer(lm)))
        counts.append(_graph_nodes(program))
        moved = move_to_device_pass(program, "meta")
        assert all(b.device.type == "meta" for b in moved.state_dict.values())
    assert counts[0] == counts[1] < 100


def test_load_scorer_defaults_to_the_card(archives, monkeypatch):
    """device=None is the card: without one it raises, no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        export.load_scorer(archives["rankboost"])


def test_archive_loads_with_torch_alone(archives, models, tmp_path):
    """The serving contract: a fresh process that imports torch alone loads
    and calls the archive."""
    path = tmp_path / "scorer.pt2"
    path.write_bytes(archives["lambdamart"])
    F = export._model_num_features(models["lambdamart"][1])
    code = (
        "import sys, torch\n"
        f"fn = torch.export.load({str(path)!r}).module()\n"
        f"out = fn(torch.zeros((3, {F})))\n"
        "assert out.shape == (3,) and bool(torch.isfinite(out).all())\n"
        "assert not any(m.startswith('quickrank_tpu') for m in sys.modules), sorted(sys.modules)\n"
        "print('SERVE-OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SERVE-OK" in r.stdout


def test_cli_generator_pt2_is_jax_stablehlo(models, splits, tmp_path):
    """quicklearn --generator pt2 on an XML file the JAX package wrote gives
    the scores of JAX's --generator stablehlo artifact bit for bit."""
    xml = tmp_path / "jax.xml"
    JaxLTRAlgorithm.load(models["lambdamart"][0]).save(str(xml))
    pt2, shlo = tmp_path / "scorer.pt2", tmp_path / "scorer.shlo"
    with redirect_stdout(io.StringIO()) as out:
        assert port_main(["--model-file", str(xml), "--code-file", str(pt2), "--generator",
                          "pt2", "--device", "cpu"]) == 0
        assert jax_main(["--model-file", str(xml), "--code-file", str(shlo), "--generator",
                         "stablehlo", "--quiet"]) == 0
    assert f"# pt2 code saved to {pt2}" in out.getvalue()
    F = export._model_num_features(LTRAlgorithm.load(str(xml)))
    X = splits[2].features[:, :F].astype(np.float32)
    got = export.load_scorer(str(pt2), device="cpu")(X)
    np.testing.assert_array_equal(_bits(got), _bits(jax_export.load_scorer(str(shlo))(X)))
