"""The port's quicklearn (quickrank_tpu_torch/cli.py, driver.py,
learning/factory.py) against the JAX package's: the same SVML files and flags
through both ``main`` functions, on the CPU.

MART sees the same gradients in both packages, so its trees are equal split
for split.  The lambda learners differ in the last bit of their gradients
(sigmoid, log2), so they are held by the test metric of the scores each CLI
writes, within 1e-4 over three trees."""

import numpy as np
import pytest
import torch

from quickrank_tpu.cli import main as jax_main
from quickrank_tpu.data import write_svml
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu_torch.cli import main as port_main
from quickrank_tpu_torch.data.dataset import pack_doc_values, select_columns, shard_and_pad
from quickrank_tpu_torch.data.svml import read_svml
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.metrics.metrics import Ndcg

NODE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")


@pytest.fixture(scope="module")
def svml_dir(tmp_path_factory, splits):
    d = tmp_path_factory.mktemp("torch_cli")
    for name, ds in zip(("train", "valid", "test"), splits):
        write_svml(ds, str(d / f"{name}.svml"))
    return d


def _flags(d, out, extra, trees=3, folds=("train", "valid", "test")):
    args = []
    for fold in folds:
        args += [f"--{fold}", str(d / f"{fold}.svml")]
    return args + ["--model-out", str(out), "--num-trees", str(trees), "--num-leaves", "8",
                   "--num-thresholds", "32", "--tree-depth", "3", "--quiet"] + extra


def _both(d, tmp_path, extra, **kw):
    """Run both CLIs on the same flags; (jax model path, port model path)."""
    jout, pout = tmp_path / "jax.xml", tmp_path / "port.xml"
    assert jax_main(_flags(d, jout, extra + ["--scores", str(tmp_path / "jax.scores")],
                           **kw)) == 0
    assert port_main(_flags(d, pout, extra + ["--scores", str(tmp_path / "port.scores"),
                                              "--device", "cpu"], **kw)) == 0
    return jout, pout


def _ndcg10(test_svml, scores_file):
    ds = read_svml(str(test_svml))
    padded = shard_and_pad(ds)
    scores = torch.from_numpy(np.loadtxt(scores_file).astype(np.float32))
    return Ndcg(10).evaluate_dataset(padded, pack_doc_values(padded, scores))


def _assert_same_trees(jpath, ppath):
    j, p = JaxLTRAlgorithm.load(str(jpath)), LTRAlgorithm.load(str(ppath))
    assert p.ensemble.num_trees == int(j.ensemble.num_trees) > 0
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(p.ensemble, k).numpy(),
                                      np.asarray(getattr(j.ensemble, k)), k)
    np.testing.assert_allclose(p.ensemble.leaf_value.numpy(),
                               np.asarray(j.ensemble.leaf_value), rtol=1e-6, atol=1e-6)
    return j, p


def test_mart_trees_equal_jax(svml_dir, tmp_path):
    """MART, 5 trees: every split feature and threshold equal, leaf outputs
    within 1e-6, and the scores files agree."""
    jout, pout = _both(svml_dir, tmp_path, ["--algo", "MART"], trees=5)
    _, p = _assert_same_trees(jout, pout)
    assert p.ensemble.num_trees == 5
    want, got = (np.loadtxt(tmp_path / f"{w}.scores") for w in ("jax", "port"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("extra", [
    ["--algo", "LAMBDAMART"], ["--algo", "OBVMART"], ["--algo", "OBVLAMBDAMART"],
    # 64 thresholds: at 32 a near-tie gain of the second tree flips on the
    # last bit of a lambda, and the two runs part ways (7e-4 NDCG@10)
    ["--algo", "LAMBDAMART", "--growth", "level", "--max-depth", "3",
     "--num-thresholds", "64"],
    ["--algo", "LAMBDAMART", "--growth", "bestk", "--split-pack", "2"],
], ids=["lambdamart", "obvmart", "obvlambdamart", "level", "bestk"])
def test_test_metric_tracks_jax(svml_dir, tmp_path, extra):
    jout, pout = _both(svml_dir, tmp_path, extra)
    j, p = JaxLTRAlgorithm.load(str(jout)), LTRAlgorithm.load(str(pout))
    assert j.NAME == p.NAME == extra[1]
    assert p.ensemble.num_trees == int(j.ensemble.num_trees)
    if "--growth" in extra:
        assert p.growth == j.growth == extra[3]
    test = svml_dir / "test.svml"
    want, got = (_ndcg10(test, tmp_path / f"{w}.scores") for w in ("jax", "port"))
    assert got == pytest.approx(want, abs=1e-4)
    assert got > 0.1


def test_features_file_restricts_columns(svml_dir, tmp_path, splits):
    feats = tmp_path / "feats.txt"
    feats.write_text("1\n3\n5\n7\n# comment\n9\n")
    jout, pout = _both(svml_dir, tmp_path, ["--algo", "MART", "--features", str(feats)])
    _, p = _assert_same_trees(jout, pout)
    assert int(p.ensemble.feature.max()) < 5
    # a model trained on the full width does not go with the selection
    wide = tmp_path / "wide.xml"
    assert port_main(_flags(svml_dir, wide, ["--algo", "MART", "--device", "cpu"],
                            folds=("train",))) == 0
    assert int(LTRAlgorithm.load(str(wide)).ensemble.feature.max()) >= 5
    for main, more in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="not trained under this feature selection"):
            main(["--model-in", str(wide), "--test", str(svml_dir / "test.svml"),
                  "--features", str(feats), "--quiet"] + more)
    feats.write_text("0\n2\n")
    with pytest.raises(ValueError, match="1-based"):
        port_main(_flags(svml_dir, wide, ["--features", str(feats), "--device", "cpu"]))
    sub = select_columns(read_svml(str(svml_dir / "test.svml")), np.asarray([0, 2]))
    np.testing.assert_array_equal(sub.features[:, 1], splits[2].features[:, 2])
    with pytest.raises(ValueError, match="out of range"):
        select_columns(sub, np.asarray([2]))


def test_restart_train_and_partial_saves(svml_dir, tmp_path):
    """--partial 2 writes <base>.T2.xml; --restart-train resumes from it (two
    more trees, the first two kept); a mismatched shrinkage is refused in
    the JAX package's words; --model-in alone only scores."""
    out = tmp_path / "m.xml"
    flags = _flags(svml_dir, out, ["--algo", "MART", "--partial", "2", "--device", "cpu"],
                   trees=4, folds=("train",))
    assert port_main(flags) == 0
    assert sorted(f.name for f in tmp_path.iterdir()) == ["m.T2.xml", "m.T4.xml", "m.xml"]
    whole, part = LTRAlgorithm.load(str(out)), LTRAlgorithm.load(str(tmp_path / "m.T2.xml"))
    assert (whole.ensemble.num_trees, part.ensemble.num_trees) == (4, 2)
    np.testing.assert_array_equal(part.ensemble.leaf_value.numpy(),
                                  whole.ensemble.leaf_value[:2].numpy())

    resumed = tmp_path / "r.xml"
    more = ["--algo", "MART", "--model-in", str(tmp_path / "m.T2.xml"), "--restart-train"]
    assert port_main(_flags(svml_dir, resumed, more + ["--device", "cpu"], trees=4,
                            folds=("train",))) == 0
    r = LTRAlgorithm.load(str(resumed))
    assert r.ensemble.num_trees == 4
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(r.ensemble, k).numpy(),
                                      getattr(whole.ensemble, k).numpy(), k)

    messages = []
    for main, dev in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="restart-train: models not compatible") as e:
            main(_flags(svml_dir, tmp_path / "x.xml", more + ["--shrinkage", "0.3"] + dev,
                        folds=("train",)))
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "shrinkage: 0.3 (requested)" in messages[1]

    # --model-in without --restart-train does not train
    scores = tmp_path / "s.txt"
    assert port_main(["--model-in", str(out), "--train", str(svml_dir / "train.svml"),
                      "--test", str(svml_dir / "test.svml"), "--scores", str(scores),
                      "--device", "cpu", "--quiet"]) == 0
    ds = read_svml(str(svml_dir / "test.svml"))
    np.testing.assert_array_equal(np.loadtxt(scores).astype(np.float32),
                                  whole.score_dataset(ds, device="cpu"))


@pytest.mark.parametrize("extra,item", [
    (["--algo", "RANKBOOST"], "item 7"), (["--algo", "CUSTOM"], "item 7"),
    (["--num-feat-shards", "2"], "item 10"), (["--algo", "STOCHASTIC-NEGATIVE"], "item 7"),
    (["--num-shards", "2"], "item 10"), (["--trace", "dir"], "item 9"),
    (["--num-shards", "4"], "item 10"),
    (["--model-file", "m.xml", "--code-file", "m.c"], "item 9"),
])
def test_unported_flags_raise_naming_their_item(svml_dir, tmp_path, extra, item):
    """Flags whose modules are not ported are parsed and refused, naming the
    ROADMAP.md item, before any data is read."""
    with pytest.raises(NotImplementedError, match=item):
        port_main(_flags(svml_dir, tmp_path / "x.xml", extra + ["--device", "cpu"]))
    assert not (tmp_path / "x.xml").exists()


def test_coordasc_with_default_partial_trains_and_saves(svml_dir, tmp_path, capsys):
    """--algo COORDASC --model-out with the default --partial 100: the
    driver drops the flags CoordinateAscent.learn does not take, with a
    note, trains, and saves the JAX CLI's model."""
    jout, pout = tmp_path / "jax.xml", tmp_path / "port.xml"
    feats = tmp_path / "feats.txt"
    feats.write_text("\n".join(str(i) for i in range(1, 13)))
    flags = ["--algo", "COORDASC", "--train", str(svml_dir / "train.svml"),
             "--test", str(svml_dir / "test.svml"), "--max-iterations", "1",
             "--features", str(feats)]
    assert jax_main(flags + ["--model-out", str(jout), "--scores", str(tmp_path / "j.txt")]) == 0
    capsys.readouterr()
    assert port_main(flags + ["--model-out", str(pout), "--scores", str(tmp_path / "p.txt"),
                              "--device", "cpu"]) == 0
    assert "CoordinateAscent.learn has no partial_save/output_basename support" in (
        capsys.readouterr().out)
    assert sorted(f.name for f in tmp_path.iterdir() if f.suffix == ".xml") == [
        "jax.xml", "port.xml"]
    j, p = JaxLTRAlgorithm.load(str(jout)), LTRAlgorithm.load(str(pout))
    assert p.NAME == j.NAME == "COORDASC"
    np.testing.assert_allclose(p.best_weights, j.best_weights, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "p.txt"), np.loadtxt(tmp_path / "j.txt"),
                               rtol=1e-6, atol=1e-6)


def test_meta_cleaver_cli_tracks_jax(svml_dir, tmp_path):
    """--meta-algo METACLEAVER wraps the learner and its optimizer: two
    rounds of 4 trees, half of each pruned, and a METACLEAVER model whose
    test metric tracks the JAX CLI's (MART: both packages grow the same
    trees from the same gradients; LambdaMART's lambdas differ in the last
    bit, and its second round's trees can part ways)."""
    feats = tmp_path / "feats.txt"
    feats.write_text("\n".join(str(i) for i in range(1, 13)))
    extra = ["--algo", "MART", "--meta-algo", "METACLEAVER", "--final-num-trees", "4",
             "--opt-method", "QUALITY_LOSS", "--pruning-rate", "0.5", "--opt-last-only",
             "--features", str(feats)]
    jout, pout = _both(svml_dir, tmp_path, extra, trees=4)
    j, p = JaxLTRAlgorithm.load(str(jout)), LTRAlgorithm.load(str(pout))
    assert p.NAME == j.NAME == "METACLEAVER"
    assert p.ltr_algo.ensemble.num_trees == int(j.ltr_algo.ensemble.num_trees) == 4
    test = svml_dir / "test.svml"
    want, got = (_ndcg10(test, tmp_path / f"{w}.scores") for w in ("jax", "port"))
    assert got == pytest.approx(want, abs=1e-4)


def test_unknown_algo_and_missing_card(svml_dir, tmp_path):
    with pytest.raises(ValueError, match="unknown LtR algorithm"):
        port_main(_flags(svml_dir, tmp_path / "x.xml", ["--algo", "NOPE", "--device", "cpu"]))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:  # the default device is the card
        port_main(_flags(svml_dir, tmp_path / "x.xml", []))
    assert e.value.code == 2 and not (tmp_path / "x.xml").exists()
