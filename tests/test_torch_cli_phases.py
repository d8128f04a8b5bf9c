"""The port's quicklearn against the JAX package's, continued from
``test_torch_cli.py``: --restart-train and partial saves, the refusal of
unported flags, COORDASC with the default --partial, --meta-algo
METACLEAVER, an unknown --algo and the missing card."""

import numpy as np
import pytest
import torch

from torch_cli_common import (  # noqa: F401  (svml_dir is a fixture)
    NODE_FIELDS,
    JaxLTRAlgorithm,
    LTRAlgorithm,
    _both,
    _flags,
    _ndcg10,
    jax_main,
    port_main,
    read_svml,
    svml_dir,
)


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
    (["--num-feat-shards", "2"], "item 10"),
    # --num-shards trains the Mart family, DART and the linear rankers; the
    # sampling learners and RankBoost wait for 10b part 3
    (["--num-shards", "2", "--algo", "RANDOMFOREST"], "item 10"),
    (["--num-shards", "4", "--algo", "RANKBOOST"], "item 10"),
    (["--model-file", "m.xml", "--code-file", "m.c", "--generator", "stablehlo"], "item 9"),
], ids=["extra2-item 10", "extra4-item 10", "extra6-item 10", "extra7-item 9"])  # stable ids
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
