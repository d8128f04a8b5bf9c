"""The port's quicklearn (quickrank_tpu_torch/cli.py, driver.py,
learning/factory.py) against the JAX package's: the same SVML files and flags
through both ``main`` functions, on the CPU.

MART sees the same gradients in both packages, so its trees are equal split
for split.  The lambda learners differ in the last bit of their gradients
(sigmoid, log2), so they are held by the test metric of the scores each CLI
writes, within 1e-4 over three trees.  The restart, refusal, linear and
meta-learner cases are in ``test_torch_cli_phases.py``."""

import numpy as np
import pytest

from quickrank_tpu_torch.data.dataset import select_columns
from torch_cli_common import (  # noqa: F401  (svml_dir is a fixture)
    JaxLTRAlgorithm,
    LTRAlgorithm,
    _assert_same_trees,
    _both,
    _flags,
    _ndcg10,
    jax_main,
    port_main,
    read_svml,
    svml_dir,
)


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
