"""Shared set-up of the quicklearn tests (``test_torch_cli.py``,
``test_torch_cli_phases.py``): the same SVML files and flags through the JAX
package's ``main`` and the port's, on the CPU."""

import numpy as np
import pytest
import torch

from quickrank_tpu.cli import main as jax_main
from quickrank_tpu.data import write_svml
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu_torch.cli import main as port_main
from quickrank_tpu_torch.data.dataset import pack_doc_values, shard_and_pad
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
