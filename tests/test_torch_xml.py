"""XML models and ensembles crossing between the JAX package and the port:
a model saved by either loads in the other with identical tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.io import xml_model as jax_xml
from quickrank_tpu.learning import LambdaMart as JaxLambdaMart
from quickrank_tpu.learning import Mart as JaxMart
from quickrank_tpu.trees import random_ensemble as jax_random
from quickrank_tpu_torch.io import xml_model
from quickrank_tpu_torch.learning import LambdaMart, Mart
from quickrank_tpu_torch.trees import random_ensemble
from quickrank_tpu_torch.trees.structs import FIELDS, EnsembleTensors

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

ENSEMBLES = {
    "bestfirst": ("random_bestfirst_ensemble", (15, 16, 30), {"seed": 3}),
    "balanced": ("random_balanced_ensemble", (12, 4, 30), {"seed": 4}),
    "balanced-weight": ("random_balanced_ensemble", (5, 2, 7),
                        {"seed": 1, "weight": 0.37}),
}


def _jax_fields(jens) -> dict:
    return {k: np.asarray(getattr(jens, k)) for k in FIELDS}


def _assert_same(port_ens: EnsembleTensors, fields: dict):
    got = port_ens.numpy()
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], fields[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_random_ensembles_match_jax(name):
    fn, args, kw = ENSEMBLES[name]
    jens = getattr(jax_random, fn)(*args, **kw)
    _assert_same(getattr(random_ensemble, fn)(*args, **kw), _jax_fields(jens))


def test_from_numpy_matches_jax_fields():
    jens = jax_random.random_bestfirst_ensemble(6, 8, 10, seed=2)
    jens = jens.replace(num_trees=jnp.asarray(4, jnp.int32))
    port = EnsembleTensors.from_numpy(_jax_fields(jens))
    _assert_same(port, _jax_fields(jens))
    assert port.capacity == 6 and port.max_nodes == 15 and port.num_trees == 4
    moved = port.to("meta")
    assert moved.feature.device.type == "meta" and moved.num_trees == 4
    assert moved.is_leaf.dtype == torch.bool and moved.weight.shape == (6,)
    with pytest.raises(ValueError):
        EnsembleTensors.from_numpy({**_jax_fields(jens), "weight": np.ones(5)})


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_jax_saved_model_loads_in_port(tmp_path, name):
    fn, args, kw = ENSEMBLES[name]
    jm = JaxLambdaMart(ntrees=50, nleaves=16, shrinkage=0.25, esr=7)
    jm.ensemble = getattr(jax_random, fn)(*args, **kw)
    path = str(tmp_path / "jax.xml")
    jax_xml.save_model(jm, path)
    pm = xml_model.load_model(path)
    assert type(pm) is LambdaMart
    assert (pm.ntrees, pm.nleaves, pm.shrinkage, pm.esr) == (50, 16, 0.25, 7)
    _assert_same(pm.ensemble, _jax_fields(jax_xml.load_model(path).ensemble))


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_port_saved_model_loads_in_jax(tmp_path, name):
    """The port writes the same bytes as the JAX package, and JAX loads
    them into the tensors the port loads."""
    fn, args, kw = ENSEMBLES[name]
    pm = Mart(ntrees=9, nleaves=4, shrinkage=0.5, minleafsupport=3,
              growth="level", max_depth=3)
    pm.ensemble = getattr(random_ensemble, fn)(*args, **kw)
    jm = JaxMart(ntrees=9, nleaves=4, shrinkage=0.5, minleafsupport=3,
                 growth="level", max_depth=3)
    jm.ensemble = getattr(jax_random, fn)(*args, **kw)
    ppath, jpath = str(tmp_path / "port.xml"), str(tmp_path / "jax.xml")
    pm.save(ppath)
    jax_xml.save_model(jm, jpath)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    jl = jax_xml.load_model(ppath)
    assert type(jl) is JaxMart and jl.growth == "level" and jl.max_depth == 3
    _assert_same(xml_model.load_model(ppath).ensemble, _jax_fields(jl.ensemble))


def test_unported_types_raise_not_implemented(tmp_path):
    """Every ranker type the JAX package writes is ported now: XML models
    the JAX package saved as CUSTOM, RANDOMFOREST and RANKBOOST load in the
    port as those learners, with the JAX model's fields; an unknown type
    still raises ValueError."""
    from quickrank_tpu.learning.custom import CustomLTR as JaxCustom
    from quickrank_tpu.learning.randomforest import RandomForest as JaxRandomForest
    from quickrank_tpu.learning.rankboost import RankBoost as JaxRankBoost
    from quickrank_tpu_torch.learning import CustomLTR, RandomForest, RankBoost

    path = str(tmp_path / "m.xml")
    jrf = JaxRandomForest(ntrees=7, nleaves=4, subsample=0.6, max_features=0.5)
    jrf.ensemble = jax_random.random_balanced_ensemble(2, 2, 3)
    jax_xml.save_model(jrf, path)
    rf = xml_model.load_model(path)
    assert type(rf) is RandomForest and (rf.ntrees, rf.subsample, rf.max_features) == (
        7, 0.6, 0.5)
    _assert_same(rf.ensemble, _jax_fields(jax_xml.load_model(path).ensemble))
    jrb = JaxRankBoost(ntrees=9)
    jrb.best_T, jrb.features_ = 2, np.asarray([3, 0], np.int32)
    jrb.thetas_ = np.asarray([0.25, -1.5], np.float32)
    jrb.signs_, jrb.alphas_ = np.ones(2, np.int32), np.asarray([0.5, 0.125], np.float32)
    jax_xml.save_model(jrb, path)
    rb = xml_model.load_model(path)
    assert type(rb) is RankBoost and (rb.T, rb.best_T) == (9, 2)
    for name in ("features_", "thetas_", "signs_", "alphas_"):
        np.testing.assert_array_equal(getattr(rb, name), getattr(jrb, name))
    jax_xml.save_model(JaxCustom(), path)
    assert type(xml_model.load_model(path)) is CustomLTR
    text = open(path).read()
    with open(path, "w") as f:
        f.write(text.replace("<type>CUSTOM</type>", "<type>NOSUCH</type>"))
    with pytest.raises(ValueError, match="unknown ranker type"):
        xml_model.load_model(path)


def test_learn_is_not_ported():
    """Training is ported for best-first (dataset order and node-clustered),
    best-k and level-wise growth, on one device, a query-sharded group or a
    2-D mesh; a mesh of another kind refuses, naming the two it takes,
    before touching data."""
    with pytest.raises(NotImplementedError, match="DataGroup .* or a parallel.mesh.Mesh2D"):
        LambdaMart(cluster="on").learn(None, mesh=object())
