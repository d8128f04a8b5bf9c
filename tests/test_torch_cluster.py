"""The port's node-clustered best-first grower (trees/grow_cluster.py) on the
CPU against the JAX package's and against the port's dataset-order grower.

With integer pseudoresponses every histogram sum is exact, so all three
growers must build the same tree, node for node and doc for doc.  With float
pseudoresponses the port's scatter adds a run's docs in the order XLA's adds
them, so the port's clustered trees equal JAX's clustered trees bitwise too.
The work buffer and the partition directives of every split are held
against JAX's own (its grower run outside ``jit``, its ``partition_rows``
recorded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.learning.lambdamart import LambdaMart as JaxLambdaMart
from quickrank_tpu.metrics.metrics import Ndcg as JaxNdcg
from quickrank_tpu.trees import grow as jax_grow
from quickrank_tpu.trees import grow_cluster as jax_cluster
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning import mart as port_mart
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.metrics.metrics import Ndcg
from quickrank_tpu_torch.ops.histogram import masked_histogram_t
from quickrank_tpu_torch.trees import grow, grow_cluster
from quickrank_tpu_torch.trees.grow_cluster import fit_tree_clustered

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

NODE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf")


def _mk(N=4096, F_real=20, W=32, B=16, seed=0, float_grad=False):
    """tests/test_cluster.py::_mk, as numpy arrays."""
    rng = np.random.default_rng(seed)
    binned = np.zeros((N, W), np.uint8)
    binned[:, :F_real] = rng.integers(0, B, (N, F_real))
    grad = rng.integers(-8, 9, N).astype(np.float32)  # integer: exact sums
    mask = rng.random(N) < 0.9
    thresholds = np.sort(rng.standard_normal((W, B)), axis=1).astype(np.float32)
    if float_grad:
        grad = rng.standard_normal(N).astype(np.float32)
    return binned, grad, mask, thresholds


def _skewed(N=4096, F_real=20, W=32, B=16):
    """One child of the root gets almost every row: five docs with a large
    pseudoresponse sit alone in feature 3's last bin."""
    binned, grad, mask, thresholds = _mk(seed=7)
    binned[:, 3] = np.minimum(binned[:, 3], B - 2)
    binned[:5, 3] = B - 1
    grad[:5] = 4096.0
    mask[:5] = True
    return binned, grad, mask, thresholds


def _cfgs(**kw):
    return jax_grow.GrowConfig(**kw), grow.GrowConfig(**kw)


def _torch(problem):
    return tuple(torch.from_numpy(a) for a in problem)


def _assert_same(tree, node, want_tree, want_node):
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tree, k)),
                                      np.asarray(getattr(want_tree, k)), k)
    np.testing.assert_array_equal(np.asarray(node), np.asarray(want_node))


@pytest.mark.parametrize("problem", ["uniform", "skewed"])
@pytest.mark.parametrize("nleaves,max_depth", [(4, 0), (10, 0), (10, 3)])
def test_clustered_matches_jax_and_plain_exactly(problem, nleaves, max_depth):
    arrays = _mk() if problem == "uniform" else _skewed()
    jcfg, cfg = _cfgs(nleaves=nleaves, min_leaf_support=2, num_bins=16,
                      max_depth=max_depth, num_real_features=20)
    jtree, jnode = jax_cluster.fit_tree_clustered(*(jnp.asarray(a) for a in arrays), jcfg)
    tree, node = fit_tree_clustered(*_torch(arrays), cfg)
    assert node.dtype == torch.int32
    # the skewed root leaves a five-doc child that cannot split under depth 3
    want_splits = nleaves - 1 if not max_depth else 7 if problem == "uniform" else 4
    assert int((~tree.is_leaf).sum()) == want_splits
    _assert_same(tree, node, jtree, jnode)
    ptree, pnode = grow.fit_tree(*_torch(arrays), cfg)
    _assert_same(tree, node, ptree, pnode)


@pytest.mark.parametrize("nleaves", [4, 10])
def test_clustered_float_gradients_match_jax_bitwise(nleaves):
    arrays = _mk(seed=2, float_grad=True)
    jcfg, cfg = _cfgs(nleaves=nleaves, min_leaf_support=1, num_bins=16,
                      num_real_features=20)
    jtree, jnode = jax_cluster.fit_tree_clustered(*(jnp.asarray(a) for a in arrays), jcfg)
    tree, node = fit_tree_clustered(*_torch(arrays), cfg)
    _assert_same(tree, node, jtree, jnode)


def test_clustered_feature_sampling_matches_plain():
    """The clustered grower draws its feature masks as ``fit_tree`` does, so
    the same generator gives the same tree."""
    arrays = _mk(seed=5)
    cfg = grow.GrowConfig(nleaves=10, min_leaf_support=1, num_bins=16, max_depth=3,
                          max_features=0.6, num_real_features=20)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    tree, node = fit_tree_clustered(*_torch(arrays), cfg, gens[0])
    ptree, pnode = grow.fit_tree(*_torch(arrays), cfg, gens[1])
    assert int((~tree.is_leaf).sum()) >= 3
    _assert_same(tree, node, ptree, pnode)


@pytest.mark.parametrize("problem", ["uniform", "skewed"])
def test_work_buffer_and_directives_are_jax(problem, monkeypatch):
    """The work buffer the tree starts from, and the arguments and the
    result of every split's repartition, equal the JAX grower's byte for
    byte (JAX's columns past W are its 128-lane padding)."""
    arrays = _mk() if problem == "uniform" else _skewed()
    W = arrays[0].shape[1]
    jcfg, cfg = _cfgs(nleaves=10, min_leaf_support=2, num_bins=16, num_real_features=20)
    n_work = grow_cluster.work_rows(arrays[0].shape[0], cfg.max_nodes)
    work = grow_cluster.build_work_buffer(*_torch(arrays[:3]), n_work)
    jwork = np.asarray(jax_cluster.build_work_buffer(
        *(jnp.asarray(a) for a in arrays[:3]), n_work))
    np.testing.assert_array_equal(work.numpy(), jwork[:, :W])
    assert not jwork[:, W:].any()

    calls = {"jax": [], "port": []}
    jax_partition, port_partition = jax_cluster.partition_rows, grow_cluster.partition_rows

    def record_jax(data, *args, **kw):
        out = jax_partition(data, *args, **kw)
        calls["jax"].append([np.asarray(data)[:, :W]] + [np.asarray(a) for a in args]
                            + [np.asarray(kw[k]) for k in ("fstar", "tstar")]
                            + [np.asarray(out)[:, :W]])
        return out

    def record_port(data, *args, out=None, **kw):
        res = port_partition(data, *args, out=out, **kw)
        calls["port"].append([data.numpy().copy()]
                             + [a.numpy() if torch.is_tensor(a) else np.asarray(a)
                                for a in args]
                             + [kw[k].numpy() for k in ("fstar", "tstar")]
                             + [res.numpy().copy()])
        return res

    monkeypatch.setattr(jax_cluster, "partition_rows", record_jax)
    monkeypatch.setattr(grow_cluster, "partition_rows", record_port)
    with jax.disable_jit():
        jax_cluster.fit_tree_clustered(*(jnp.asarray(a) for a in arrays), jcfg)
    fit_tree_clustered(*_torch(arrays), cfg)
    assert len(calls["jax"]) == len(calls["port"]) == 9
    names = ("data", "bit", "mode", "dsta", "dstb", "stamp_z", "stamp_o", "pos_col",
             "fstar", "tstar", "out")
    for s, (want, got) in enumerate(zip(calls["jax"], calls["port"])):
        live = want[2] != grow_cluster.MODE_DEAD  # dead tiles' offsets are not read
        for name, w, g in zip(names, want, got):
            if name in ("dsta", "dstb"):
                w, g = w[live], g[live]
            np.testing.assert_array_equal(g, w, f"split {s}: {name}")


def test_run_histogram_equals_whole_buffer_histogram():
    """A histogram pass over a node's run alone equals the pass over the
    whole buffer (rows outside the run are not in the node)."""
    binned, grad, mask, _ = _torch(_mk(seed=3))
    N, W = binned.shape
    work = grow_cluster.build_work_buffer(binned, grad, mask, N + 4 * 1024)
    chan_t, pos, live = grow_cluster._channels(work)
    node0 = (pos == 0) & live
    whole = masked_histogram_t(work, chan_t, node0, 16, f_used=20)
    run = masked_histogram_t(work[:N], chan_t[:, :N].contiguous(), node0[:N], 16, f_used=20)
    assert torch.equal(whole, run)
    want = masked_histogram_t(binned, chan_t[:, :N].contiguous(), mask, 16, f_used=20)
    assert torch.equal(run, want)


@pytest.mark.parametrize("bad", ["wide-bins", "rows", "pad-columns", "collapse"])
def test_clustered_refuses_what_jax_refuses(bad):
    binned, grad, mask, thr = _torch(_mk())
    kw = dict(nleaves=4, num_bins=16, num_real_features=20)
    if bad == "wide-bins":
        binned = binned.int()
    elif bad == "rows":
        binned, grad, mask = binned[:-1], grad[:-1], mask[:-1]
    elif bad == "pad-columns":
        kw["num_real_features"] = 25
    else:
        kw["collapse_factor"] = 0.5
    with pytest.raises(ValueError, match="fit_tree_clustered"):
        fit_tree_clustered(binned, grad, mask, thr, grow.GrowConfig(**kw))


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def cluster_runs(splits):
    train, valid, _ = splits
    kw = dict(ntrees=6, nleaves=8, nthresholds=32, seed=1)
    runs = {}
    for cluster in ("on", "off"):
        lm = LambdaMart(cluster=cluster, **kw)
        calls = {"n": 0}
        real = port_mart.fit_tree_clustered

        def counted(*a, _real=real, _calls=calls, **k):
            _calls["n"] += 1
            return _real(*a, **k)

        port_mart.fit_tree_clustered = counted
        try:
            hist = lm.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False,
                            device="cpu")
        finally:
            port_mart.fit_tree_clustered = real
        runs[cluster] = (lm, hist, calls["n"])
    j = JaxLambdaMart(cluster="on", **kw)
    runs["jax"] = (j, j.learn(train, valid, JaxNdcg(10), verbose=False), None)
    return runs


def test_lambdamart_clustered_against_dataset_order(cluster_runs):
    """JAX's own band (tests/test_cluster.py): float gradients may flip a
    near-tie gain, so the runs are held to 5e-3 NDCG@10 at the end and to the
    same tree count."""
    (on, h_on, n_on), (off, h_off, n_off) = cluster_runs["on"], cluster_runs["off"]
    assert n_on == 6 and n_off == 0
    assert abs(h_on["train"][-1] - h_off["train"][-1]) < 5e-3
    assert on.ensemble.num_trees == off.ensemble.num_trees
    assert h_on["train"][-1] > h_on["train"][0]


def test_lambdamart_clustered_tracks_jax(cluster_runs):
    """Within 1e-4 NDCG@10 of the JAX package's cluster="on" run for the
    first three iterations, and tree 0 equal node for node."""
    (on, h_on, _), (j, h_j, _) = cluster_runs["on"], cluster_runs["jax"]
    for key in ("train", "valid"):
        np.testing.assert_allclose(h_on[key][:3], h_j[key][:3], atol=1e-4, rtol=0)
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(on.ensemble, k)[0].numpy(),
                                      np.asarray(getattr(j.ensemble, k))[0], k)


@pytest.mark.parametrize("setting", [dict(cluster="auto"), dict(cluster="on", growth="bestk"),
                                     dict(cluster="on", collapse_leaves_factor=0.5)])
def test_cluster_off_paths_grow_in_dataset_order(setting, splits, monkeypatch):
    """"auto" resolves to off, and what the clustered grower does not take
    (another growth mode, a collapse) grows in dataset order, as in JAX."""
    def refuse(*a, **k):
        raise AssertionError("the clustered grower ran")

    monkeypatch.setattr(port_mart, "fit_tree_clustered", refuse)
    lm = LambdaMart(ntrees=1, nleaves=4, nthresholds=32, **setting)
    lm.learn(_port_ds(splits[0]), verbose=False, device="cpu")
    assert lm.ensemble.num_trees == 1
