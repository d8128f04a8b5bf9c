"""The port's perfect-tree embedding and plain scorer (quickrank_tpu_torch/
trees/perfect.py) against the JAX package, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.ops.pallas_perfect import score_perfect_pallas
from quickrank_tpu.trees import perfect as jax_perfect
from quickrank_tpu.trees.random_ensemble import (
    random_balanced_ensemble as jax_balanced,
    random_bestfirst_ensemble as jax_bestfirst,
)
from quickrank_tpu_torch.ops import kernel_perfect
from quickrank_tpu_torch.ops.scoring import score_ensemble
from quickrank_tpu_torch.trees import perfect
from quickrank_tpu_torch.trees.structs import FIELDS, EnsembleTensors

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


def _port(jens) -> EnsembleTensors:
    return EnsembleTensors.from_numpy({k: np.asarray(getattr(jens, k)) for k in FIELDS})


def _features(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f), dtype=np.float32)


def _chain(n: int) -> EnsembleTensors:
    """One chain-shaped tree of ``n`` splits (depth n): node 2i splits into
    (leaf 2i+1, chain 2i+2)."""
    m = 2 * n + 1
    idx = np.arange(n)
    feature = np.full((1, m), -1, np.int32)
    left = np.zeros((1, m), np.int32)
    right = np.zeros((1, m), np.int32)
    is_leaf = np.ones((1, m), bool)
    feature[0, 2 * idx] = 0
    left[0, 2 * idx] = 2 * idx + 1
    right[0, 2 * idx] = 2 * idx + 2
    is_leaf[0, 2 * idx] = False
    return EnsembleTensors.from_numpy(dict(
        feature=feature, threshold=np.zeros((1, m), np.float32),
        threshold_bin=np.zeros((1, m), np.int32), left=left, right=right,
        is_leaf=is_leaf, leaf_value=np.zeros((1, m), np.float32),
        weight=np.ones(1, np.float32), num_trees=1,
    ))


ENSEMBLES = {
    "balanced-d3": lambda: jax_balanced(30, 3, 20, seed=3),
    "balanced-d4": lambda: jax_balanced(40, 4, 20, seed=4),
    "balanced-d5": lambda: jax_balanced(25, 5, 20, seed=5),
    # asymmetric depth <= 3 trees: pass-through nodes and replicated leaves
    "bestfirst-4leaves": lambda: jax_bestfirst(33, 4, 11, seed=2),
}


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_embedding_matches_jax(name):
    """fid, thr, leaf and weight equal JAX's on the live rows (JAX pads the
    tree axis to a multiple of 25; the port does not pad)."""
    jens = ENSEMBLES[name]()
    j = jax_perfect.ensemble_to_perfect(jens, max_depth=5)
    p = perfect.ensemble_to_perfect(_port(jens), max_depth=5)
    T = int(jens.num_trees)
    assert p.fid.shape[0] == T and p.depth == j.depth
    np.testing.assert_array_equal(p.fid.numpy(), np.asarray(j.fid)[:T])
    np.testing.assert_array_equal(p.thr.numpy(), np.asarray(j.thr)[:T])
    np.testing.assert_array_equal(p.leaf.numpy(), np.asarray(j.leaf)[:T])
    np.testing.assert_array_equal(p.weight.numpy(), np.asarray(j.weight)[:T])
    np.testing.assert_array_equal(
        p.wleaf.numpy(), p.leaf.numpy() * p.weight.numpy()[:, None])
    np.testing.assert_array_equal(
        perfect.tree_depths(_port(jens)), jax_perfect.tree_depths(jens))


def test_deep_trees_refuse_embedding():
    """A depth-8 chain is refused at max_depth 5 and embeds at 8; a chain
    far past Python's recursion limit is measured without recursion."""
    assert perfect.ensemble_to_perfect(_chain(8), max_depth=5) is None
    assert perfect.ensemble_to_perfect(_chain(8), max_depth=8) is not None
    long_chain = _chain(9000)
    assert perfect.tree_depths(long_chain, cap=5)[0] == 6
    assert perfect.ensemble_to_perfect(long_chain, max_depth=5) is None
    assert perfect.tree_depths(long_chain)[0] == 9000


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_score_perfect_matches_pallas(name):
    """Against the Pallas kernel in interpret mode: routing and leaf picks
    are exact, the two sum the trees in different float32 orders."""
    jens = ENSEMBLES[name]()
    F = int(np.asarray(jens.feature).max()) + 1
    X = _features(300, F, seed=1)
    b = np.asarray(score_perfect_pallas(
        jnp.asarray(X), jax_perfect.ensemble_to_perfect(jens), tile_n=256,
        interpret=True))
    a = perfect.score_perfect(
        torch.from_numpy(X), perfect.ensemble_to_perfect(_port(jens))).numpy()
    np.testing.assert_allclose(a, b, atol=2e-6 * max(1.0, np.abs(a).max()), rtol=0)


def test_score_perfect_is_tree_order_sum():
    """The plain scorer is the float32 sum of the descent's leaf values
    times weights, taken in tree order."""
    ens = _port(jax_bestfirst(12, 4, 7, seed=6))
    X = torch.from_numpy(_features(200, 7, seed=2))
    want = torch.zeros(200)
    for t in range(ens.num_trees):
        one = EnsembleTensors.from_numpy({
            **{k: v[t : t + 1] for k, v in ens.numpy().items() if k != "num_trees"},
            "weight": np.ones(1, np.float32), "num_trees": 1,
        })
        want = want + score_ensemble(X, one) * ens.weight[t]
    got = perfect.score_perfect(X, perfect.ensemble_to_perfect(ens))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrapper_runs_plain_version_on_cpu():
    pe = perfect.ensemble_to_perfect(_port(jax_balanced(10, 4, 9, seed=1)))
    X = torch.from_numpy(_features(64, 9, seed=8))
    before = kernel_perfect.LAUNCHES
    np.testing.assert_array_equal(
        kernel_perfect.score_perfect(X, pe).numpy(),
        perfect.score_perfect(X, pe).numpy())
    assert kernel_perfect.LAUNCHES == before


def _score_packed(X: np.ndarray, packed: np.ndarray, depth: int) -> np.ndarray:
    """The CUDA kernel's reads, in numpy: per tree the heap walk over the
    record's {fid, thr bits} pairs, then its wleaf value, added in tree
    order in float32."""
    I = 2**depth - 1
    docs = np.arange(X.shape[0])
    acc = np.zeros(X.shape[0], np.float32)
    for rec in packed:
        h = np.zeros(X.shape[0], np.int64)
        for _ in range(depth):
            thr = rec[2 * h + 1].view(np.float32)
            h = 2 * h + 1 + (X[docs, rec[2 * h]] > thr)
        acc = acc + rec[2 * I + h - I].view(np.float32)
    return acc


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_packed_records_unpack_exactly_and_score_bitwise(depth):
    """The packed table the CUDA kernel streams (pairs {fid, thr bits} in
    heap order, then wleaf, padded to 16 bytes: 192 bytes a tree at depth 4,
    384 at depth 5) unpacks to the tables exactly, is built once and moves
    with them; a scorer reading only the records is bitwise score_perfect,
    with a tree of weight 0, pass-through nodes, NaN and +-inf features."""
    ens = _port(jax_bestfirst(9, depth + 1, 13, seed=depth) if depth <= 2
                else jax_balanced(9, depth, 13, seed=depth))
    ens.weight[3] = 0.0
    pe = perfect.ensemble_to_perfect(ens)
    assert pe.depth == depth
    packed = pe.packed()
    assert packed is pe.packed() and packed.dtype == torch.int32 and packed.is_contiguous()
    stride = perfect.packed_stride(depth)
    assert packed.shape == (9, stride) and stride % 4 == 0
    assert stride * 4 == {4: 192, 5: 384}.get(depth, stride * 4)
    fid, thr, wleaf = perfect.unpack_perfect(packed, depth)
    for got, want in ((fid, pe.fid), (thr, pe.thr), (wleaf, pe.wleaf)):
        assert torch.equal(got, want)
    assert not packed[:, 3 * 2**depth - 2:].any()  # the padding
    assert torch.equal(pe.to("cpu").packed(), packed)
    X = _features(300, 13, seed=depth)
    X[::7, :] = np.nan
    X[1::11, :] = np.inf
    X[2::13, :] = -np.inf
    got = _score_packed(X, packed.numpy(), depth)
    want = perfect.score_perfect(torch.from_numpy(X), pe).numpy()
    np.testing.assert_array_equal(got, want)
