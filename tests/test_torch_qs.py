"""The port's QuickScorer tables and plain scorer (quickrank_tpu_torch/trees/
qs.py) and its compensated descent (ops/scoring.py) against the JAX package,
on the CPU.  Inputs are made with numpy from fixed seeds and fed to both."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.ops.pallas_qs import score_qs_pallas
from quickrank_tpu.ops.scoring import score_ensemble as jax_score_ensemble
from quickrank_tpu.trees import qs as jax_qs
from quickrank_tpu.trees.random_ensemble import (
    random_bestfirst_ensemble as jax_bestfirst,
)
from quickrank_tpu_torch.ops import kernel_qs
from quickrank_tpu_torch.ops.scoring import fma_f32, score_ensemble
from quickrank_tpu_torch.trees import qs
from quickrank_tpu_torch.trees.structs import FIELDS, EnsembleTensors

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

SHAPES = [(40, 16, 12), (7, 16, 12), (3, 4, 5), (1, 2, 3), (25, 16, 136),
          (6, 32, 20), (5, 64, 40), (4, 128, 16)]


def _port(jens) -> EnsembleTensors:
    return EnsembleTensors.from_numpy({k: np.asarray(getattr(jens, k)) for k in FIELDS})


def _features(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f), dtype=np.float32)


@pytest.mark.parametrize("T,leaves,F", SHAPES)
def test_tables_match_jax(T, leaves, F):
    """fid, thr, leafval and weight equal JAX's on the capacity slots (JAX
    pads the tree axis to its scan group), and a mask bit is set exactly
    where JAX's dense exclusion matrix holds 1."""
    jens = jax_bestfirst(T, leaves, F, seed=T + leaves)
    j = jax_qs.ensemble_to_qs(jens)
    p = qs.ensemble_to_qs(_port(jens))
    cap = j.orig_capacity
    assert p.fid.shape[0] == cap
    np.testing.assert_array_equal(p.fid.numpy(), np.asarray(j.fid)[:cap])
    np.testing.assert_array_equal(p.thr.numpy(), np.asarray(j.thr)[:cap])
    np.testing.assert_array_equal(p.leafval.numpy(), np.asarray(j.leafval)[:cap])
    np.testing.assert_array_equal(p.weight.numpy(), np.asarray(j.weight)[:cap])
    jexcl = np.asarray(j.excl.astype(jnp.float32))[:cap]
    np.testing.assert_array_equal(qs.unpack_leaf_masks(p).numpy(), jexcl == 1.0)
    assert p.excl.shape == (cap, p.fid.shape[1], -(-leaves // 64))


@pytest.mark.parametrize("T,leaves,F", SHAPES)
def test_score_qs_bitwise_matches_jax(T, leaves, F):
    """Plain QS scores are bitwise JAX's score_qs (and so its compensated
    descent): the fused Kahan step reproduces XLA's contraction."""
    jens = jax_bestfirst(T, leaves, F, seed=T + leaves)
    X = _features(257, F)
    want = np.asarray(jax_qs.score_qs(jnp.asarray(X), jax_qs.ensemble_to_qs(jens)))
    got = qs.score_qs(torch.from_numpy(X), qs.ensemble_to_qs(_port(jens)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("T,leaves,F", [(40, 16, 12), (6, 32, 20), (4, 128, 16)])
def test_descent_bitwise_matches_jax(T, leaves, F):
    """The port's compensated descent (the reference chip_smoke.py checks
    the kernels against) is bitwise JAX's score_ensemble(compensated)."""
    jens = jax_bestfirst(T, leaves, F, seed=T + leaves)
    X = _features(257, F, seed=4)
    want = np.asarray(jax_score_ensemble(
        jnp.asarray(X), jens, max_depth=2 * leaves, compensated=True))
    got = score_ensemble(torch.from_numpy(X), _port(jens), max_depth=2 * leaves)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dead_capacity_slots():
    """capacity 12 with 5 live trees: dead slots take zero-weight Kahan
    steps, bitwise as in JAX's score_qs and both descents."""
    jens = jax_bestfirst(12, 8, 6, seed=9)
    jens = jens.replace(num_trees=jnp.asarray(5, jnp.int32))
    X = _features(100, 6, seed=3)
    want = np.asarray(jax_qs.score_qs(jnp.asarray(X), jax_qs.ensemble_to_qs(jens)))
    ref = np.asarray(jax_score_ensemble(
        jnp.asarray(X), jens, max_depth=16, compensated=True))
    np.testing.assert_array_equal(want, ref)
    port = _port(jens)
    p = qs.ensemble_to_qs(port)
    assert p.fid.shape[0] == 12 and p.num_trees == 5
    np.testing.assert_array_equal(qs.score_qs(torch.from_numpy(X), p).numpy(), want)
    np.testing.assert_array_equal(
        score_ensemble(torch.from_numpy(X), port, max_depth=16).numpy(), want)


@pytest.mark.parametrize("T,leaves,F", [(40, 16, 12), (9, 8, 7), (3, 4, 5)])
def test_score_qs_matches_pallas(T, leaves, F):
    """Against the Pallas kernel in interpret mode: it sums trees in plain
    float32 block order, the port in the Kahan chain, so they agree to f32
    summation tolerance."""
    jens = jax_bestfirst(T, leaves, F, seed=T + F)
    X = _features(300, F, seed=1)
    b = np.asarray(score_qs_pallas(
        jnp.asarray(X), jax_qs.ensemble_to_qs(jens), tile_n=256, interpret=True))
    a = qs.score_qs(torch.from_numpy(X), qs.ensemble_to_qs(_port(jens))).numpy()
    np.testing.assert_allclose(a, b, atol=2e-6 * max(1.0, np.abs(a).max()), rtol=0)


def test_single_tree_bitwise_matches_pallas():
    """With one tree there is no summation order: the leaf pick times the
    weight is bitwise the Pallas kernel's."""
    jens = jax_bestfirst(1, 16, 10, seed=11)
    X = _features(300, 10, seed=2)
    b = np.asarray(score_qs_pallas(
        jnp.asarray(X), jax_qs.ensemble_to_qs(jens), tile_n=256, interpret=True))
    a = qs.score_qs(torch.from_numpy(X), qs.ensemble_to_qs(_port(jens)))
    np.testing.assert_array_equal(a.numpy(), b)


def _round_exact(a, b, c) -> np.float32:
    """float32 nearest to the exact a*b + c, ties to even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """fma_f32 is the correctly rounded a*b + c, including a case where
    rounding through float64 first would land on a float32 tie and round
    the wrong way: (-2^-24 (1 - 2^-15)) (1 + 2^-15) + (1 + 2^-23) is
    1 + 2^-24 + 2^-54, just above the midpoint of 1 and 1 + 2^-23."""
    a = np.float32(-(2.0**-24) * (1 - 2.0**-15))
    b = np.float32(1 + 2.0**-15)
    c = np.float32(1 + 2.0**-23)
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive == np.float32(1.0)
    got = fma_f32(*(torch.tensor([v]) for v in (a, b, c)))
    assert got.item() == np.float32(1 + 2.0**-23) == _round_exact(a, b, c)

    rng = np.random.default_rng(5)
    n = 600
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 2, n)).astype(np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = np.array([_round_exact(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_runs_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    jens = jax_bestfirst(9, 16, 12, seed=3)
    tables = qs.ensemble_to_qs(_port(jens))
    X = torch.from_numpy(_features(64, 12, seed=8))
    before = kernel_qs.LAUNCHES
    np.testing.assert_array_equal(
        kernel_qs.score_qs(X, tables).numpy(), qs.score_qs(X, tables).numpy())
    assert kernel_qs.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "narrow"])
def test_wrapper_rejects_bad_features(bad):
    tables = qs.ensemble_to_qs(_port(jax_bestfirst(3, 4, 5, seed=1)))
    X = torch.from_numpy(_features(16, 5))
    X = {
        "dtype": X.double(),
        "shape": X[None],
        "contiguous": torch.from_numpy(_features(5, 16)).T,
        "narrow": X[:, : tables.min_features - 1].contiguous(),
    }[bad]
    with pytest.raises(ValueError):
        kernel_qs.score_qs(X, tables)


PACKED = [(16, 1), (64, 1), (65, 2), (128, 2)]  # leaves, 64-bit words a leaf set


def _tables_with_dead_slots(leaves, space, F=20):
    """Tables of capacity 6 with 4 live trees; for ``space="bin"`` the bin
    thresholds are drawn here (the random ensembles carry none)."""
    jens = jax_bestfirst(6, leaves, F, seed=leaves)
    jens = jens.replace(num_trees=jnp.asarray(4, jnp.int32))
    port = _port(jens)
    if space == "bin":
        port.threshold_bin = torch.from_numpy(np.random.default_rng(leaves).integers(
            0, 255, size=tuple(port.threshold_bin.shape)).astype(np.int32))
    return jens, qs.ensemble_to_qs(port, space=space)


@pytest.mark.parametrize("space", ["value", "bin"])
@pytest.mark.parametrize("leaves,words", PACKED)
def test_packed_records_unpack_exactly(leaves, words, space):
    """The packed table the CUDA kernel streams: 16-byte records
    {fid, thr, leaf-set word} a node and word, then leaf values and weight;
    it unpacks to the tables exactly, dead slots included, and moves with
    the tables."""
    _, t = _tables_with_dead_slots(leaves, space)
    T, I = t.fid.shape
    assert t.excl.shape[2] == words and t.num_trees == 4 and T == 6
    packed = t.packed()
    assert packed is t.packed()  # built once
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert packed.shape == (T, qs.packed_stride(I, leaves, words))
    assert packed.shape[1] % 4 == 0 and packed.shape[1] >= I * words * 4 + leaves + 1
    back = qs.unpack_tables(packed, I, leaves, words, t.num_trees, t.min_features)
    for name in ("fid", "thr", "excl", "leafval", "weight"):
        assert torch.equal(getattr(back, name), getattr(t, name)), name
    # the layout itself: record w * I + i is {fid, thr bits, low half, high half}
    rec = packed[:, : I * words * 4].view(T, words, I, 4).numpy()
    excl = t.excl.numpy().astype(np.uint64)
    for w in range(words):
        np.testing.assert_array_equal(rec[:, w, :, 0], t.fid.numpy())
        np.testing.assert_array_equal(rec[:, w, :, 1].view(np.float32), t.thr.numpy())
        np.testing.assert_array_equal(rec[:, w, :, 2].view(np.uint32),
                                      (excl[:, :, w] & 0xFFFFFFFF).astype(np.uint32))
        np.testing.assert_array_equal(rec[:, w, :, 3].view(np.uint32),
                                      (excl[:, :, w] >> np.uint64(32)).astype(np.uint32))
    # dead slots: no test fires, nothing is excluded, weight 0
    assert (t.thr[4:] == qs.FLT_MAX).all() and not t.excl[4:].any() and not t.weight[4:].any()
    moved = t.to("cpu")
    assert torch.equal(moved.packed(), packed)


@pytest.mark.parametrize("leaves,words", PACKED)
def test_scorer_on_packed_records_bitwise(leaves, words):
    """A plain scorer that reads the packed records equals the plain scorer
    on the tables and JAX's score_qs bit for bit; and so on u8 bins against
    bin-space tables."""
    jens, t = _tables_with_dead_slots(leaves, "value")
    I = t.fid.shape[1]
    back = qs.unpack_tables(t.packed(), I, leaves, words, t.num_trees, t.min_features)
    X = _features(257, 20, seed=leaves)
    got = qs.score_qs(torch.from_numpy(X), back)
    np.testing.assert_array_equal(got.numpy(), qs.score_qs(torch.from_numpy(X), t).numpy())
    want = np.asarray(jax_qs.score_qs(jnp.asarray(X), jax_qs.ensemble_to_qs(jens)))
    np.testing.assert_array_equal(got.numpy(), want)
    _, tb = _tables_with_dead_slots(leaves, "bin")
    bins = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(257, 20)).astype(np.uint8))
    back = qs.unpack_tables(tb.packed(), I, leaves, words, tb.num_trees, tb.min_features)
    np.testing.assert_array_equal(kernel_qs.score_qs(bins, back).numpy(),
                                  qs.score_qs(bins, tb).numpy())


@pytest.mark.parametrize("leaves", [1024, 2048])
def test_wide_trees_bitwise_match_jax(leaves):
    """Trees wider than one block's shared memory holds (the CUDA kernel
    streams their records in tiles of one tree): the plain scorer is bitwise
    JAX's score_qs and the compensated descent at 1,024 and 2,048 leaves,
    leaf sets of 16 and 32 words."""
    jens = jax_bestfirst(3, leaves, 24, seed=leaves)
    t = qs.ensemble_to_qs(_port(jens))
    assert t.excl.shape[2] == leaves // 64 and t.packed().shape[1] * 4 > 232448
    X = _features(193, 24, seed=leaves)
    got = qs.score_qs(torch.from_numpy(X), t).numpy()
    want = np.asarray(jax_qs.score_qs(jnp.asarray(X), jax_qs.ensemble_to_qs(jens)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, score_ensemble(torch.from_numpy(X), _port(jens), max_depth=2 * leaves).numpy())
