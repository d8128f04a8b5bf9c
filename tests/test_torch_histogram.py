"""The port's histograms (quickrank_tpu_torch/ops/histogram.py and the CPU
path of ops/kernel_histogram.py, the plain versions of the K4 and K5
kernels) against the JAX package on the CPU.

Against JAX's scatter paths the plain versions are bitwise equal: both add
docs in dataset order, bin by bin.  Against the Pallas kernels in interpret
mode (bf16 hi/lo value planes) they agree to rtol 2e-4, the JAX package's
own bound for those kernels (tests/test_trees.py), with the count channel
to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.ops import histogram as jax_hist
from quickrank_tpu.ops import pallas_histogram as ph
from quickrank_tpu.trees import grow as jax_grow
from quickrank_tpu_torch.ops import histogram, kernel_histogram
from quickrank_tpu_torch.ops.binning import apply_bins, build_thresholds
from quickrank_tpu_torch.trees.grow import segment_sums

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


def _problem(num_bins, N=700, F=10, seed=0, oob=False):
    """u8 bins from the port's binner, doc channels (count, g, g^2) zeroed
    outside a doc mask, node ids in [0, 8)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F)).astype(np.float32)
    th, _ = build_thresholds(X, num_bins - 1)
    binned = apply_bins(X, th)
    B = th.shape[1]
    if oob:  # ids >= num_bins must be dropped per element
        binned[rng.uniform(size=binned.shape) < 0.05] = B
    mask = rng.uniform(size=N) < 0.9
    g = rng.normal(size=N).astype(np.float32)
    chan = np.stack([mask, g * mask, g * g * mask], -1).astype(np.float32)
    node = rng.integers(0, 8, size=N).astype(np.int32)
    node[128:256] = 7  # one 128-doc tile with no doc of nodes 0..6
    return binned, chan, mask, node, B


def _kc(h, k, C):
    """[F, B, k*C] -> [k, F, B, C]"""
    F, B, _ = h.shape
    return np.moveaxis(np.asarray(h).reshape(F, B, k, C), 2, 0)


@pytest.mark.parametrize("num_bins", [64, 256])
@pytest.mark.parametrize("n0,k", [(0, 1), (2, 4)])
@pytest.mark.parametrize("oob", [False, True])
def test_node_histogram_plain_matches_jax(num_bins, n0, k, oob):
    binned, chan, mask, node, B = _problem(num_bins, oob=oob)
    vt = np.ascontiguousarray(chan.T)
    got = kernel_histogram.node_histogram(
        torch.from_numpy(binned.astype(np.uint8) if not oob or B < 256 else binned),
        torch.from_numpy(vt), torch.from_numpy(node), B, n0, k)
    assert got.shape == (binned.shape[1], B, k * 3)
    got = _kc(got.numpy(), k, 3)

    # bitwise: JAX's scatter path over the same nodes
    want = np.asarray(jax_hist.node_histograms_scatter(
        jnp.asarray(binned), jnp.asarray(chan), jnp.asarray(node - n0),
        jnp.ones(len(node), bool), k, B))
    np.testing.assert_array_equal(got, want)

    # the Pallas kernel in interpret mode (tile 128, 4-feature groups)
    pallas = _kc(ph.node_histogram_pallas(
        jnp.asarray(binned), jnp.asarray(vt), jnp.asarray(node), B, n0, k,
        tile_n=128, feat_group=4, interpret=True), k, 3)
    np.testing.assert_allclose(got[..., 0], pallas[..., 0], atol=1e-5)
    np.testing.assert_allclose(got[..., 1:], pallas[..., 1:], rtol=2e-4, atol=1e-4)
    if oob:  # dropped elements are gone: counts per (node, feature)
        in_node = (node >= n0) & (node < n0 + k)
        for i in range(k):
            sel = (node == n0 + i) & mask & in_node
            np.testing.assert_array_equal(got[i, ..., 0].sum(-1),
                                          (binned[sel] < B).sum(0))


def test_masked_histogram_t_matches_jax():
    """The best-first split histogram: subset as a 0/1 node row, f_used."""
    binned, chan, mask, _, B = _problem(256, seed=1)
    sub = (np.random.default_rng(2).uniform(size=len(mask)) < 0.5) & mask
    chan_t = np.ascontiguousarray(chan.T)
    want = np.asarray(jax_hist.masked_histogram_t(
        jnp.asarray(binned), jnp.asarray(chan_t), jnp.asarray(sub), B, f_used=7))
    got = histogram.masked_histogram_t(
        torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(chan_t),
        torch.from_numpy(sub), B, f_used=7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_nodes", [3, 16])
def test_node_histograms_packing_matches_jax(num_nodes):
    """node_histograms packs 32 // C nodes per pass (16 nodes: two passes)
    and equals JAX's CPU path, the one scatter over every node."""
    binned, chan, mask, _, B = _problem(64, seed=3)
    node = np.random.default_rng(4).integers(0, num_nodes + 1, size=len(mask)).astype(np.int32)
    want = np.asarray(jax_hist.node_histograms(
        jnp.asarray(binned), jnp.asarray(chan), jnp.asarray(node),
        jnp.asarray(mask), num_nodes, B))
    got = histogram.node_histograms(
        torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(chan),
        torch.from_numpy(node), torch.from_numpy(mask), num_nodes, B)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_slots", [32, 9])
def test_histogram_plain_matches_jax(num_slots):
    """K5's plain version: JAX's CPU segment sums bitwise, and
    histogram_pallas in interpret mode within rtol 2e-4."""
    rng = np.random.default_rng(num_slots)
    N = 500
    index = rng.integers(0, num_slots, size=N).astype(np.int32)
    vals = rng.normal(size=(N, 2)).astype(np.float32)
    got = segment_sums(torch.from_numpy(index), torch.from_numpy(vals), num_slots)
    want = np.asarray(jax_grow.segment_sums(jnp.asarray(index), jnp.asarray(vals), num_slots))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(ph.histogram_pallas(
        jnp.asarray(index)[:, None], jnp.asarray(vals), num_slots,
        tile_n=128, feat_group=4, interpret=True))[0]
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("first", [*range(1, 257, 32), 1024, 1025, 4096, 4097])
def test_prefix_sum_and_tree_sum_match_xla(first):
    """Bin-axis sums in XLA's CPU order, bitwise, at every bin count from 1
    to 256 (and 257), 32 counts a case, and at the wide-bin lengths 1,024,
    1,025, 4,096 and 4,097 (two and three levels of the rewrites), one a
    case: the port's ``_node_stats`` against the JAX package's jitted
    ``_node_stats`` (the grower's reduce), and ``prefix_sum`` against
    ``jnp.cumsum`` (the gain scan's), on [F, B, 3] histograms whose values
    span 2^-11..2^11 in magnitude."""
    import jax

    from quickrank_tpu_torch.trees.grow import _node_stats

    if first > 257:
        lengths = [first]
    else:
        lengths = list(range(first, first + 32)) + ([257] if first + 32 > 256 else [])
    rng = np.random.default_rng(first)
    hs = [(rng.normal(size=(3, n, 3)) * np.exp2(rng.uniform(-11, 11, size=(3, n, 3))))
          .astype(np.float32) for n in lengths]
    want = jax.jit(lambda hs: [(jax_grow._node_stats(h), jnp.cumsum(h, axis=1))
                               for h in hs])([jnp.asarray(h) for h in hs])
    for n, h, (stats, cum) in zip(lengths, hs, want):
        got = torch.stack(_node_stats(torch.from_numpy(h))).numpy()
        np.testing.assert_array_equal(
            got.view(np.int32), np.stack([np.asarray(v) for v in stats]).view(np.int32),
            err_msg=f"tree_sum at {n} bins")
        np.testing.assert_array_equal(
            histogram.prefix_sum(torch.from_numpy(h), 1).numpy(), np.asarray(cum),
            err_msg=f"prefix_sum at {n} bins")


def test_cpu_wrappers_launch_nothing():
    binned, chan, mask, node, B = _problem(64, seed=5)
    before = dict(kernel_histogram.LAUNCHES)
    kernel_histogram.node_histogram(
        torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(np.ascontiguousarray(chan.T)),
        torch.from_numpy(node), B, 0, 2)
    kernel_histogram.histogram(torch.from_numpy(binned), torch.from_numpy(chan), B)
    assert kernel_histogram.LAUNCHES == before


def test_cpu_growers_launch_no_split_kernel():
    """A best-first and an oblivious tree grown on the CPU take the loops:
    no split-scan, node-statistics or XLA-order sum launch."""
    from quickrank_tpu_torch.ops import kernel_split
    from quickrank_tpu_torch.trees import grow
    from quickrank_tpu_torch.trees.oblivious import fit_oblivious_tree

    binned, chan, mask, node, B = _problem(64, seed=6)
    args = (torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(chan[:, 1].copy()),
            torch.from_numpy(mask), torch.zeros((binned.shape[1], B)))
    before = dict(kernel_split.LAUNCHES)
    tree, _ = grow.fit_tree(*args, grow.GrowConfig(nleaves=8, num_bins=B))
    assert int((~tree.is_leaf).sum()) > 0
    fit_oblivious_tree(*args, depth=3)
    assert kernel_split.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "values", "pos", "contiguous", "channels", "device"])
def test_wrappers_reject_bad_input(bad):
    binned = torch.zeros((16, 4), dtype=torch.uint8)
    vt = torch.zeros((3, 16))
    pos = torch.zeros(16, dtype=torch.int32)
    if bad == "dtype":
        binned = binned.long()
    elif bad == "values":
        vt = torch.zeros((3, 15))
    elif bad == "pos":
        pos = pos.long()
    elif bad == "contiguous":
        vt = torch.zeros((16, 3)).T
    elif bad == "channels":
        vt = torch.zeros((9, 16))
    elif bad == "device":
        binned, vt, pos = binned.to("meta"), vt.to("meta"), pos.to("meta")
    with pytest.raises(ValueError):
        kernel_histogram.node_histogram(binned, vt, pos, 8, 0, 1)


def _fixed_problem(C, seed=0, N=3000, F=6, B=64):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B + 3, size=(N, F)).astype(np.uint8)  # some ids dropped
    g = (rng.normal(size=N) * 10.0 ** rng.integers(-3, 3, size=N)).astype(np.float32)
    chan = np.stack([np.ones(N, np.float32), g, g * g, np.abs(g)])[:C]
    pos = rng.integers(0, 8, size=N).astype(np.int32)
    return (torch.from_numpy(binned), torch.from_numpy(np.ascontiguousarray(chan)),
            torch.from_numpy(pos), B)


@pytest.mark.parametrize("n0,k", [(0, 1), (2, 4), (5, 6)])
@pytest.mark.parametrize("C", [2, 3, 4])
def test_node_histogram_fixed_within_rounding_error(C, n0, k):
    """The exact reference of the kernels (their own fixed-point arithmetic
    in plain torch) is within ``rounding_error`` a term of the float64 sum,
    plus the final float32 rounding; the count channel is exact."""
    binned, vt, pos, B = _fixed_problem(C, seed=C + k)
    got = kernel_histogram.node_histogram_fixed(binned, vt, pos, B, n0, k)
    assert got.shape == (binned.shape[1], B, k * C) and got.dtype == torch.float32
    exact, terms = (kernel_histogram.node_histogram_plain(binned, v, pos, B, n0, k)
                    for v in (vt.double(), torch.ones_like(vt).double()))
    bound = (terms * kernel_histogram.rounding_error(vt).repeat(k)
             + 2.0 ** -24 * exact.abs())
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert torch.equal(got[..., ::C].double(), exact[..., ::C])
    # f_used limits the features and changes nothing else
    part = kernel_histogram.node_histogram_fixed(binned, vt, pos, B, n0, k, f_used=4)
    assert torch.equal(part, got[:4])


@pytest.mark.parametrize("C", [2, 3])
def test_node_histogram_fixed_is_order_free(C):
    """Integer sums: any order of the docs gives the same bits (the float32
    scatter-add does not), and so do two halves summed apart when they
    share their scale."""
    binned, vt, pos, B = _fixed_problem(C, seed=7)
    want = kernel_histogram.node_histogram_fixed(binned, vt, pos, B, 1, 5)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(binned.shape[0]))
    got = kernel_histogram.node_histogram_fixed(
        binned[perm].contiguous(), vt[:, perm].contiguous(), pos[perm].contiguous(), B, 1, 5)
    assert torch.equal(got, want)
    back = kernel_histogram.node_histogram_fixed(
        binned.flip(0).contiguous(), vt.flip(1).contiguous(), pos.flip(0).contiguous(), B, 1, 5)
    assert torch.equal(back, want)


def test_histogram_fixed_form_of_k5():
    """K5's exact reference is the same function with every doc in node 0
    and the doc-major values transposed."""
    rng = np.random.default_rng(11)
    index = torch.from_numpy(rng.integers(0, 34, size=(4000, 1)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(4000, 2)).astype(np.float32))
    got = kernel_histogram.node_histogram_fixed(index, vals.T.contiguous(), None, 32, 0, 1)
    exact, terms = (kernel_histogram.histogram_plain(index, v, 32)
                    for v in (vals.double(), torch.ones_like(vals).double()))
    bound = terms * kernel_histogram.rounding_error(vals.T) + 2.0 ** -24 * exact.abs()
    assert got.shape == (1, 32, 2)
    assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("what", ["nan", "inf", "zeros", "empty"])
def test_node_histogram_fixed_special_values(what):
    """A channel with a non-finite value is NaN and the others are kept; an
    all-zero channel and an empty matrix give zeros."""
    binned, vt, pos, B = _fixed_problem(3, seed=1)
    if what == "empty":
        out = kernel_histogram.node_histogram_fixed(binned[:0], vt[:, :0].contiguous(),
                                                    pos[:0], B, 0, 2)
        assert out.shape == (binned.shape[1], B, 6) and not out.any()
        return
    clean = kernel_histogram.node_histogram_fixed(binned, vt, pos, B, 0, 2)
    vt = vt.clone()
    vt[1, 5] = {"nan": float("nan"), "inf": float("inf"), "zeros": 0.0}[what]
    if what == "zeros":
        vt[1] = 0.0
    out = kernel_histogram.node_histogram_fixed(binned, vt, pos, B, 0, 2)
    assert torch.equal(out[..., 0::3], clean[..., 0::3])
    assert torch.equal(out[..., 2::3], clean[..., 2::3])
    if what == "zeros":
        assert not out[..., 1::3].any()
    else:
        assert bool(out[..., 1::3].isnan().all())


def test_wrapper_shared_memory_limit():
    """Where the block path's smallest block cannot hold one feature's C * B
    cells, a launch takes the wide-bin path (``past_shared_memory``): not at
    256 bins, from 9,633 bins at C = 3."""
    assert kernel_histogram.min_shared_bytes(3, 256) < kernel_histogram.SMEM_MAX
    assert kernel_histogram.min_shared_bytes(8, 256) < kernel_histogram.SMEM_MAX
    assert kernel_histogram.min_shared_bytes(1, 1 << 15) > kernel_histogram.SMEM_MAX
    assert not kernel_histogram.past_shared_memory(3, 4096)
    assert kernel_histogram.past_shared_memory(3, 16384)
    assert kernel_histogram.past_shared_memory(1, 1 << 15)
    past = [b for b in range(9000, 10000) if kernel_histogram.past_shared_memory(3, b)]
    assert past == list(range(9633, 10000))  # C = 3: from 9,633 bins


@pytest.mark.parametrize("C", range(1, 9))
def test_wide_plan_tiles_every_bin_once(C):
    """The wide-bin path's plan (``wide_plan``, the kernel's own
    arithmetic) at every bin count from 257 to 65,536: the fewest even
    tiles whose cells fit one CTA, every bin of a feature in exactly one
    tile (so every (feature, bin) cell in exactly one CTA a node slot), no
    CTA past ``SMEM_MAX``."""
    smem_max = kernel_histogram.SMEM_MAX
    per_bin = 8 * C  # two 32-bit words a bin and channel
    for num_bins in range(257, 65537):
        p = kernel_histogram.wide_plan(C, num_bins)
        assert p.smem == 64 + per_bin * p.tile_bins <= smem_max
        assert p.tiles * p.tile_bins >= num_bins > (p.tiles - 1) * p.tile_bins
        # fewer tiles would not fit: the tile of ceil(B / (tiles - 1)) bins
        if p.tiles > 1:
            assert 64 + per_bin * -(-num_bins // (p.tiles - 1)) > smem_max
    for num_bins in (257, 9973, 16384, 65536):
        p = kernel_histogram.wide_plan(C, num_bins)
        tile = np.arange(num_bins) // p.tile_bins
        assert np.bincount(tile, minlength=p.tiles).max() <= p.tile_bins
        assert tile.max() == p.tiles - 1


def test_wide_plan_of_the_wide_bin_shapes():
    """The plans the wide-bin training shapes take: at 16,384 bins 2 tiles
    of 8,192 (C = 3, K4; C = 2, K5), at 4,096 bins one tile, at 65,536 bins
    7 tiles (C = 3) and 5 (C = 2)."""
    def plan(C, B):
        p = kernel_histogram.wide_plan(C, B)
        return p.tiles, p.tile_bins

    assert plan(3, 16384) == (2, 8192) and plan(2, 16384) == (2, 8192)
    assert plan(3, 4096) == (1, 4096) and plan(3, 29046) == (3, 9682)
    assert plan(3, 65536) == (7, 9363) and plan(2, 65536) == (5, 13108)
