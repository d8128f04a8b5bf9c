"""The growers' split scan, node statistics and XLA-order sums on the card
(quickrank_tpu_torch/ops/kernel_split.py, csrc/split_scan.cu) against their
plain versions, the Python loops of ops/histogram.py and trees/grow.py run
on the same card tensors: equal bit for bit, compared as int32 views.  The
card tests need a CUDA device and skip without one; the file imports no
JAX, so it runs on the card with ``--noconftest``.  The CPU tests hold the
wrappers' host-side arithmetic and their refusals."""

import dataclasses

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.ops import histogram, kernel_split
from quickrank_tpu_torch.trees import grow

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

#: bin counts of the sums: every count from 1 to 257 (32 a case), and the
#: wide-bin lengths with two and three levels of the rewrites
LENGTHS = [*range(1, 258, 32), 1024, 1025, 4096, 4097, 16384]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().contiguous().numpy().view(np.int32)


def _values(rng, shape) -> np.ndarray:
    """Values spanning 2^-11..2^11 in magnitude, both signs, a few -0.0."""
    v = (rng.normal(size=shape) * np.exp2(rng.uniform(-11, 11, size=shape))).astype(np.float32)
    v[rng.uniform(size=shape) < 0.01] = -0.0
    return v


def _lengths(first):
    if first > 257:
        return [first]
    return list(range(first, min(first + 32, 258)))


@pytest.mark.gpu
@pytest.mark.parametrize("first", LENGTHS)
def test_prefix_sum_and_tree_sum_match_loops(cuda_device, first):
    """One launch each, bitwise the loops, at several shapes and axes: the
    growers' ``[k, F, B, C]`` along the bins, a channel-major view, a 1-D
    row, and transposed (strided) views."""
    rng = np.random.default_rng(first)
    for n in _lengths(first):
        h = torch.from_numpy(_values(rng, (3, n, 3))).to(cuda_device)
        cases = [(h, 1), (h.reshape(1, 3, n, 3), 2), (h[0, :, 0].contiguous(), 0),
                 (h.transpose(0, 1), 0), (h.permute(2, 0, 1), -1)]
        for x, dim in cases:
            before = kernel_split.LAUNCHES["prefix_sum"]
            got = histogram.prefix_sum(x, dim)
            assert kernel_split.LAUNCHES["prefix_sum"] == before + 1
            want = histogram._prefix_sum_loops(x, dim)
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"prefix_sum {tuple(x.shape)} dim {dim}")
        for x in (h.transpose(1, 2), h.permute(2, 0, 1).contiguous(), h[1, :, 2]):
            before = kernel_split.LAUNCHES["tree_sum"]
            got = histogram.tree_sum(x)
            assert kernel_split.LAUNCHES["tree_sum"] == before + 1
            np.testing.assert_array_equal(_bits(got), _bits(histogram._tree_sum_loops(x)),
                                          err_msg=f"tree_sum {tuple(x.shape)}")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 32, 33, 131072, 131073, 1 << 22])
def test_tree_sum_long_rows_match_loops(cuda_device, n):
    """A doc axis as DART sums it: the windows built from global memory at
    one, two and three levels below the top."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_values(rng, (2, n))).to(cuda_device)
    np.testing.assert_array_equal(_bits(histogram.tree_sum(x)),
                                  _bits(histogram._tree_sum_loops(x)))


def _histograms(rng, k, F, B, minls):
    """k nodes' [F, B, 3] histograms of integer counts, with a constant node
    (every bin ties) and a node none of whose bins can split."""
    cnt = rng.integers(0, 6, size=(k, F, B)).astype(np.float32)
    g = (rng.normal(size=(k, F, B)) * cnt).astype(np.float32)
    h = np.stack([cnt, g, (g * g).astype(np.float32)], -1)
    if k > 1:  # the same bins in every feature, and gains that tie over the bins
        h[1] = np.array([3.0, 1.5, 2.25], np.float32)
    if k > 2:
        h[2, :, :, 0] = 0.0  # no doc: no valid candidate
        h[2, :, 0, 0] = minls - 1 if minls > 1 else 0.0
    return h


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("minls", [1, 40])
@pytest.mark.parametrize("B", [64, 256, 1025])
def test_best_splits_match_loops(cuda_device, k, minls, B):
    rng = np.random.default_rng(k * 1000 + minls * 10 + B)
    F = 12
    h = torch.from_numpy(_histograms(rng, k, F, B, minls)).to(cuda_device)
    masks = torch.from_numpy(rng.uniform(size=(k, F)) < 0.6)
    masks[0] = True
    masks[:, F - 1] = True
    if k > 3:
        masks[3] = False  # a node with no sampled feature
    masks = masks.to(cuda_device)
    before = kernel_split.LAUNCHES["split_scan"]
    got = grow._best_splits(h, masks, minls)
    assert kernel_split.LAUNCHES["split_scan"] == before + 1
    want = grow._best_splits_plain(h, masks, minls)
    for name, a, b in zip(("can_split", "f_star", "t_star", "gain"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), err_msg=name)
    np.testing.assert_array_equal(_bits(got[3]), _bits(want[3]))
    if k > 1:  # the constant node: the first maximum wins
        assert int(got[1][1]) == int(torch.nonzero(masks[1])[0, 0])
    if k > 2:
        assert not bool(got[0][2]) and float(got[3][2]) == float("-inf")
        assert (int(got[1][2]), int(got[2][2])) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 31, 64, 256, 1025, 16384])
def test_node_stats_match_loops(cuda_device, B):
    rng = np.random.default_rng(B)
    nodes, F = 7, 3
    h = torch.from_numpy(_values(rng, (nodes, F, B, 3))).to(cuda_device)
    h[..., 0] = h[..., 0].abs().round()
    h[4, :, :, 0] = 0.0  # a node of count 0: deviance 0
    dev = torch.full((nodes + 2,), 7.0, device=cuda_device)
    grow.set_deviance(dev, h, 2, 4)
    grow.set_deviance(dev, h, 0, 1)
    want = grow._deviance(*grow._node_stats(h))
    np.testing.assert_array_equal(_bits(dev[:1]), _bits(want[:1]))
    np.testing.assert_array_equal(_bits(dev[2:6]), _bits(want[2:6]))
    assert float(dev[4]) == 0.0
    assert dev[[1, 6, 7, 8]].tolist() == [7.0] * 4  # nothing else written


def _plain_kernels(monkeypatch):
    """Route every kernel_split entry to its plain version (the loops) on
    the card tensors, as the growers ran before the kernels."""
    def node_stats(hist, deviance, start, count):
        deviance[start:start + count] = grow._deviance(*grow._node_stats(hist[start:start + count]))

    monkeypatch.setattr(kernel_split, "split_scan", grow._best_splits_plain)
    monkeypatch.setattr(kernel_split, "node_stats", node_stats)
    monkeypatch.setattr(kernel_split, "prefix_sum", histogram._prefix_sum_loops)
    monkeypatch.setattr(kernel_split, "tree_sum", histogram._tree_sum_loops)


def _tensors(ens) -> dict:
    return {f.name: getattr(ens, f.name) for f in dataclasses.fields(ens)
            if isinstance(getattr(ens, f.name), torch.Tensor)}


@pytest.mark.gpu
@pytest.mark.parametrize("growth", ["best", "bestk", "level", "cluster", "oblivious"])
def test_learn_matches_loops(cuda_device, monkeypatch, growth):
    """20 trees grown on the card with the kernels equal, tensor by tensor,
    the 20 trees grown with the loops; a best-first tree launches one split
    scan a split decision and one node-statistics launch for the root and
    one for each split's two children."""
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
    from quickrank_tpu_torch.metrics import Ndcg

    data = make_ranking_dataset(num_queries=60, seed=21)

    def learn():
        if growth == "oblivious":
            m = ObliviousLambdaMart(ntrees=20, treedepth=4, seed=1)
        else:
            m = LambdaMart(ntrees=20, nleaves=16, growth="best" if growth == "cluster" else growth,
                           max_depth=4 if growth == "level" else 0,
                           cluster="on" if growth == "cluster" else "off", seed=1)
        m.learn(data, None, Ndcg(10), verbose=False, device="cuda")
        return m

    for name in kernel_split.LAUNCHES:
        kernel_split.LAUNCHES[name] = 0
    grow.HOST_SYNCS = 0
    fast = learn()
    launches, syncs = dict(kernel_split.LAUNCHES), grow.HOST_SYNCS
    with monkeypatch.context() as mp:
        _plain_kernels(mp)
        slow = learn()
    a, b = _tensors(fast.ensemble), _tensors(slow.ensemble)
    assert a.keys() == b.keys() and a
    for name in a:
        if a[name].dtype == torch.float32:
            np.testing.assert_array_equal(_bits(a[name]), _bits(b[name]), err_msg=name)
        else:
            assert torch.equal(a[name].cpu(), b[name].cpu()), name
    if growth in ("best", "cluster"):
        splits = int((~fast.ensemble.is_leaf[:20]).sum())
        assert launches["split_scan"] == syncs
        assert launches["node_stats"] == 20 + splits  # the root, then both children at once
    elif growth in ("level", "oblivious"):
        assert launches["prefix_sum"] == 20 * 4
        assert launches["split_scan"] == launches["node_stats"] == 0
    else:
        assert launches["split_scan"] == syncs > 0


@pytest.mark.parametrize("entry", ["split_scan", "node_stats", "prefix_sum", "tree_sum"])
def test_wrappers_refuse_cpu_tensors(entry):
    h = torch.zeros((2, 3, 8, 3))
    call = {"split_scan": lambda: kernel_split.split_scan(h, torch.ones(2, 3, dtype=torch.bool), 1),
            "node_stats": lambda: kernel_split.node_stats(h, torch.zeros(2), 0, 1),
            "prefix_sum": lambda: kernel_split.prefix_sum(h, 2),
            "tree_sum": lambda: kernel_split.tree_sum(h)}[entry]
    before = dict(kernel_split.LAUNCHES)
    with pytest.raises(ValueError):
        call()
    assert kernel_split.LAUNCHES == before
