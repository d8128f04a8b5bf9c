"""The build's binning on the CPU (learning/mart.py::TrainData.build,
ops/binning.py::device_bin_wire): the layout made without the host feature
copy, the column maps of every layout, the wire against the host layout's,
and the ids' rules at the edges.  The
kernel itself is held against the host binner on the card
(tests/test_torch_binning_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.data.dataset import rank_block, shard_and_pad
from quickrank_tpu_torch.data.synthetic import make_train_valid_test
from quickrank_tpu_torch.learning.mart import (
    TrainData,
    block_wire,
    build_valid_traindata,
    column_map,
)
from quickrank_tpu_torch.ops import binning
from quickrank_tpu_torch.ops.binning import (
    FLT_MAX,
    apply_bins,
    bin_wire,
    build_thresholds,
    device_bin_wire,
)
from quickrank_tpu_torch.parallel.mesh import FeatureShard

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(30, 12, 3), seed=5)


def _layouts(ds):
    """(name, kwargs of shard_and_pad, the dataset it lays out)."""
    dims = rank_block(ds, 3, 1).dims
    return {
        "one": ({}, ds),
        "block0": (dict(num_shards=3, block=0), ds),
        "block2": (dict(num_shards=3, block=2), ds),
        "force_dims": (dict(force_dims=(dims[0] + 1, dims[1] + 1024, dims[2] + 3)),
                       rank_block(ds, 3, 1)),
    }


@pytest.mark.parametrize("layout", ["one", "block0", "block2", "force_dims"])
def test_layout_without_features_keeps_every_index_array(folds, layout):
    kw, ds = _layouts(folds[0])[layout]
    full = shard_and_pad(ds, **kw)
    bare = shard_and_pad(ds, **kw, features=False)
    assert bare.features is None and full.features is not None
    for f in dataclasses.fields(full):
        a, b = getattr(full, f.name), getattr(bare, f.name)
        if f.name == "features":
            continue
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("nthr", [255, 1023])
def test_cpu_build_bins_on_the_host(folds, nthr):
    """No kernel launch on the CPU; the wire is the host binner's ids of the
    padded features, pad columns 0, in the wire's dtype; the build's layout
    holds no feature copy."""
    before = binning.DEVICE_BUILDS
    td = TrainData.build(folds[0], nthr, device="cpu")
    vd = build_valid_traindata(td, folds[1], nthr, "cpu")
    assert binning.DEVICE_BUILDS == before
    for t, ds in ((td, folds[0]), (vd, folds[1])):
        assert t.padded.features is None
        feats = shard_and_pad(ds).features
        th = t.thresholds[:feats.shape[1]]
        ids = apply_bins(feats, th)
        W = t.step.binned.shape[1]
        want = bin_wire(np.pad(ids, ((0, 0), (0, W - ids.shape[1]))), th.shape[1])
        assert t.step.binned.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(t.step.binned.numpy(), want)


@pytest.mark.parametrize("layout", ["one", "block0", "block2", "force_dims", "valid"])
def test_block_wire_is_the_host_layouts_wire(folds, layout):
    """What the build hands the binner (the block's rows of the dataset, the
    tables, the column map, the padded row count), binned on the CPU, is the
    wire of the host layout's padded features."""
    tr, va, _ = folds
    th, _ = build_thresholds(tr.features, 255)
    kw, ds = _layouts(tr)["one" if layout == "valid" else layout]
    if layout == "valid":
        ds = va
    host = shard_and_pad(ds, **kw)
    F = ds.num_features
    W = column_map(F, F + 9, None)
    want = np.pad(apply_bins(host.features, th), ((0, 0), (0, len(W) - F)))
    bare = shard_and_pad(ds, **kw, features=False)
    got = block_wire(ds, bare, th, W, "cpu")
    np.testing.assert_array_equal(got.numpy(), bin_wire(want, th.shape[1]))


class _Feat:
    def __init__(self, rank, size):
        self.rank, self.world_size = rank, size


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_mesh_map_is_column_zero_then_the_rank_block(folds, rank):
    """Under a 2-D mesh a rank's wire is the one-block wire's column 0, then
    its block of the global columns (zero past the real ones)."""
    tr = folds[0]
    th, _ = build_thresholds(tr.features, 255)
    F, f_blk = tr.num_features, 64
    feat = FeatureShard(_Feat(rank, 3), f_blk)
    cmap = column_map(F, f_blk, feat)
    assert len(cmap) == 1 + f_blk and cmap[0] == 0
    one = block_wire(tr, shard_and_pad(tr, features=False), th,
                     column_map(F, 3 * f_blk, None), "cpu").numpy()
    got = block_wire(tr, shard_and_pad(tr, features=False), th, cmap, "cpu").numpy()
    np.testing.assert_array_equal(got[:, 0], one[:, 0])
    np.testing.assert_array_equal(got[:, 1:], one[:, feat.lo:feat.lo + f_blk])


@pytest.mark.parametrize("bins", [3, 256, 1024, 70000])
def test_plain_ids_at_the_edges(bins):
    """NaN and +inf take the top bin, -inf bin 0, a value equal to a
    threshold that threshold's bin, FLT_MAX the sentinel's; pad rows the bin
    of 0.0, pad columns 0; the dtype follows the bin count."""
    th = np.full((2, bins), FLT_MAX, np.float32)
    real = np.linspace(-1.0, 1.0, bins - 1, dtype=np.float32)
    th[0, :-1] = real
    th[1, :1] = [0.25]  # a feature with one threshold and the padded sentinels
    mid = real[len(real) // 2]
    x = np.array([[np.nan, np.nan], [np.inf, np.inf], [-np.inf, -np.inf],
                  [mid, 0.25], [np.nextafter(mid, np.float32(2)), 0.3], [FLT_MAX, -0.0]],
                 np.float32)
    got = device_bin_wire(x, th, np.array([0, 1, -1]), len(x) + 2, "cpu")
    assert got.dtype == (torch.uint8 if bins <= 256 else torch.uint16 if bins <= 65536
                         else torch.int32)
    ids = binning.widen(got).numpy()
    top = bins - 1
    want_mid = len(real) // 2
    zero = int(np.searchsorted(real, 0.0, side="left"))
    np.testing.assert_array_equal(ids, [
        [top, top, 0], [top, top, 0], [0, 0, 0], [want_mid, 0, 0],
        [min(want_mid + 1, top), 1, 0], [top, 0, 0], [zero, 0, 0], [zero, 0, 0]])


def test_device_bin_wire_refuses_what_the_kernel_cannot_bin():
    x = np.zeros((4, 3), np.float32)
    th = np.full((3, 5), FLT_MAX, np.float32)
    with pytest.raises(ValueError, match="thresholds for 2 features"):
        device_bin_wire(x, th[:2], np.arange(3), 4, "cpu")
    with pytest.raises(ValueError, match="column map out of range"):
        device_bin_wire(x, th, np.array([0, 3]), 4, "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        device_bin_wire(x, th, np.arange(3), 3, "cpu")
