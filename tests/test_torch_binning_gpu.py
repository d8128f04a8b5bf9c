"""The bin matrix written on the card (quickrank_tpu_torch/ops/binning.py::
device_bin_wire, csrc/bin_apply.cu) against the host binner: the wire equals
``bin_wire`` of ``apply_bins``'s ids, padded as the host layout pads them,
bit for bit, and ``TrainData.build`` on the card equals the CPU build in
every step tensor.  The tests need a CUDA device and skip without one; the
file imports no JAX, so it runs on the card with ``--noconftest``."""

import dataclasses

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.data.synthetic import make_train_valid_test
from quickrank_tpu_torch.learning import LambdaMart
from quickrank_tpu_torch.learning.mart import TrainData, build_valid_traindata
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.ops import binning
from quickrank_tpu_torch.ops.binning import FLT_MAX, apply_bins, bin_wire, build_thresholds

#: (features, thresholds a table or None for one built from the rows, rows):
#: the u8 wire with the table in shared memory, the u16 wire from global
#: memory (1,023 and 16,383 thresholds at 136 features) and from shared
#: memory (8 features), and the int32 wire past 65,536 bins
CASES = {
    "u8-255": (136, 255, 3000),
    "u16-1023": (136, 1023, 3000),
    "u16-16383": (136, 16383, 20000),
    "u16-1023-shared": (8, 1023, 3000),
    "i32-70000": (3, None, 1500),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, n, F, thresholds):
    """float32 rows of mixed scales with NaN, +-inf, +-0.0, +-FLT_MAX,
    subnormals, values equal to a threshold and one ulp either side."""
    x = (rng.normal(size=(n, F)) * np.exp2(rng.integers(-8, 8, size=(n, F)))).astype(np.float32)
    x[:, ::4] = np.round(x[:, ::4])  # few distinct values: short, FLT_MAX-padded tables
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, FLT_MAX, -FLT_MAX, 1e-45, -1e-45],
                       np.float32)
    pick = rng.uniform(size=(n, F))
    x = np.where(pick < 0.03, special[rng.integers(0, len(special), size=(n, F))], x)
    if thresholds is not None:
        B = thresholds.shape[1]
        t = thresholds[np.arange(F)[None, :], rng.integers(0, B, size=(n, F))]
        x = np.where(pick > 0.85, t, x)
        with np.errstate(over="ignore"):  # FLT_MAX's next value up is +inf
            x = np.where(pick > 0.95, np.nextafter(t, np.float32(np.inf)), x)
            x = np.where(pick > 0.97, np.nextafter(t, np.float32(-np.inf)), x)
    return np.ascontiguousarray(x, np.float32)


def _case(name):
    F, nthr, n = CASES[name]
    rng = np.random.default_rng(len(name) * 7 + F)
    if nthr is None:  # a table past 65,536 bins, built by hand
        th = np.sort(rng.normal(size=(F, 70000)).astype(np.float32), axis=1)
        th[:, -1] = FLT_MAX
        th[1, 40000:] = FLT_MAX  # a feature with fewer thresholds
    else:
        th, _ = build_thresholds(_rows(rng, n, F, None), nthr)
    return _rows(rng, n, F, th), th


def _host(x, th, col_map, n_loc):
    """The host layout's wire: zero pad rows, the mapped columns binned by
    ``apply_bins``, pad columns 0."""
    cols = col_map[col_map >= 0]
    feats = np.zeros((n_loc, x.shape[1]), np.float32)
    feats[:len(x)] = x
    ids = np.zeros((n_loc, len(col_map)), np.int32)
    ids[:, :len(cols)] = apply_bins(np.ascontiguousarray(feats[:, cols]), th[cols])
    return bin_wire(ids, th.shape[1])


def _maps(F):
    """The one-block map (the F columns, then pad columns) and the 2-D
    mesh's of each of two feature ranks (column 0, then the rank's block)."""
    f_blk = -(-F // 2)
    maps = {"plain": np.r_[np.arange(F), -np.ones(9, np.int64)]}
    for r in (0, 1):
        cols = [0] + list(range(r * f_blk, min((r + 1) * f_blk, F)))
        maps[f"mesh{r}"] = np.r_[cols, -np.ones(1 + f_blk - len(cols), np.int64)]
    return maps


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_equals_host_binner(cuda_device, name):
    x, th = _case(name)
    n = len(x)
    for label, col_map in _maps(x.shape[1]).items():
        for n_loc in (n, n + 1, n + 1029):
            before = binning.DEVICE_BUILDS
            got = binning.device_bin_wire(x, th, col_map, n_loc, cuda_device)
            assert binning.DEVICE_BUILDS == before + 1
            want = _host(x, th, col_map, n_loc)
            assert got.dtype == torch.from_numpy(want).dtype, (label, got.dtype)
            np.testing.assert_array_equal(got.cpu().numpy(), want,
                                          err_msg=f"{name} {label} n_loc={n_loc}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["u8-255", "u16-16383"])
@pytest.mark.parametrize("rows_a_piece", [1000, 1013, 5000])
def test_pieces_of_rows_give_the_one_piece_wire(cuda_device, monkeypatch, name,
                                                rows_a_piece):
    """Rows uploaded and binned in pieces (a launch a piece; pieces that do
    and do not divide the rows) give the host's wire, pad rows included."""
    x, th = _case(name)
    monkeypatch.setattr(binning, "UPLOAD_BYTES", rows_a_piece * 4 * x.shape[1])
    col_map = _maps(x.shape[1])["plain"]
    for n in (len(x), len(x) - 7):
        for n_loc in (n, n + 1029):
            got = binning.device_bin_wire(x[:n], th, col_map, n_loc, cuda_device)
            np.testing.assert_array_equal(got.cpu().numpy(), _host(x[:n], th, col_map, n_loc),
                                          err_msg=f"{name} n={n} n_loc={n_loc}")


@pytest.mark.gpu
def test_pad_rows_take_the_bin_of_zero(cuda_device):
    """A table whose first threshold is below 0.0: pad rows are not id 0,
    also in a block with no real rows."""
    th = np.array([[-1.0, 0.5, FLT_MAX], [-2.0, -1.0, FLT_MAX]], np.float32)
    x = np.array([[np.nan, -np.inf]], np.float32)
    got = binning.device_bin_wire(x, th, np.array([0, 1, -1]), 3, cuda_device).cpu().numpy()
    np.testing.assert_array_equal(got, [[2, 0, 0], [1, 2, 0], [1, 2, 0]])
    got = binning.device_bin_wire(x[:0], th, np.array([0, 1, -1]), 2, cuda_device)
    np.testing.assert_array_equal(got.cpu().numpy(), [[1, 2, 0], [1, 2, 0]])


@pytest.mark.gpu
@pytest.mark.parametrize("nthr", [255, 1023])
def test_build_on_card_equals_cpu_build(cuda_device, nthr):
    """Every step tensor of the train and valid folds, the host tables, and
    one binning on the card a build; no layout holds host features."""
    tr, va, _ = make_train_valid_test(num_queries=(60, 20, 5), seed=3)
    cpu = TrainData.build(tr, nthr, device="cpu")
    before = binning.DEVICE_BUILDS
    card = TrainData.build(tr, nthr, device=cuda_device)
    vcpu = build_valid_traindata(cpu, va, nthr, "cpu")
    vcard = build_valid_traindata(card, va, nthr, cuda_device)
    assert binning.DEVICE_BUILDS == before + 2
    assert all(t.padded.features is None for t in (cpu, card, vcpu, vcard))
    for a, b in ((cpu, card), (vcpu, vcard)):
        np.testing.assert_array_equal(a.thresholds, b.thresholds)
        for f in dataclasses.fields(a.step):
            va_, vb = getattr(a.step, f.name), getattr(b.step, f.name)
            if isinstance(va_, torch.Tensor):
                assert vb.device.type == "cuda" and vb.dtype == va_.dtype, f.name
                np.testing.assert_array_equal(vb.cpu().numpy(), va_.numpy(), err_msg=f.name)
            else:
                assert va_ is None and vb is None, f.name


@pytest.mark.gpu
def test_every_learn_bins_its_valid_fold(cuda_device):
    """No cache across jobs: each ``learn`` on a prepared ``TrainData``
    bins its valid fold on the card once."""
    tr, va, _ = make_train_valid_test(num_queries=(40, 15, 5), seed=4)
    td = TrainData.build(tr, 255, device=cuda_device)
    for _ in range(2):
        before = binning.DEVICE_BUILDS
        LambdaMart(ntrees=2, nleaves=8, seed=1).learn(td, va, Ndcg(10), verbose=False,
                                                      device=cuda_device)
        assert binning.DEVICE_BUILDS == before + 1
