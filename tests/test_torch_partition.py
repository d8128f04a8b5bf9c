"""The port's row partition (ops/kernel_partition.py, K6) against the JAX
package's ``partition_rows_xla`` and a numpy model, byte for byte on the CPU;
on the card the CUDA kernel against its plain version.  The JAX package is
imported inside the tests that compare with it, so the ``gpu``-marked tests
also run where JAX is not installed (``-m gpu --noconftest``)."""

import numpy as np
import pytest
import torch

from quickrank_tpu_torch.ops import kernel_partition
from quickrank_tpu_torch.ops.kernel_partition import (
    MODE_COPY,
    MODE_DEAD,
    MODE_MOVE,
    TILE,
    partition_rows,
    partition_rows_plain,
)

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each


def _np_reference(data, bit, mode, dsta, dstb, sz, so, pos_col):
    """The contract spelt out tile by tile (tests/test_partition.py)."""
    N, W = data.shape
    out = np.zeros_like(data)
    for t in range(N // TILE):
        rows = data[t * TILE:(t + 1) * TILE]
        b = bit[t * TILE:(t + 1) * TILE]
        if mode[t] == MODE_COPY:
            out[dsta[t]:dsta[t] + TILE] = rows
        elif mode[t] == MODE_MOVE:
            z = rows[b == 0].copy()
            o = rows[b == 1].copy()
            z[:, pos_col] = sz[t]
            o[:, pos_col] = so[t]
            out[dsta[t]:dsta[t] + len(z)] = z
            out[dstb[t]:dstb[t] + len(o)] = o
    return out


def _random_case(rng, T=12, W=40, pos_col=37, from_split=False):
    """tests/test_partition.py::_random_case: tiles 0-1 one splitting run,
    2-3 surviving runs (copied, relocated), 4 dead, 5 the splitting run of a
    second node, 6.. dead slack the repack expands into.  With
    ``from_split`` the routing bits follow a per-tile (feature, bin) split
    and dead rows carry pos byte 0, as the kernel reads them; otherwise
    ``bit`` is random, with 2 (drop) on live rows."""
    N = T * TILE
    data = rng.integers(0, 256, (N, W)).astype(np.uint8)
    data[:, pos_col] = rng.integers(1, 5, N)
    fstar = rng.integers(0, pos_col, T).astype(np.int32)
    tstar = rng.integers(40, 220, T).astype(np.int32)
    if from_split:
        data[rng.random(N) < 0.2, pos_col] = 0
        tile = np.arange(N) // TILE
        left = data[np.arange(N), fstar[tile]] <= tstar[tile]
        bit = np.where(data[:, pos_col] > 0, np.where(left, 0, 1), 2).astype(np.int32)
    else:
        bit = rng.integers(0, 3, N).astype(np.int32)
    mode = np.array(
        [MODE_MOVE, MODE_MOVE, MODE_COPY, MODE_COPY, MODE_DEAD, MODE_MOVE]
        + [MODE_DEAD] * (T - 6), np.int32)
    zc = [(bit[t * TILE:(t + 1) * TILE] == 0).sum() for t in range(T)]
    oc = [(bit[t * TILE:(t + 1) * TILE] == 1).sum() for t in range(T)]

    def align(n):
        return -(-n // TILE) * TILE

    la_start = 0
    ra_start = align(zc[0] + zc[1]) + TILE
    c_start = ra_start + align(oc[0] + oc[1]) + TILE
    lb_start = c_start + 2 * TILE
    rb_start = lb_start + align(zc[5]) + TILE
    pad = [0] * (T - 6)
    dsta = np.array([la_start, la_start + zc[0], c_start, c_start + TILE, 0, lb_start]
                    + pad, np.int32)
    dstb = np.array([ra_start, ra_start + oc[0], 0, 0, 0, rb_start] + pad, np.int32)
    sz = np.array([7, 7, 0, 0, 0, 9] + pad, np.int32)
    so = np.array([8, 8, 0, 0, 0, 10] + pad, np.int32)
    assert rb_start + align(oc[5]) + TILE <= N
    return (data, bit, mode, dsta, dstb, sz, so, pos_col), (fstar, tstar)


def _port(case, device="cpu", **kw):
    *arrays, pos_col = case
    return partition_rows(*(torch.from_numpy(a).to(device) for a in arrays), pos_col, **kw)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("draw", [0, 1, 2])
def test_partition_matches_jax_and_model(seed, draw):
    import jax.numpy as jnp

    from quickrank_tpu.ops import pallas_partition as jax_partition

    rng = np.random.default_rng(seed)
    for _ in range(draw + 1):
        case, _ = _random_case(rng)
    *arrays, pc = case
    want = np.asarray(jax_partition.partition_rows_xla(*(jnp.asarray(a) for a in arrays), pc))
    got = _port(case).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _np_reference(*case))
    # dead rows are dropped: every row is all zero or carries a pos byte
    dead = (got == 0).all(axis=1)
    assert ((got[:, pc] > 0) | dead).all() and dead.any()


def test_constants_are_jax():
    from quickrank_tpu.ops import pallas_partition as jax_partition

    for name in ("TILE", "MODE_COPY", "MODE_MOVE", "MODE_DEAD"):
        assert getattr(kernel_partition, name) == getattr(jax_partition, name)


def test_split_derived_bits_and_out_buffer():
    """Bits derived from a per-tile split (what the kernel recomputes) go
    through the plain version like random ones, into a caller's buffer."""
    case, _ = _random_case(np.random.default_rng(3), W=48, pos_col=45, from_split=True)
    out = torch.full((case[0].shape[0], 48), 7, dtype=torch.uint8)
    got = _port(case, out=out)
    assert got is out
    np.testing.assert_array_equal(got.numpy(), _np_reference(*case))


@pytest.mark.parametrize("bad", ["rows", "dtype", "directive", "pos_col", "bit", "out"])
def test_partition_refuses(bad):
    case, _ = _random_case(np.random.default_rng(0))
    data, bit, mode, dsta, dstb, sz, so, pc = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in case)
    kw = {}
    if bad == "rows":
        data = data[:-1]
    elif bad == "dtype":
        data = data.int()
    elif bad == "directive":
        mode = mode.long()
    elif bad == "pos_col":
        pc = 40
    elif bad == "bit":
        bit = None
    else:
        kw["out"] = data
    with pytest.raises(ValueError):
        partition_rows(data, bit, mode, dsta, dstb, sz, so, pc, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed,W,pos_col", [(0, 48, 45), (1, 160, 157), (2, 16, 13)])
def test_partition_kernel_matches_plain_on_card(cuda_device, seed, W, pos_col):
    """K6 byte for byte against its plain version: COPY, MOVE and DEAD tiles,
    per-tile (fstar, tstar) and stamps, dead rows inside MOVE tiles."""
    case, (fstar, tstar) = _random_case(np.random.default_rng(seed), W=W, pos_col=pos_col,
                                        from_split=True)
    dev = [torch.from_numpy(a).to(cuda_device) for a in case[:-1]]
    before = kernel_partition.LAUNCHES["partition_rows"]
    got = partition_rows(*dev, pos_col, fstar=torch.from_numpy(fstar).to(cuda_device),
                         tstar=torch.from_numpy(tstar).to(cuda_device))
    torch.cuda.synchronize()
    assert kernel_partition.LAUNCHES["partition_rows"] == before + 1
    assert torch.equal(got, partition_rows_plain(*dev, pos_col))
    np.testing.assert_array_equal(got.cpu().numpy(), _np_reference(*case))


@pytest.mark.gpu
def test_partition_kernel_refuses_on_card(cuda_device):
    """A width the kernel does not take, or a missing split, raises; nothing
    falls to the plain version."""
    case, (fstar, tstar) = _random_case(np.random.default_rng(0), from_split=True)
    dev = [torch.from_numpy(a).to(cuda_device) for a in case[:-1]]
    split = dict(fstar=torch.from_numpy(fstar).to(cuda_device),
                 tstar=torch.from_numpy(tstar).to(cuda_device))
    before = kernel_partition.LAUNCHES["partition_rows"]
    with pytest.raises(ValueError, match="multiple of 16"):
        partition_rows(*dev, case[-1], **split)
    with pytest.raises(ValueError, match="fstar"):
        partition_rows(*dev, case[-1])
    assert kernel_partition.LAUNCHES["partition_rows"] == before
