"""Stable row partition of a node-clustered work buffer: the CUDA kernel of
``csrc/partition_rows.cu`` and its plain version.

``partition_rows`` replaces quickrank_tpu/ops/pallas_partition.py::
_partition_rows_tpu (K6, behind its wrapper ``partition_rows``);
``partition_rows_plain`` is the counterpart of ``partition_rows_xla``.

The clustered grower (``trees/grow_cluster.py``) keeps the binned doc matrix
so that every tree node's docs are a contiguous run of whole 1024-row tiles.
After a split the buffer is repacked by per-tile directives:

  * ``MODE_COPY``: tile ``t`` moves as it is to row ``dsta[t]``;
  * ``MODE_MOVE``: the tile's live rows (pos byte, column ``pos_col``, > 0)
    are split, in order: a row with ``data[r, fstar[t]] <= tstar[t]`` goes to
    ``dsta[t] + rank among such rows``, the others to ``dstb[t] + rank``, and
    the pos byte is stamped ``stamp_z[t]`` / ``stamp_o[t]``;
  * ``MODE_DEAD``: the tile emits nothing.

Rows nothing was written to are zero (pos byte 0 = dead).  The destinations
of different tiles are disjoint by the layout contract (per-tile stream
offsets are exclusive prefix sums of per-tile counts, child runs are
tile-aligned with one trailing guard tile), so tiles are independent.

The plain version consumes ``bit`` (0 left, 1 right, anything else drops the
row); the kernel recomputes the routing from ``(fstar, tstar)``, so on live
rows of MOVE tiles ``bit`` must agree with the split.
"""

from __future__ import annotations

from typing import Optional

import torch

from quickrank_tpu_torch.ops import _cuda

TILE = 1024
MODE_COPY = 0
MODE_MOVE = 1
MODE_DEAD = 2

#: kernel launches by the wrapper; a run that must show its path went through
#: the kernel sets it to 0 first and reads it after
LAUNCHES = {"partition_rows": 0}

#: bytes one thread moves at a time: the kernel takes row widths that are a
#: multiple of it
VECTOR_BYTES = 16


def _check(data, directives: dict, pos_col: int):
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"partition_rows: data must be uint8 [N, W], got "
                         f"{data.dtype} {tuple(data.shape)}")
    N, W = data.shape
    if N % TILE:
        raise ValueError(f"partition_rows: {N} rows are not a multiple of {TILE}")
    if not data.is_contiguous():
        raise ValueError("partition_rows: data must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"partition_rows: unsupported device {data.device}")
    if not 0 <= pos_col < W:
        raise ValueError(f"partition_rows: pos_col {pos_col} outside [0, {W})")
    T = N // TILE
    for name, t in directives.items():
        if t.dtype != torch.int32 or tuple(t.shape) != (T,) or not t.is_contiguous():
            raise ValueError(f"partition_rows: {name} must be contiguous int32 [{T}], "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != data.device:
            raise ValueError(f"partition_rows: {name} on {t.device}, data on {data.device}")


def partition_rows(data: torch.Tensor, bit: Optional[torch.Tensor],
                   mode: torch.Tensor, dsta: torch.Tensor, dstb: torch.Tensor,
                   stamp_z: torch.Tensor, stamp_o: torch.Tensor, pos_col: int,
                   fstar: Optional[torch.Tensor] = None,
                   tstar: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: repack ``data`` uint8 ``[N, W]`` (``N % 1024 == 0``) by the
    per-tile directives ``mode, dsta, dstb, stamp_z, stamp_o`` (and ``fstar,
    tstar`` on the card), each int32 ``[N // 1024]``; see the module
    docstring.  ``bit`` int32 ``[N]`` is read by the plain version only and
    may be None on the card.  ``out`` (another buffer of ``data``'s shape,
    overwritten) saves the allocation.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises (its ``W`` must be a multiple of
    16)."""
    directives = dict(mode=mode, dsta=dsta, dstb=dstb, stamp_z=stamp_z, stamp_o=stamp_o)
    if data.device.type == "cuda":
        if fstar is None or tstar is None:
            raise ValueError("partition_rows: the kernel needs fstar and tstar")
        directives.update(fstar=fstar, tstar=tstar)
    _check(data, directives, pos_col)
    N, W = data.shape
    if out is not None and (out.shape != data.shape or out.dtype != data.dtype
                            or out.device != data.device or not out.is_contiguous()
                            or out.data_ptr() == data.data_ptr()):
        raise ValueError("partition_rows: out must be another contiguous buffer of "
                         "data's shape, type and device")
    if data.device.type == "cpu":
        if bit is None:
            raise ValueError("partition_rows: the plain version needs bit")
        res = partition_rows_plain(data, bit, mode, dsta, dstb, stamp_z, stamp_o, pos_col)
        return res if out is None else out.copy_(res)
    if W % VECTOR_BYTES:
        raise ValueError(f"partition_rows: the kernel moves rows as {VECTOR_BYTES}-byte "
                         f"vectors, so W must be a multiple of {VECTOR_BYTES}, got {W}")
    if out is None:
        out = torch.empty_like(data)
    rc = _cuda.library().partition_rows(
        data.data_ptr(), N, W, mode.data_ptr(), dsta.data_ptr(), dstb.data_ptr(),
        stamp_z.data_ptr(), stamp_o.data_ptr(), fstar.data_ptr(), tstar.data_ptr(),
        pos_col, out.data_ptr(), torch.cuda.current_stream(data.device).cuda_stream,
    )
    _cuda.check(rc, "partition_rows")
    LAUNCHES["partition_rows"] += 1
    return out


def row_destinations(data, bit, mode, dsta, dstb, stamp_z, stamp_o, pos_col: int):
    """(dest int64 [N], pos byte uint8 [N]) of every input row under the
    directives; ``dest == N`` drops the row.  Ranks within a tile are
    exclusive prefix counts, so the order of rows is kept."""
    N = data.shape[0]
    T = N // TILE
    dev = data.device
    rows = torch.arange(N, device=dev)
    tile = rows // TILE
    b = bit.reshape(-1)
    md = mode[tile]
    is_copy = md == MODE_COPY
    is_move = md == MODE_MOVE
    live = data[:, pos_col] > 0
    zm = is_move & live & (b == 0)
    om = is_move & live & (b == 1)

    def rank_in_tile(mask):
        m2 = mask.view(T, TILE).long()
        return (m2.cumsum(dim=1) - m2).view(-1)

    dest = torch.where(is_copy, dsta[tile].long() + rows % TILE, N)
    dest = torch.where(zm, dsta[tile].long() + rank_in_tile(zm), dest)
    dest = torch.where(om, dstb[tile].long() + rank_in_tile(om), dest)
    stamped = torch.where(zm, stamp_z[tile], torch.where(om, stamp_o[tile], 0))
    pos_vals = torch.where(is_copy, data[:, pos_col], stamped.to(torch.uint8))
    dest = torch.where((dest >= 0) & (dest < N), dest, N)
    return dest, pos_vals


def partition_rows_plain(data, bit, mode, dsta, dstb, stamp_z, stamp_o,
                         pos_col: int) -> torch.Tensor:
    """K6's plain version (ranks by ``cumsum``, one row scatter; any device,
    any ``W``)."""
    N = data.shape[0]
    dest, pos_vals = row_destinations(data, bit, mode, dsta, dstb, stamp_z, stamp_o,
                                      pos_col)
    keep = (dest < N).nonzero()[:, 0]
    vals = data[keep]
    vals[:, pos_col] = pos_vals[keep]
    return torch.zeros_like(data).index_copy_(0, dest[keep], vals)
