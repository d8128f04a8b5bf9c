"""Per-query sums in an order fixed by construction: the CUDA kernel
``csrc/query_sum.cu`` and its plain version :func:`pairwise_sum`.

Not a port of a TPU kernel.  ``metrics/core.py::query_sum`` sums a query's
lambda pairs and metric terms through it on the card, so that a query's sum
is the same bits whatever batch it is computed in (its chunk, or its rank's
block under query sharding): a pairwise tree over the axis padded with zeros
to a power of two, whose order depends on the axis length only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from quickrank_tpu_torch.ops import _cuda

#: kernel launches by :func:`query_sum`; a run that must show its path went
#: through the kernel sets it to 0 first and reads it after
LAUNCHES = 0

#: longest axis the kernel sums (4,096 elements in shared memory a row,
#: folded 16 times in registers)
MAX_LENGTH = 1 << 16


def pairwise_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by halving: the axis padded with zeros to a power of
    two P, then ``x[:h] + x[h:]`` for h = P/2, ..., 1.  Elementwise adds
    only, so any dtype and device give the same bits for the same row."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def query_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum over ``dim`` in :func:`pairwise_sum`'s order.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return pairwise_sum(x, dim)
    if x.dtype != torch.float32:
        raise TypeError(f"query_sum: float32 values only, got {x.dtype}")
    dim = dim % x.dim()
    shape = x.shape
    length = int(shape[dim])
    if length > MAX_LENGTH:
        raise ValueError(f"query_sum: an axis of {length} elements is longer than the "
                         f"kernel's {MAX_LENGTH}")
    out_shape = shape[:dim] + shape[dim + 1:]
    if length == 0:
        return torch.zeros(out_shape, dtype=x.dtype, device=x.device)
    x = x.contiguous()
    inner = 1
    for s in shape[dim + 1:]:
        inner *= int(s)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    rows = out.numel()
    if rows == 0:
        return out
    rc = _cuda.library().query_sum(
        x.data_ptr(), rows, length, inner, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(rc, "query_sum")
    LAUNCHES += 1
    return out
