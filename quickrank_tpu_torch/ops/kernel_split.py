"""The growers' split scan, node statistics and XLA-order sums on the card:
the CUDA kernels of ``csrc/split_scan.cu``.

Not ports of TPU kernels.  ``trees/grow.py::_best_splits``, ``::_node_stats``
and ``::_deviance`` and ``ops/histogram.py::prefix_sum`` and ``::tree_sum``
repeat the order in which XLA on the CPU adds a histogram's bins, so that the
port grows the JAX package's trees bit for bit.  Their plain versions are
Python loops of small launches; on a CUDA tensor each entry here is one
launch that adds in the same order (``csrc/xla_order.cuh``), so the card's
trees are the loops' bit for bit.  The callers take these entries for a CUDA
tensor and their plain versions for a CPU tensor; the wrappers here take
CUDA float32 tensors only and raise on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from quickrank_tpu_torch.ops import _cuda

#: kernel launches by each wrapper; a run that must show its path went
#: through the kernels sets them to 0 first and reads them after
LAUNCHES = {"split_scan": 0, "node_stats": 0, "prefix_sum": 0, "tree_sum": 0}

#: each device's split-scan tickets (uint32 a node, as int32): zero, and a
#: launch leaves them zero (its last block of a node resets the node's);
#: launches on one device share them, so they run in stream order
_COUNTERS: dict = {}


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got one on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 values only, got {x.dtype}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def split_scan(hist: torch.Tensor, masks: torch.Tensor, minls: int):
    """``trees/grow.py::_best_splits`` of ``k`` nodes' histograms ``[k, F,
    B, C]`` (channel 0 the count, 1 the gradient sum) under feature masks
    ``[k, F]``: ``(can_split bool, f_star int64, t_star int64, gain
    float32)``, each ``[k]``, in one launch."""
    _check("split_scan", hist)
    if hist.dim() != 4 or hist.shape[3] < 2:
        raise ValueError(f"split_scan: a [k, F, B, C >= 2] histogram, got {tuple(hist.shape)}")
    k, F, B, C = hist.shape
    if masks.shape != (k, F) or masks.dtype != torch.bool or masks.device != hist.device:
        raise ValueError(f"split_scan: bool masks [{k}, {F}] on {hist.device}, got "
                         f"{masks.dtype} {tuple(masks.shape)} on {masks.device}")
    if k == 0 or F == 0 or B == 0:
        raise ValueError(f"split_scan: an empty histogram {tuple(hist.shape)}")
    lib = _cuda.library()
    blocks = lib.split_scan_blocks(F, B)
    dev = hist.device
    counters = _COUNTERS.get(dev.index)
    if counters is None or counters.numel() < k:
        counters = _COUNTERS[dev.index] = torch.zeros(max(k, 64), dtype=torch.int32, device=dev)
    partial = torch.empty(2 * k * blocks, dtype=torch.int64, device=dev)
    can = torch.empty(k, dtype=torch.bool, device=dev)
    f_star = torch.empty(k, dtype=torch.int64, device=dev)
    t_star = torch.empty(k, dtype=torch.int64, device=dev)
    gain = torch.empty(k, dtype=torch.float32, device=dev)
    hist, masks = hist.contiguous(), masks.contiguous()
    rc = lib.split_scan(
        hist.data_ptr(), k, F, B, C, masks.data_ptr(), float(minls), partial.data_ptr(),
        counters.data_ptr(), can.data_ptr(), f_star.data_ptr(), t_star.data_ptr(),
        gain.data_ptr(), _stream(hist))
    _cuda.check(rc, "split_scan")
    LAUNCHES["split_scan"] += 1
    return can, f_star, t_star, gain


def node_stats(hist: torch.Tensor, deviance: torch.Tensor, start: int, count: int) -> None:
    """``deviance[start:start + count]`` = ``_deviance(*_node_stats(hist[i]))``
    of the same node ids, in place, in one launch; ``hist`` is the grower's
    ``[nodes, F, B, C >= 3]`` table."""
    _check("node_stats", hist)
    _check("node_stats", deviance)
    if (hist.dim() != 4 or hist.shape[3] < 3 or not hist.is_contiguous()
            or not deviance.is_contiguous() or deviance.device != hist.device):
        raise ValueError(f"node_stats: a contiguous [nodes, F, B, C >= 3] histogram and a "
                         f"contiguous deviance on its device, got {tuple(hist.shape)}")
    nodes, F, B, C = hist.shape
    if not (0 <= start and start + count <= min(nodes, deviance.shape[0]) and count > 0):
        raise ValueError(f"node_stats: nodes [{start}, {start + count}) outside "
                         f"{nodes} histograms and {deviance.shape[0]} deviances")
    if F == 0 or B == 0:
        raise ValueError(f"node_stats: {F} features x {B} bins")
    rc = _cuda.library().node_stats(hist.data_ptr(), F, B, C, start, count,
                                    deviance.data_ptr(), _stream(hist))
    _cuda.check(rc, "node_stats")
    LAUNCHES["node_stats"] += 1


def _rows(x: torch.Tensor, name: str):
    """``x`` (the axis last) as rows: the view, its batch sizes and strides
    as C arrays (kept referenced until the launch), and the axis stride."""
    if x.shape[-1] == 0:
        raise ValueError(f"{name}: an empty axis")
    nd = x.dim() - 1
    sizes = (ctypes.c_int64 * max(nd, 1))(*x.shape[:-1])
    strides = (ctypes.c_int64 * max(nd, 1))(*x.stride()[:-1])
    return x, nd, sizes, strides, x.stride(-1)


def _launch(entry: str, x: torch.Tensor, out: torch.Tensor, name: str) -> None:
    x, nd, sizes, strides, axis_stride = _rows(x, name)
    rows = out.numel() // (x.shape[-1] if entry == "xla_prefix_sum" else 1)
    if rows == 0:
        return
    rc = getattr(_cuda.library(), entry)(
        x.data_ptr(), nd, ctypes.addressof(sizes), ctypes.addressof(strides), axis_stride,
        rows, x.shape[-1], out.data_ptr(), _stream(x))
    _cuda.check(rc, entry)
    LAUNCHES[name] += 1


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``ops/histogram.py::prefix_sum`` in one launch: the inclusive scan
    along ``dim`` in XLA's CPU order, at up to 9 dimensions and any strides
    (an axis of up to ~180,000 values: one warp's block totals in 48 KB;
    the launch fails past either)."""
    _check("prefix_sum", x)
    xm = x.movedim(dim, -1)
    out = torch.empty(xm.shape, dtype=torch.float32, device=x.device)
    _launch("xla_prefix_sum", xm, out, "prefix_sum")
    return out.movedim(-1, dim)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``ops/histogram.py::tree_sum`` in one launch: the sum over the last
    axis in XLA's CPU order, at up to 9 dimensions and any strides (an
    axis of up to 2^27 values; the launch fails past either)."""
    _check("tree_sum", x)
    if x.dim() == 0:
        raise ValueError("tree_sum: a 0-d tensor has no axis to sum")
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    _launch("xla_tree_sum", x, out, "tree_sum")
    return out
