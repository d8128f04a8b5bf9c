"""Split-statistics histograms: the CUDA kernels of ``csrc/histogram.cu`` and
their plain versions (the scatter-adds of ``ops/histogram.py``).

``node_histogram`` replaces quickrank_tpu/ops/pallas_histogram.py::
node_histogram_pallas (K4) and ``histogram`` replaces ::histogram_pallas
(K5).  The kernels sum in 64-bit fixed point, so two launches on the same
inputs give the same bits; they agree with the plain versions within
float32 summation tolerance plus the fixed-point bound of
:func:`rounding_error` (the count channel exactly), and with
:func:`node_histogram_fixed`, the same fixed-point arithmetic in plain
PyTorch, bit for bit.
"""

from __future__ import annotations

import torch

from quickrank_tpu_torch.ops import _cuda
from quickrank_tpu_torch.ops.histogram import (
    masked_histogram_scatter,
    node_histograms_scatter,
)

#: kernel launches by each wrapper; a run that must show its path went
#: through the kernels sets both to 0 first and reads them after
LAUNCHES = {"node_histogram": 0, "histogram": 0}

#: most channels a kernel launch takes
MAX_CHANNELS = 8
#: shared memory one block may use; it bounds C * B, the cells of one
#: feature and node (:func:`min_shared_bytes`)
SMEM_MAX = _cuda.SMEM_MAX


def min_shared_bytes(channels: int, num_bins: int) -> int:
    """Shared memory the kernel's smallest block takes (``csrc/histogram.cu``
    ``smem_bytes``: one feature, a list of 32 docs): the cells as two 32-bit
    halves, ``C * B`` words each rounded up to 1 mod 32, the list of doc
    indices and fixed-point values, the scales and the warps' counts."""
    stride = (num_bins * channels + 30) // 32 * 32 + 1
    return 32 * (8 * channels + 4) + 8 * MAX_CHANNELS + 8 * stride + 256


def _check(name, binned, values, num_bins, channels):
    if binned.dim() != 2 or binned.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"{name}: binned must be uint8 or int32 [N, F], got "
                         f"{binned.dtype} {tuple(binned.shape)}")
    if values.dtype != torch.float32 or values.dim() != 2:
        raise ValueError(f"{name}: values must be float32 2-D, got "
                         f"{values.dtype} {tuple(values.shape)}")
    for t, what in ((binned, "binned"), (values, "values")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.device != binned.device:
            raise ValueError(f"{name}: {what} on {t.device}, binned on {binned.device}")
    if binned.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {binned.device}")
    if not 1 <= channels <= MAX_CHANNELS:
        raise ValueError(f"{name}: {channels} channels, the kernel takes 1..{MAX_CHANNELS}")
    if num_bins < 1:
        raise ValueError(f"{name}: num_bins must be >= 1, got {num_bins}")


def _launch(name, binned, values, stride_c, stride_n, pos, n0, k, num_bins,
            features, channels):
    if min_shared_bytes(channels, num_bins) > SMEM_MAX:
        raise ValueError(
            f"{name}: C*B = {channels}*{num_bins} needs "
            f"{min_shared_bytes(channels, num_bins)} bytes of shared memory a "
            f"feature and node, more than {SMEM_MAX}"
        )
    dev = binned.device
    N, W = binned.shape
    out = torch.empty((features, num_bins, k * channels), dtype=torch.float32, device=dev)
    # the 64-bit accumulator, then four words for the channels' max bits
    scratch = torch.empty(out.numel() + 4, dtype=torch.int64, device=dev)
    rc = _cuda.library().histogram_launch(
        binned.data_ptr(), binned.element_size(), N, W, features,
        values.data_ptr(), channels, stride_c, stride_n,
        pos.data_ptr() if pos is not None else None, n0, k, num_bins,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(rc, name)
    LAUNCHES[name] += 1
    return out


def node_histogram(binned: torch.Tensor, values_t: torch.Tensor,
                   pos: torch.Tensor, num_bins: int, n0: int, k: int,
                   f_used: int = 0) -> torch.Tensor:
    """K4: ``hist[f, b, i*C + c] = sum over docs n with pos[n] == n0 + i of
    values_t[c, n] * [binned[n, f] == b]``, float32 ``[F, B, k*C]``.

    ``binned`` uint8 or int32 ``[N, W]``; ``values_t`` float32 ``[C, N]``,
    already zero outside the doc mask; ``pos`` int32 ``[N]``; ``f_used``
    (0 = all W columns) limits the features.  Bin ids >= ``num_bins`` are
    dropped.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises."""
    _check("node_histogram", binned, values_t, num_bins, values_t.shape[0])
    N, W = binned.shape
    C = values_t.shape[0]
    if values_t.shape[1] != N or pos.shape != (N,) or pos.dtype != torch.int32:
        raise ValueError(
            f"node_histogram: values_t must be [C, {N}] and pos int32 [{N}], got "
            f"{tuple(values_t.shape)} and {pos.dtype} {tuple(pos.shape)}"
        )
    if not pos.is_contiguous() or pos.device != binned.device:
        raise ValueError("node_histogram: pos must be contiguous, on binned's device")
    if k < 1 or not 0 <= f_used <= W:
        raise ValueError(f"node_histogram: need k >= 1 and 0 <= f_used <= {W}")
    F = f_used or W
    if binned.device.type == "cpu":
        return node_histogram_plain(binned, values_t, pos, num_bins, n0, k, f_used)
    return _launch("node_histogram", binned, values_t, N, 1, pos, n0, k,
                   num_bins, F, C)


def histogram(binned: torch.Tensor, values: torch.Tensor,
              num_bins: int) -> torch.Tensor:
    """K5: ``hist[f, b, c] = sum_n values[n, c] * [binned[n, f] == b]``,
    float32 ``[F, B, C]``, from doc-major float32 ``values [N, C]``.  Bin
    ids >= ``num_bins`` are dropped.  A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel or raises."""
    _check("histogram", binned, values, num_bins, values.shape[-1])
    N, W = binned.shape
    if values.shape[0] != N:
        raise ValueError(f"histogram: values must be [{N}, C], got {tuple(values.shape)}")
    C = values.shape[1]
    if binned.device.type == "cpu":
        return histogram_plain(binned, values, num_bins)
    return _launch("histogram", binned, values, 1, C, None, 0, 1, num_bins, W, C)


def rounding_error(values_cm: torch.Tensor) -> torch.Tensor:
    """Largest error the kernels' fixed-point rounding puts on one value,
    per channel of channel-major ``values_cm [C, N]``: 2^(e + nb - 63), where
    max |v_c| < 2^e and N < 2^nb (``csrc/histogram.cu``).  A bin of t values
    is within t times this of its exact sum before the final float32
    rounding; the error is absolute, so a bin whose few values are tiny
    next to the channel's largest one loses relative precision."""
    m = values_cm.detach().abs().amax(dim=1).cpu()
    shift = _channel_shifts(values_cm).double().cpu()
    return torch.where(m > 0, torch.exp2(-1 - shift), 0.0)


def _channel_shifts(values_cm: torch.Tensor) -> torch.Tensor:
    """The kernels' fixed-point exponents, int64 ``[C]``: ``62 - e - nb``
    where max |v_c| < 2^e and N < 2^nb; 0 for a channel that is all zero or
    holds a non-finite value (``csrc/histogram.cu::channel_shift``)."""
    m = values_cm.detach().abs().amax(dim=1)
    e = torch.frexp(m).exponent.long()
    nb = int(values_cm.shape[1]).bit_length()
    return torch.where((m > 0) & torch.isfinite(m), 62 - e - nb, 0)


def node_histogram_fixed(binned, values_t, pos, num_bins: int, n0: int, k: int,
                         f_used: int = 0) -> torch.Tensor:
    """The exact reference of K4 and K5 in plain PyTorch, on any device: the
    kernels' own arithmetic (each value scaled by its channel's power of two
    and rounded once, in float64, to int64; integer sums; the sum converted
    through float64 to float32), so the kernels must equal it bit for bit.
    Integer sums are order-free: any order of the docs gives the same bits.
    ``pos = None`` puts every doc in node 0 (K5, with ``values_t`` the
    transpose of its doc-major values).  A channel with a non-finite value
    is NaN."""
    N, W = binned.shape
    F = f_used or W
    C = values_t.shape[0]
    dev = binned.device
    if N == 0:
        return torch.zeros((F, num_bins, k * C), dtype=torch.float32, device=dev)
    m = values_t.detach().abs().amax(dim=1)
    shift = _channel_shifts(values_t)
    scale = torch.ldexp(torch.ones(C, dtype=torch.float64, device=dev), shift)
    finite = torch.nan_to_num(values_t.double(), nan=0.0, posinf=0.0, neginf=0.0)
    q = torch.round(finite * scale[:, None]).to(torch.int64)  # [C, N]
    node = (pos.long() - n0) if pos is not None else torch.zeros(N, dtype=torch.long, device=dev)
    acc = torch.zeros((F * num_bins * k + 1, C), dtype=torch.int64, device=dev)
    cols = torch.arange(F, device=dev)[None, :]
    step = max(1, (1 << 22) // max(F, 1))
    for r0 in range(0, N, step):
        b = binned[r0:r0 + step, :F].long()
        nd = node[r0:r0 + step, None]
        ok = (b >= 0) & (b < num_bins) & (nd >= 0) & (nd < k)
        flat = torch.where(ok, (cols * num_bins + b) * k + nd, F * num_bins * k)
        vals = q[:, r0:r0 + step].T[:, None, :].expand(-1, F, -1).reshape(-1, C)
        acc.index_add_(0, flat.reshape(-1), vals)
    out = torch.ldexp(acc[:-1].double(), -shift.to(torch.int32)).float()
    out = torch.where(torch.isfinite(m)[None, :], out, float("nan"))
    return out.reshape(F, num_bins, k * C)


def node_histogram_plain(binned, values_t, pos, num_bins: int, n0: int, k: int,
                         f_used: int = 0) -> torch.Tensor:
    """K4's plain version (a scatter-add, on any device)."""
    F = f_used or binned.shape[1]
    C = values_t.shape[0]
    ones = torch.ones(binned.shape[0], dtype=torch.bool, device=binned.device)
    h = node_histograms_scatter(binned[:, :F], values_t.T, pos - n0, ones, k, num_bins)
    return h.permute(1, 2, 0, 3).reshape(F, num_bins, k * C)


def histogram_plain(binned, values, num_bins: int) -> torch.Tensor:
    """K5's plain version (a scatter-add, on any device)."""
    ones = torch.ones(binned.shape[0], dtype=torch.bool, device=binned.device)
    return masked_histogram_scatter(binned, values, ones, num_bins)
