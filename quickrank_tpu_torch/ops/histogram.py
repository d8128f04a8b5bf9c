"""Split-statistics histograms over binned features (counterpart of
quickrank_tpu/ops/histogram.py, after rtnode_histogram.cc:41-217).

Histograms are dense ``[F, B, C]`` tensors built by one pass over the docs;
cumulative sums are taken at gain-scan time.  Channels: 0 = doc count,
1 = sum of gradients, 2 = sum of squared gradients (the best-first
deviance) or, in level-wise growth, the Newton weight.

``masked_histogram_t`` and ``node_histograms`` go through
``ops/kernel_histogram.py``, whose wrappers run the CUDA kernels on a CUDA
tensor and the scatter-add functions below on a CPU tensor.  The scatter
functions add docs in dataset order, bin by bin, as XLA's CPU scatter
does, so on the CPU the port's histograms are bitwise the JAX package's.

``prefix_sum`` and ``tree_sum`` reproduce the order in which XLA on the CPU
sums a histogram's bin axis, so that the gain scan picks the same split
from the same histogram, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NCHANNELS = 3  # count, sum_grad, sum_grad_sq
#: (doc, feature) elements per scatter chunk, which bounds the index and
#: value temporaries of the plain versions
_CHUNK_ELEMS = 1 << 22
#: block length of XLA's rewrite of scans and reductions on the CPU
_XLA_BLOCK_SCAN = 16
_XLA_BLOCK_SUM = 32


def doc_channels(grad: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-doc channel values ``[N, 3]`` = (1, g, g^2), zeroed where masked."""
    m = mask.to(grad.dtype)
    return torch.stack([m, grad * m, grad * grad * m], dim=-1)


def masked_histogram_t(binned, values_t, mask, num_bins: int, f_used: int = 0):
    """Histogram ``[F, B, C]`` of the docs in ``mask`` from channel-major
    values ``[C, N]`` that are already zero outside the doc mask; the
    subset enters the kernel as a node id row (0 in the subset, 1 outside).
    The best-first grower calls it once per split."""
    from quickrank_tpu_torch.ops import kernel_histogram

    pos = torch.where(mask, 0, 1).to(torch.int32)
    return kernel_histogram.node_histogram(
        binned, values_t, pos, num_bins, 0, 1, f_used=f_used
    )


def node_histograms(binned, values, node_of_doc, doc_mask, num_nodes: int,
                    num_bins: int, values_premasked: bool = False):
    """Histograms of every node at once: ``[num_nodes, F, B, C]``.  Docs
    with a node id outside [0, num_nodes), or outside ``doc_mask``,
    contribute nothing."""
    if not values_premasked:
        values = torch.where(doc_mask[:, None], values, 0.0)
    return node_histograms_t(binned, values.T.contiguous(), node_of_doc,
                             num_nodes, num_bins)


def node_histograms_t(binned, values_t, node_of_doc, num_nodes: int,
                      num_bins: int):
    """:func:`node_histograms` from channel-major values ``[C, N]`` that are
    already zero outside the doc mask (a grower builds them once a tree).
    Up to ``32 // C`` nodes share one kernel pass (the JAX package's
    packing, histogram.py:151-161)."""
    from quickrank_tpu_torch.ops import kernel_histogram

    C = values_t.shape[0]
    pos = node_of_doc.to(torch.int32).contiguous()
    per_pass = max(1, 32 // C)
    outs = []
    for n0 in range(0, num_nodes, per_pass):
        k = min(per_pass, num_nodes - n0)
        h = kernel_histogram.node_histogram(binned, values_t, pos, num_bins, n0, k)
        outs.append(h.reshape(h.shape[0], num_bins, k, C).permute(2, 0, 1, 3))
    return torch.cat(outs)


def node_histograms_scatter(binned, values, node_of_doc, doc_mask,
                            num_nodes: int, num_bins: int):
    """Scatter-add by (node, feature, bin): ``[num_nodes, F, B, C]`` in the
    values' dtype.  A bin id outside [0, num_bins) is dropped per (doc,
    feature) element, as the kernels drop it."""
    Fw = binned.shape[1]
    C = values.shape[-1]
    dev = binned.device
    ok = doc_mask & (node_of_doc >= 0) & (node_of_doc < num_nodes)
    # only docs of the nodes count; skipping the rest keeps dataset order
    rows = ok.nonzero()[:, 0]
    fidx = torch.arange(Fw, device=dev)[None, :]
    out = torch.zeros(((num_nodes + 1) * Fw * num_bins, C),
                      dtype=values.dtype, device=dev)
    step = max(1, _CHUNK_ELEMS // max(Fw, 1))
    for r0 in range(0, rows.shape[0], step):
        r = rows[r0:r0 + step]
        b = binned[r].long()
        bin_ok = (b >= 0) & (b < num_bins)
        node_elem = torch.where(bin_ok, node_of_doc[r].long()[:, None], num_nodes)
        flat = (node_elem * Fw + fidx) * num_bins + b.clamp(0, num_bins - 1)
        vals = values[r][:, None, :].expand(r.shape[0], Fw, C).reshape(-1, C)
        out.index_add_(0, flat.reshape(-1), vals)
    return out.reshape(num_nodes + 1, Fw, num_bins, C)[:num_nodes]


def masked_histogram_scatter(binned, values, mask, num_bins: int):
    """Histogram ``[F, B, C]`` of the docs in ``mask`` by scatter-add."""
    zeros = torch.zeros(binned.shape[0], dtype=torch.int32, device=binned.device)
    return node_histograms_scatter(binned, values, zeros, mask, 1, num_bins)[0]


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive scan over the last axis, one rounding per add in
    order (``torch.cumsum`` on the CPU accumulates float32 in double)."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, associated as XLA on the CPU
    associates ``cumsum``: sequential within blocks of 16, block totals
    scanned the same way (recursively) and added to the next blocks."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _XLA_BLOCK_SCAN:
        out = _sequential_scan(x)
    else:
        m = -(-n // _XLA_BLOCK_SCAN)
        blocks = F.pad(x, (0, m * _XLA_BLOCK_SCAN - n)).reshape(
            x.shape[:-1] + (m, _XLA_BLOCK_SCAN))
        within = _sequential_scan(blocks)
        totals = prefix_sum(within[..., -1], -1)
        carry = F.pad(totals[..., :-1], (1, 0))
        out = (within + carry[..., None]).reshape(x.shape[:-1] + (-1,))[..., :n]
    return out.movedim(-1, dim)


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis from an accumulator of 0, one rounding
    per add in order, as XLA's CPU loop over a reduce or a window adds."""
    acc = x[..., 0] + 0.0
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, associated as XLA on the CPU reduces it, at
    every length.  XLA's tree-reduction rewrite turns a reduce of n >= 32
    elements into a reduce-window of width and stride 32 over the axis
    padded with zeros to ``32 * m`` (``m = ceil(n / 32)``), ``p // 2`` zeros
    in front and the other ``p - p // 2`` behind (``p = 32 * m - n``), and a
    reduce of the m window sums, rewritten the same way while m >= 32.  Each
    window and the last reduce add in order from 0.  So the windows are
    centred: at 101 bins they hold 19, 32, 32 and 18 elements.  This is the
    order inside the JAX package's jitted ``_node_stats`` and grower, at
    every length from 1 to 256 (``tests/test_torch_histogram.py``); the
    padded zeros change no bit."""
    while x.shape[-1] >= _XLA_BLOCK_SUM:
        n = x.shape[-1]
        m = -(-n // _XLA_BLOCK_SUM)
        p = m * _XLA_BLOCK_SUM - n
        if p:
            x = F.pad(x, (p // 2, p - p // 2))
        x = _sequential_sum(x.reshape(x.shape[:-1] + (m, _XLA_BLOCK_SUM)))
    return _sequential_sum(x)
