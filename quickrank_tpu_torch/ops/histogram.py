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

On the card every histogram is the kernels' fixed-point sum under a scale
(:func:`histogram_scale`: the channels' max bits and the count of real docs,
:func:`scale_doc_count`), which a grower takes once a tree and passes to
each histogram of the tree.

Under a query-sharded group (``parallel/mesh.py::DataGroup``) the same
functions return the histogram of every rank's docs: this module is the
growers' one collective site for histograms (JAX trees/grow.py:184-188,
grow_bestk.py:92-93, grow_level.py:125-126, oblivious.py:126-127) and, through
:func:`group_histogram`, for the leaf sums.  On the card the ranks agree on
the scale (an all-reduce max of the channels' max bits, and the real docs of
all ranks as its count), add the kernels' int64 accumulators and convert the
sum once, so the histogram is bit for bit that of one rank over all the
docs; on the CPU the plain float histograms are summed, as JAX's ``psum``
sums them.
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


def scale_doc_count(rows: int, group=None, num_docs: int = 0) -> int:
    """The doc count of the card's fixed-point scale over ``rows`` rows: the
    real docs of all ranks under ``group`` (``DataGroup.num_docs``), else
    the caller's real docs ``num_docs`` (0: every row is a doc).  Pad rows
    carry zeros, so the real count keeps the overflow bound, and one device
    and any group round on the same grid whatever the padding."""
    if group is not None:
        return group.num_docs
    return int(num_docs) or int(rows)


def histogram_scale(values_t, group=None, num_docs: int = 0):
    """The fixed-point scale of the card's histograms of channel-major
    values ``[C, N]``: (max bits int32 ``[C]``, doc count).  The bits are
    the values' own max, and under ``group`` the ranks agree on them with
    one all-reduce max; the count is :func:`scale_doc_count`'s.  None on the
    CPU, whose plain histograms are float."""
    from quickrank_tpu_torch.ops import kernel_histogram as kh

    if values_t.device.type == "cpu":
        return None
    bits = kh.channel_max_bits(values_t)
    if group is not None:
        bits = group.all_reduce_max(bits)
    return bits, scale_doc_count(values_t.shape[1], group, num_docs)


def masked_histogram_t(binned, values_t, mask, num_bins: int, f_used: int = 0,
                       group=None, scale=None):
    """Histogram ``[F, B, C]`` of the docs in ``mask`` from channel-major
    values ``[C, N]`` that are already zero outside the doc mask; the
    subset enters the kernel as a node id row (0 in the subset, 1 outside).
    The best-first grower calls it once per split, with the tree's
    ``scale`` (:func:`histogram_scale` of ``values_t``; None takes it
    here)."""
    pos = torch.where(mask, 0, 1).to(torch.int32)
    return _node_passes(binned, values_t, pos, num_bins, [(0, 1)], group,
                        f_used=f_used, scale=scale)[0]


def _node_passes(binned, values_t, pos, num_bins: int, passes, group, f_used: int = 0,
                 scale=None):
    """K4 over each ``(n0, k)`` of ``passes``: float32 ``[F, B, k*C]`` each,
    reduced over ``group``'s ranks when one is given (on the CPU one float
    sum for all passes; on the card one sum of the int64 accumulators)."""
    from quickrank_tpu_torch.ops import kernel_histogram as kh

    if binned.device.type == "cpu":
        outs = [kh.node_histogram(binned, values_t, pos, num_bins, n0, k, f_used=f_used)
                for n0, k in passes]
        if group is not None:
            _reduce_float(outs, group)
        return outs
    bits, n = scale if scale is not None else histogram_scale(values_t, group)
    accs = [kh.node_histogram_int(binned, values_t, pos, num_bins, n0, k, bits, n,
                                  f_used=f_used) for n0, k in passes]
    if group is not None:
        accs = _split_like(group.all_reduce_sum(torch.cat([a.reshape(-1) for a in accs])),
                           accs)
    return [kh.to_float(a, bits, n) for a in accs]


def _split_like(flat, parts):
    return [x.reshape(p.shape) for x, p in
            zip(torch.split(flat, [p.numel() for p in parts]), parts)]


def _reduce_float(outs, group) -> None:
    """Sum float32 histograms over the ranks in one collective, in place."""
    flat = group.all_reduce_sum(torch.cat([o.reshape(-1) for o in outs]))
    for o, x in zip(outs, _split_like(flat, outs)):
        o.copy_(x)


def group_histogram(binned, values, num_bins: int, group=None, num_docs: int = 0):
    """K5 (``[F, B, C]`` of doc-major ``values [N, C]``), reduced over
    ``group``'s ranks when one is given, as :func:`masked_histogram_t`
    reduces K4; ``num_docs`` counts the real docs among the rows (0: all)."""
    from quickrank_tpu_torch.ops import kernel_histogram as kh

    if binned.device.type == "cpu":
        h = kh.histogram(binned, values, num_bins)
        return h if group is None else group.all_reduce_sum(h)
    bits, n = histogram_scale(values.T, group, num_docs)
    acc = kh.histogram_int(binned, values, num_bins, bits, n)
    if group is not None:
        acc = group.all_reduce_sum(acc)
    return kh.to_float(acc, bits, n)


def node_histograms(binned, values, node_of_doc, doc_mask, num_nodes: int,
                    num_bins: int, values_premasked: bool = False, group=None):
    """Histograms of every node at once: ``[num_nodes, F, B, C]``.  Docs
    with a node id outside [0, num_nodes), or outside ``doc_mask``,
    contribute nothing."""
    if not values_premasked:
        values = torch.where(doc_mask[:, None], values, 0.0)
    return node_histograms_t(binned, values.T.contiguous(), node_of_doc,
                             num_nodes, num_bins, group=group)


def node_histograms_t(binned, values_t, node_of_doc, num_nodes: int,
                      num_bins: int, group=None, scale=None):
    """:func:`node_histograms` from channel-major values ``[C, N]`` that are
    already zero outside the doc mask (a grower builds them, and their
    ``scale``, once a tree).  Up to ``32 // C`` nodes share one kernel pass
    (the JAX package's packing, histogram.py:151-161)."""
    C = values_t.shape[0]
    pos = node_of_doc.to(torch.int32).contiguous()
    per_pass = max(1, 32 // C)
    passes = [(n0, min(per_pass, num_nodes - n0)) for n0 in range(0, num_nodes, per_pass)]
    outs = _node_passes(binned, values_t, pos, num_bins, passes, group, scale=scale)
    return torch.cat([h.reshape(h.shape[0], num_bins, k, C).permute(2, 0, 1, 3)
                      for h, (_, k) in zip(outs, passes)])


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
