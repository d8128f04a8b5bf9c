"""QuickScorer bitvector tables and the plain QuickScorer scorer
(counterpart of quickrank_tpu/trees/qs.py: ``ensemble_to_qs`` in value and
bin space, ``score_qs`` and ``partial_scores_qs``).

QuickScorer (Lucchese et al., SIGIR 2015) evaluates a tree without walking
it.  Every internal node carries the set of leaves that become unreachable
when its test is false: the leaves of its left subtree.  A node is false for
a doc when ``x[fid] > thr``.  The exit leaf is the leftmost leaf that no
false node excludes: false ancestors send the doc right, non-ancestors do
not hold the exit leaf, and every leaf left of it is excluded by its lowest
common ancestor with the exit leaf.

The port keeps each node's leaf set as packed 64-bit words, ``[T, I, W]``
with ``W = ceil(L / 64)``, the form the CUDA kernel ANDs; the JAX package
keeps dense bf16 ``[T, I, L]`` masks for its matrix unit.  There is no
padding of the tree axis: the table has exactly the ensemble's capacity
slots, so the Kahan chain takes one step per slot, as
``ops/scoring.py::score_ensemble`` does.

The CUDA kernel reads the tables in one packed tensor (:func:`pack_tables`):
a 16-byte record a node and word, then the tree's leaf values and weight.
It is built once per table (``QSEnsemble.packed``); the plain scorer reads
the unpacked tensors.  A packed row depends on its tree alone, so a table can
also grow a tree at a time (:func:`tree_to_qs_row`, DART's device-resident
table) and be scored from any selection of its rows
(:func:`table_from_packed`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.ops.binning import bin_columns
from quickrank_tpu_torch.ops.scoring import kahan_add

FLT_MAX = float(np.float32(3.4028235e38))

#: elements of the largest [N, trees, leaves] intermediate of the plain scorer
_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass
class QSEnsemble:
    """fid/thr: [T, I] internal-node tests in post-order (dead slots have
    ``thr = FLT_MAX`` and no leaf bits, so they exclude nothing); excl:
    int64 [T, I, W] bit-packed left-subtree leaf sets, leaf ``l`` is bit
    ``l % 64`` of word ``l // 64``; leafval: [T, L] in left-to-right leaf
    order (pad leaves sit rightmost and are never selected); weight: [T],
    zero on dead slots.  The tensors are not written after the first
    :meth:`packed` call, which caches their packed form."""

    fid: torch.Tensor  # int32
    thr: torch.Tensor  # float32
    excl: torch.Tensor  # int64 bit words
    leafval: torch.Tensor  # float32
    weight: torch.Tensor  # float32
    num_trees: int
    #: smallest feature count the tables can be scored against
    min_features: int
    _packed: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_leaves(self) -> int:
        return int(self.leafval.shape[1])

    def packed(self) -> torch.Tensor:
        """The tables as the CUDA kernel reads them (:func:`pack_tables`),
        on the tables' device; built at the first call and kept."""
        if self._packed is None:
            self._packed = pack_tables(self)
        return self._packed

    def to(self, device) -> "QSEnsemble":
        return dataclasses.replace(
            self, fid=self.fid.to(device), thr=self.thr.to(device),
            excl=self.excl.to(device), leafval=self.leafval.to(device),
            weight=self.weight.to(device), _packed=self.packed().to(device),
        )


def qs_shape(max_nodes: int):
    """(I, L, W) of the tables of trees of ``max_nodes`` nodes: internal
    nodes, leaves and 64-bit leaf-set words a tree."""
    I = max(1, max_nodes // 2)  # 2k-1 nodes -> k-1 internal
    L = max(1, max_nodes - I)  # k leaves
    return I, L, -(-L // 64)


def _tree_tables(feat, thrv, left, right, isleaf, lv, fid, thr, excl, leafval):
    """Fill one tree's rows of the tables (``fid`` [I], ``thr`` [I], ``excl``
    bool [I, W * 64], ``leafval`` [L]) from its node arrays.

    Post-order walk, iterative so that a chain-shaped imported tree does not
    ride Python's recursion limit: leaves are numbered left to right,
    internal nodes take compact slots in visit order with their left leaf
    span."""
    nleaf = 0
    nint = 0
    span = {}
    stack = [(0, 0)]
    while stack:
        n, phase = stack.pop()
        if isleaf[n]:
            span[n] = (nleaf, nleaf + 1)
            leafval[nleaf] = lv[n]
            nleaf += 1
        elif phase == 0:
            stack.append((n, 1))
            stack.append((int(left[n]), 0))
        elif phase == 1:
            stack.append((n, 2))
            stack.append((int(right[n]), 0))
        else:
            ls, le = span[int(left[n])]
            span[n] = (ls, span[int(right[n])][1])
            fid[nint] = feat[n]
            thr[nint] = thrv[n]
            excl[nint, ls:le] = True
            nint += 1


def _tables(trees, weights, cap: int, max_nodes: int, space: str) -> QSEnsemble:
    """QSEnsemble of ``cap`` slots, the first ``len(trees)`` from the host
    node arrays in ``trees`` (dicts of the seven node fields), the rest
    dead."""
    if space not in ("value", "bin"):
        raise ValueError(f"space must be 'value' or 'bin', got {space!r}")
    I, L, W = qs_shape(max_nodes)
    fid = np.zeros((cap, I), np.int32)
    thr = np.full((cap, I), FLT_MAX, np.float32)
    excl = np.zeros((cap, I, W * 64), bool)
    leafval = np.zeros((cap, L), np.float32)
    for t, h in enumerate(trees):
        thrv = h["threshold"] if space == "value" else h["threshold_bin"].astype(np.float32)
        _tree_tables(h["feature"], thrv, h["left"], h["right"], h["is_leaf"],
                     h["leaf_value"], fid[t], thr[t], excl[t], leafval[t])
    words = np.packbits(excl, axis=-1, bitorder="little")
    words = np.ascontiguousarray(words).view("<u8").view(np.int64)
    w = np.zeros((cap,), np.float32)
    w[: len(trees)] = weights
    return QSEnsemble(
        fid=torch.from_numpy(fid),
        thr=torch.from_numpy(thr),
        excl=torch.from_numpy(words.reshape(cap, I, W)),
        leafval=torch.from_numpy(leafval),
        weight=torch.from_numpy(w),
        num_trees=len(trees),
        min_features=int(fid.max()) + 1 if fid.size else 1,
    )


_NODE_FIELDS = ("feature", "threshold", "threshold_bin", "left", "right",
                "is_leaf", "leaf_value")


def ensemble_to_qs(ens, space: str = "value") -> QSEnsemble:
    """Host-side table build from an EnsembleTensors.

    ``space="bin"`` takes the thresholds from ``threshold_bin``: scoring the
    binned matrix through the same scorer is then the training-time routing
    (``bin <= threshold_bin`` is ``v <= threshold`` by the binning's
    construction, and bin ids are exact in the float32 compare).  Warm
    starts rescore that way, because raw features never reach the device."""
    h = ens.numpy()
    T = int(ens.num_trees)
    trees = [{k: h[k][t] for k in _NODE_FIELDS} for t in range(T)]
    return _tables(trees, h["weight"][:T], ens.capacity, ens.max_nodes, space)


def tree_to_qs_row(tree, weight: float, space: str = "bin") -> torch.Tensor:
    """One tree's row of the packed table, int32 ``[S]`` on the host: the
    row :func:`pack_tables` of :func:`ensemble_to_qs` writes for a slot that
    holds ``tree`` with ``weight`` (the shape follows the tree's node budget,
    as the ensemble's does).  A table grown a tree at a time from these rows
    is the whole-ensemble build byte for byte, so a learner that appends
    trees keeps its packed table on the device and never rebuilds it."""
    h = {k: getattr(tree, k).cpu().numpy() for k in _NODE_FIELDS}
    qs = _tables([h], np.float32(weight), 1, int(tree.feature.shape[-1]), space)
    return pack_tables(qs)[0]


def table_from_packed(packed: torch.Tensor, max_nodes: int,
                      min_features: int = 1) -> QSEnsemble:
    """A QSEnsemble over packed rows (``[T, S]``, any device, every row a
    live tree), for the scoring wrappers: the kernel streams ``packed`` as
    it is, the plain versions read the tables unpacked from it."""
    I, L, W = qs_shape(max_nodes)
    qs = unpack_tables(packed, I, L, W, packed.shape[0], min_features)
    qs._packed = packed
    return qs


def packed_stride(nodes: int, leaves: int, words: int) -> int:
    """32-bit words a tree takes in the packed table: its records, leaf
    values and weight, rounded up to whole 16-byte vectors."""
    return -(-(nodes * words * 4 + leaves + 1) // 4) * 4


def pack_tables(qs: QSEnsemble) -> torch.Tensor:
    """int32 ``[T, S]``, the one tensor the CUDA kernel streams through
    shared memory.  Per tree: ``I * W`` records of four 32-bit words
    ``{fid, thr bits, excl low half, excl high half}``, word-major (record
    ``w * I + i`` holds node ``i``'s leaf-set word ``w``, with the node's
    test repeated in every word), then the ``L`` leaf values and the weight
    as float32 bits, zero-padded to ``S = packed_stride(I, L, W)``.  The
    halves of a 64-bit leaf-set word are taken from memory, low half first
    (little-endian hosts and devices)."""
    T, I = qs.fid.shape
    L, W = qs.num_leaves, int(qs.excl.shape[2])
    out = torch.zeros((T, packed_stride(I, L, W)), dtype=torch.int32,
                      device=qs.fid.device)
    rec = out[:, : I * W * 4].view(T, W, I, 4)
    rec[..., 0] = qs.fid[:, None, :]
    rec[..., 1] = qs.thr.contiguous().view(torch.int32)[:, None, :]
    rec[..., 2:] = (qs.excl.permute(0, 2, 1).contiguous().view(torch.int32)
                    .view(T, W, I, 2))
    out[:, I * W * 4: I * W * 4 + L] = qs.leafval.contiguous().view(torch.int32)
    out[:, I * W * 4 + L] = qs.weight.contiguous().view(torch.int32)
    return out


def unpack_tables(packed: torch.Tensor, nodes: int, leaves: int, words: int,
                  num_trees: int, min_features: int) -> QSEnsemble:
    """The inverse of :func:`pack_tables`: the tables read back from the
    packed records (the tests hold the packing to it)."""
    T = packed.shape[0]
    rec = packed[:, : nodes * words * 4].reshape(T, words, nodes, 4)
    excl = (rec[..., 2:].contiguous().view(torch.int64).view(T, words, nodes)
            .permute(0, 2, 1).contiguous())
    tail = packed[:, nodes * words * 4:].contiguous().view(torch.float32)
    return QSEnsemble(
        fid=rec[:, 0, :, 0].contiguous(),
        thr=rec[:, 0, :, 1].contiguous().view(torch.float32),
        excl=excl, leafval=tail[:, :leaves].contiguous(),
        weight=tail[:, leaves].contiguous(),
        num_trees=num_trees, min_features=min_features,
    )


def unpack_leaf_masks(qs: QSEnsemble) -> torch.Tensor:
    """bool [T, I, L]: leaf ``l`` in node ``i``'s excluded set."""
    leaves = torch.arange(qs.num_leaves, device=qs.excl.device)
    words = qs.excl[:, :, leaves // 64]
    return ((words >> (leaves % 64)) & 1).bool()


def _exit_values(features: torch.Tensor, qs: QSEnsemble, t0: int, t1: int):
    """Yields ``(a, b, d)``: per chunk ``[a, b)`` of the slots ``[t0, t1)``
    the leaf value f32 ``[N, b - a]`` each doc exits at in each tree.

    The false bits by a gather (exact), the exclusion counts by a product of
    {0, 1} matrices (exact integers in float32), the leftmost leaf with count
    0, and the leaf value: bitwise the descent's ``leaf_value[node]``."""
    N = features.shape[0]
    I = qs.fid.shape[1]
    L = qs.num_leaves
    chunk = max(1, _CHUNK_ELEMS // max(1, N * max(I, L)))
    for a in range(t0, t1, chunk):
        b = min(t1, a + chunk)
        excl = unpack_leaf_masks(dataclasses.replace(qs, excl=qs.excl[a:b])).float()
        fid = qs.fid[a:b].long()
        cols = (bin_columns(features, fid.reshape(-1)) if features.dtype == torch.uint16
                else features[:, fid.reshape(-1)])
        false_bits = cols.view(N, b - a, I) > qs.thr[a:b]
        counts = torch.einsum("nti,til->ntl", false_bits.float(), excl)
        exit_leaf = (counts == 0).to(torch.uint8).argmax(dim=2)  # first max
        yield a, b, qs.leafval[a:b].gather(1, exit_leaf.T).T


def score_qs(features: torch.Tensor, qs: QSEnsemble) -> torch.Tensor:
    """Weighted ensemble scores f32 [N], the plain version of the
    QuickScorer kernel (``ops/kernel_qs.py``), on any device.

    The exit leaves' values (:func:`_exit_values`) are summed in slot order
    with the Kahan chain of ``ops/scoring.py::score_ensemble``, so the
    scores are bitwise those of the compensated descent."""
    s = torch.zeros(features.shape[0], dtype=torch.float32, device=features.device)
    c = torch.zeros_like(s)
    for a, b, d in _exit_values(features, qs, 0, qs.fid.shape[0]):
        for k in range(b - a):
            s, c = kahan_add(s, c, qs.weight[a + k], d[:, k])
    return s


def partial_scores_qs(features: torch.Tensor, qs: QSEnsemble, t0: int = 0,
                      t1: Optional[int] = None) -> torch.Tensor:
    """Per-tree *unweighted* scores f32 ``[N, t1 - t0]`` of the slots
    ``[t0, t1)`` (default all), the plain version of the QuickScorer
    kernel's partial entry (counterpart of JAX ``trees/qs.py::
    partial_scores_qs``, Ensemble::partial_scores_instance,
    ensemble.cc:120-131): column ``t`` is bitwise the descent's
    ``leaf_value[node]`` of slot ``t0 + t``; dead slots are zero columns
    (their tables are zero by construction)."""
    t1 = qs.fid.shape[0] if t1 is None else t1
    out = torch.zeros((features.shape[0], max(0, t1 - t0)), dtype=torch.float32,
                      device=features.device)
    for a, b, d in _exit_values(features, qs, t0, t1):
        out[:, a - t0: b - t0] = d
    return out
