"""QuickScorer bitvector tables and the plain QuickScorer scorer
(counterpart of quickrank_tpu/trees/qs.py: ``ensemble_to_qs`` in value and
bin space, and ``score_qs``).

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
the unpacked tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

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


def ensemble_to_qs(ens, space: str = "value") -> QSEnsemble:
    """Host-side table build from an EnsembleTensors.

    ``space="bin"`` takes the thresholds from ``threshold_bin``: scoring the
    binned matrix through the same scorer is then the training-time routing
    (``bin <= threshold_bin`` is ``v <= threshold`` by the binning's
    construction, and bin ids are exact in the float32 compare).  Warm
    starts rescore that way, because raw features never reach the device.

    Iterative walks, so a chain-shaped imported tree does not ride Python's
    recursion limit."""
    if space not in ("value", "bin"):
        raise ValueError(f"space must be 'value' or 'bin', got {space!r}")
    h = ens.numpy()
    T = int(ens.num_trees)
    cap = ens.capacity
    max_nodes = ens.max_nodes
    feat = h["feature"]
    thrv = h["threshold"] if space == "value" else h["threshold_bin"].astype(np.float32)
    left, right = h["left"], h["right"]
    isleaf, lv = h["is_leaf"], h["leaf_value"]

    I = max(1, max_nodes // 2)  # 2k-1 nodes -> k-1 internal
    L = max(1, max_nodes - I)  # k leaves
    W = -(-L // 64)

    fid = np.zeros((cap, I), np.int32)
    thr = np.full((cap, I), FLT_MAX, np.float32)
    excl = np.zeros((cap, I, W * 64), bool)
    leafval = np.zeros((cap, L), np.float32)

    for t in range(T):
        # post-order walk: leaves numbered left to right, internal nodes
        # take compact slots in visit order with their left leaf span
        nleaf = 0
        nint = 0
        span = {}
        stack = [(0, 0)]
        while stack:
            n, phase = stack.pop()
            if isleaf[t, n]:
                span[n] = (nleaf, nleaf + 1)
                leafval[t, nleaf] = lv[t, n]
                nleaf += 1
            elif phase == 0:
                stack.append((n, 1))
                stack.append((int(left[t, n]), 0))
            elif phase == 1:
                stack.append((n, 2))
                stack.append((int(right[t, n]), 0))
            else:
                ls, le = span[int(left[t, n])]
                span[n] = (ls, span[int(right[t, n])][1])
                fid[t, nint] = feat[t, n]
                thr[t, nint] = thrv[t, n]
                excl[t, nint, ls:le] = True
                nint += 1

    words = np.packbits(excl, axis=-1, bitorder="little")
    words = np.ascontiguousarray(words).view("<u8").view(np.int64)
    w = np.zeros((cap,), np.float32)
    w[:T] = h["weight"][:T]
    return QSEnsemble(
        fid=torch.from_numpy(fid),
        thr=torch.from_numpy(thr),
        excl=torch.from_numpy(words.reshape(cap, I, W)),
        leafval=torch.from_numpy(leafval),
        weight=torch.from_numpy(w),
        num_trees=T,
        min_features=int(fid.max()) + 1 if fid.size else 1,
    )


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


def score_qs(features: torch.Tensor, qs: QSEnsemble) -> torch.Tensor:
    """Weighted ensemble scores f32 [N], the plain version of the
    QuickScorer kernel (``ops/kernel_qs.py``), on any device.

    Per chunk of trees: the false bits by a gather (exact), the exclusion
    counts by a product of {0, 1} matrices (exact integers in float32), the
    leftmost leaf with count 0, and the leaf value.  The trees are then
    summed in slot order with the Kahan chain of
    ``ops/scoring.py::score_ensemble``, so the scores are bitwise those of
    the compensated descent."""
    N = features.shape[0]
    T, I = qs.fid.shape
    L = qs.num_leaves
    excl = unpack_leaf_masks(qs).float()
    s = torch.zeros(N, dtype=torch.float32, device=features.device)
    c = torch.zeros_like(s)
    chunk = max(1, _CHUNK_ELEMS // max(1, N * max(I, L)))
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        fid = qs.fid[t0:t1].long()
        false_bits = features[:, fid.reshape(-1)].view(N, t1 - t0, I) > qs.thr[t0:t1]
        counts = torch.einsum("nti,til->ntl", false_bits.float(), excl[t0:t1])
        exit_leaf = (counts == 0).to(torch.uint8).argmax(dim=2)  # first max
        d = qs.leafval[t0:t1].gather(1, exit_leaf.T).T  # [N, chunk]
        for k in range(t1 - t0):
            s, c = kahan_add(s, c, qs.weight[t0 + k], d[:, k])
    return s
