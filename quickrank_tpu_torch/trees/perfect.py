"""Perfect-binary-tree embedding of depth-capped ensembles and its plain
scorer (counterpart of quickrank_tpu/trees/perfect.py: ``tree_depths``,
``ensemble_to_perfect``, and the sum the Pallas perfect kernel computes).

Any tree of depth <= D embeds into the complete binary tree of depth D:
missing subtrees become pass-through nodes (threshold FLT_MAX, so every
finite feature goes left) and a leaf's value repeats over the leaf range it
covers.  Every internal node's (feature, threshold) is then independent of
the doc, and a doc's leaf is the path of its D comparison bits.

Heap indexing: internal node h has children 2h+1 (left, ``x <= thr``) and
2h+2 (right, ``x > thr``); after D steps ``h - (2^D - 1)`` is the leaf.
The JAX package pads the tree count to a multiple of 25 for its TPU blocks;
the port does not pad.

The CUDA kernel reads the tables in one packed tensor (:func:`pack_perfect`):
per tree the ``2^D - 1`` node pairs ``{fid, thr bits}`` in heap order, then
the ``2^D`` float32 ``wleaf`` values, padded to whole 16-byte vectors.  It
is built once per table (``PerfectEnsemble.packed``); the plain scorer reads
the unpacked tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

FLT_MAX = np.float32(3.4028235e38)

#: elements of the largest [N, trees, nodes] intermediate of the plain scorer
_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass
class PerfectEnsemble:
    """fid/thr: [T, 2^D - 1] internal nodes in heap order; leaf: [T, 2^D];
    weight: [T]; wleaf = leaf * weight[:, None] in float32, the table the
    kernel sums."""

    fid: torch.Tensor  # int32
    thr: torch.Tensor  # float32
    leaf: torch.Tensor  # float32
    weight: torch.Tensor  # float32
    wleaf: torch.Tensor  # float32
    #: smallest feature count the tables can be scored against
    min_features: int
    _packed: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def depth(self) -> int:
        return int(self.leaf.shape[1]).bit_length() - 1

    def packed(self) -> torch.Tensor:
        """The tables as the CUDA kernel reads them (:func:`pack_perfect`),
        on the tables' device; built at the first call and kept.  The
        tensors are not written after that call."""
        if self._packed is None:
            self._packed = pack_perfect(self)
        return self._packed

    def to(self, device) -> "PerfectEnsemble":
        return dataclasses.replace(
            self, fid=self.fid.to(device), thr=self.thr.to(device),
            leaf=self.leaf.to(device), weight=self.weight.to(device),
            wleaf=self.wleaf.to(device), _packed=self.packed().to(device),
        )


def packed_stride(depth: int) -> int:
    """32-bit words a tree takes in the packed table: two a node and one a
    leaf, rounded up to whole 16-byte vectors (48 at depth 4, 96 at 5)."""
    return -(-(2 * (2**depth - 1) + 2**depth) // 4) * 4


def pack_perfect(pe: PerfectEnsemble) -> torch.Tensor:
    """int32 ``[T, S]``, the one tensor the CUDA kernel streams through
    shared memory.  Per tree: ``2^D - 1`` pairs ``{fid, thr bits}`` in heap
    order (node h at words 2h, 2h + 1), then the ``2^D`` float32 ``wleaf``
    values as bits, zero-padded to ``S = packed_stride(D)``."""
    T, I = pe.fid.shape
    out = torch.zeros((T, packed_stride(pe.depth)), dtype=torch.int32,
                      device=pe.fid.device)
    nodes = out[:, : 2 * I].view(T, I, 2)
    nodes[..., 0] = pe.fid
    nodes[..., 1] = pe.thr.contiguous().view(torch.int32)
    out[:, 2 * I: 2 * I + I + 1] = pe.wleaf.contiguous().view(torch.int32)
    return out


def unpack_perfect(packed: torch.Tensor, depth: int):
    """The inverse of :func:`pack_perfect`: ``(fid, thr, wleaf)`` read back
    from the packed records (the tests hold the packing to it)."""
    T = packed.shape[0]
    I = 2**depth - 1
    nodes = packed[:, : 2 * I].reshape(T, I, 2)
    return (nodes[..., 0].contiguous(),
            nodes[..., 1].contiguous().view(torch.float32),
            packed[:, 2 * I: 2 * I + I + 1].contiguous().view(torch.float32))


def tree_depths(ens, cap: Optional[int] = None) -> np.ndarray:
    """Max depth of each live tree.  Iterative, so a chain-shaped imported
    tree does not ride Python's recursion limit; with ``cap``, a tree deeper
    than ``cap`` reports ``cap + 1`` without walking the rest of it."""
    T = int(ens.num_trees)
    left = ens.left.cpu().numpy()
    right = ens.right.cpu().numpy()
    isleaf = ens.is_leaf.cpu().numpy()

    def depth(t):
        maxd = 0
        stack = [(0, 0)]
        while stack:
            i, d = stack.pop()
            if isleaf[t, i]:
                maxd = max(maxd, d)
                continue
            if cap is not None and d >= cap:
                return cap + 1
            stack.append((int(left[t, i]), d + 1))
            stack.append((int(right[t, i]), d + 1))
        return maxd

    return np.asarray([depth(t) for t in range(T)], dtype=np.int64)


def ensemble_to_perfect(ens, max_depth: int = 5) -> Optional[PerfectEnsemble]:
    """Embed the live trees of an EnsembleTensors into perfect depth-D form
    (D = the deepest tree, at least 1), or None when the ensemble is empty
    or a tree is deeper than ``max_depth``."""
    T = int(ens.num_trees)
    if T == 0:
        return None
    depths = tree_depths(ens, cap=max_depth)
    D = int(max(1, depths.max()))
    if D > max_depth:
        return None
    I = 2**D - 1
    L = 2**D
    h = ens.numpy()
    feat, thrv = h["feature"], h["threshold"]
    left, right = h["left"], h["right"]
    isleaf, lv = h["is_leaf"], h["leaf_value"]

    fid = np.zeros((T, I), np.int32)
    thr = np.full((T, I), FLT_MAX, np.float32)
    leaf = np.zeros((T, L), np.float32)

    for t in range(T):
        stack = [(0, 0, 0)]  # (node, heap index, depth)
        while stack:
            i, heap, d = stack.pop()
            if isleaf[t, i]:
                span = 2 ** (D - d)
                start = (heap - (2**d - 1)) * span
                leaf[t, start : start + span] = lv[t, i]
                continue
            fid[t, heap] = feat[t, i]
            thr[t, heap] = thrv[t, i]
            stack.append((int(right[t, i]), 2 * heap + 2, d + 1))
            stack.append((int(left[t, i]), 2 * heap + 1, d + 1))

    weight = h["weight"][:T].astype(np.float32)
    return PerfectEnsemble(
        fid=torch.from_numpy(fid),
        thr=torch.from_numpy(thr),
        leaf=torch.from_numpy(leaf),
        weight=torch.from_numpy(weight.copy()),
        wleaf=torch.from_numpy(leaf * weight[:, None]),
        min_features=int(fid.max()) + 1,
    )


def score_perfect(features: torch.Tensor, pe: PerfectEnsemble) -> torch.Tensor:
    """Weighted ensemble scores f32 [N], the plain version of the perfect
    kernel (``ops/kernel_perfect.py``), on any device: D heap steps per
    tree, then a plain float32 sum of ``wleaf[t, leaf]`` in tree order,
    which is what the kernel computes (no Kahan compensation, as in the
    Pallas kernel it replaces)."""
    N = features.shape[0]
    T, I = pe.fid.shape
    D = pe.depth
    acc = torch.zeros(N, dtype=torch.float32, device=features.device)
    chunk = max(1, _CHUNK_ELEMS // max(1, N * I))
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        fid = pe.fid[t0:t1].long()
        right = features[:, fid.reshape(-1)].view(N, t1 - t0, I) > pe.thr[t0:t1]
        h = torch.zeros((N, t1 - t0), dtype=torch.long, device=features.device)
        for _ in range(D):
            h = 2 * h + 1 + right.gather(2, h[..., None])[..., 0].long()
        v = pe.wleaf[t0:t1].gather(1, (h - I).T).T  # [N, chunk]
        for k in range(t1 - t0):
            acc = acc + v[:, k]
    return acc
