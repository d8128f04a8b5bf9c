"""Dense (structure-of-arrays) tree and ensemble containers (counterpart of
quickrank_tpu/trees/structs.py's ``Tree`` and ``EnsembleTensors``).

Node layout: node 0 is the root; children are allocated in split order.
``is_leaf`` marks leaves; unused padding nodes have ``is_leaf=True`` and
``leaf_value=0``.  Slots ``>= num_trees`` are dead: scorers give them
weight 0.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

#: the nine fields, in the JAX package's order and with its names
FIELDS = (
    "feature", "threshold", "threshold_bin", "left", "right", "is_leaf",
    "leaf_value", "weight", "num_trees",
)

_DTYPES = {
    "feature": torch.int32,
    "threshold": torch.float32,
    "threshold_bin": torch.int32,
    "left": torch.int32,
    "right": torch.int32,
    "is_leaf": torch.bool,
    "leaf_value": torch.float32,
    "weight": torch.float32,
}


@dataclasses.dataclass
class Tree:
    """One regression tree over a fixed ``max_nodes`` node budget."""

    feature: torch.Tensor  # i32, -1 on leaves and unused nodes
    threshold: torch.Tensor  # f32, go left iff x[f] <= threshold
    threshold_bin: torch.Tensor  # i32 bin-space split point
    left: torch.Tensor  # i32
    right: torch.Tensor  # i32
    is_leaf: torch.Tensor  # bool
    leaf_value: torch.Tensor  # f32

    @property
    def max_nodes(self) -> int:
        return int(self.feature.shape[-1])

    @staticmethod
    def empty(max_nodes: int, device="cpu") -> "Tree":
        def full(v, dt):
            return torch.full((max_nodes,), v, dtype=dt, device=device)

        return Tree(
            feature=full(-1, torch.int32),
            threshold=full(0.0, torch.float32),
            threshold_bin=full(-1, torch.int32),
            left=full(0, torch.int32),
            right=full(0, torch.int32),
            is_leaf=full(True, torch.bool),
            leaf_value=full(0.0, torch.float32),
        )

    @staticmethod
    def from_numpy(d: Mapping[str, np.ndarray], device="cpu") -> "Tree":
        """Build from the seven node fields as numpy arrays (or anything
        ``np.asarray`` takes), e.g. a JAX ``Tree``'s fields."""
        return Tree(**{
            k: torch.as_tensor(np.array(d[k])).to(dt).to(device)
            for k, dt in _DTYPES.items() if k != "weight"
        })


@dataclasses.dataclass
class EnsembleTensors:
    """Stacked trees ``[T, max_nodes]`` plus per-tree weights ``[T]``."""

    feature: torch.Tensor  # i32, -1 on leaves
    threshold: torch.Tensor  # f32, go left iff x[f] <= threshold
    threshold_bin: torch.Tensor  # i32, bin-space split point
    left: torch.Tensor  # i32
    right: torch.Tensor  # i32
    is_leaf: torch.Tensor  # bool
    leaf_value: torch.Tensor  # f32
    weight: torch.Tensor  # f32 [T]
    num_trees: int  # live prefix of the T slots

    @property
    def capacity(self) -> int:
        return int(self.feature.shape[0])

    @property
    def max_nodes(self) -> int:
        return int(self.feature.shape[1])

    @staticmethod
    def empty(capacity: int, max_nodes: int, device="cpu") -> "EnsembleTensors":
        """``capacity`` empty zero-weight slots, none live."""
        t = Tree.empty(max_nodes, device)
        kw = {k: getattr(t, k).expand(capacity, max_nodes).clone()
              for k in _DTYPES if k != "weight"}
        return EnsembleTensors(
            weight=torch.zeros(capacity, dtype=torch.float32, device=device),
            num_trees=0, **kw)

    def push(self, tree: Tree, weight: float) -> None:
        """Write ``tree`` into slot ``num_trees`` and count it live
        (Ensemble::push, ensemble.cc:97-105).  In place: the JAX package
        returns a new pytree, the port updates its buffers."""
        t = self.num_trees
        if t >= self.capacity:
            raise ValueError(f"ensemble full: capacity {self.capacity}")
        for k in _DTYPES:
            if k != "weight":
                getattr(self, k)[t] = getattr(tree, k)
        self.weight[t] = weight
        self.num_trees = t + 1

    def tree(self, t: int) -> Tree:
        """Slot ``t`` as a :class:`Tree` (views, not copies)."""
        return Tree(**{k: getattr(self, k)[t] for k in _DTYPES if k != "weight"})

    def live(self) -> "EnsembleTensors":
        """The first ``num_trees`` slots only (dead capacity trimmed)."""
        T = self.num_trees
        return dataclasses.replace(
            self, **{k: getattr(self, k)[:T].clone() for k in _DTYPES}
        )

    def to(self, device) -> "EnsembleTensors":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _DTYPES}
        )

    def numpy(self) -> dict:
        """Host copies of the tensor fields, plus ``num_trees``."""
        out = {k: getattr(self, k).cpu().numpy() for k in _DTYPES}
        out["num_trees"] = self.num_trees
        return out

    @staticmethod
    def from_numpy(d: Mapping[str, np.ndarray]) -> "EnsembleTensors":
        """Build from the nine fields as numpy arrays (or anything
        ``np.asarray`` takes), e.g. the JAX package's EnsembleTensors
        fields.  Dtypes are converted to the port's."""
        kw = {
            k: torch.as_tensor(np.array(d[k])).to(dt)
            for k, dt in _DTYPES.items()
        }
        ens = EnsembleTensors(num_trees=int(np.asarray(d["num_trees"])), **kw)
        T, M = ens.feature.shape
        for k in _DTYPES:
            want = (T,) if k == "weight" else (T, M)
            if tuple(getattr(ens, k).shape) != want:
                raise ValueError(
                    f"{k}: shape {tuple(getattr(ens, k).shape)}, want {want}"
                )
        if not 0 <= ens.num_trees <= T:
            raise ValueError(f"num_trees {ens.num_trees} outside [0, {T}]")
        return ens
