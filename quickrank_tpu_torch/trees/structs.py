"""Dense (structure-of-arrays) ensemble container (counterpart of
quickrank_tpu/trees/structs.py's ``EnsembleTensors``).

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
