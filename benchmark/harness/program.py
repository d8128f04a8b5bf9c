"""The one module of the harness that touches the program under test,
``quickrank_tpu_torch``, through its public entry points: the learners,
``TrainData.build``, ``learn``, ``device_scorer`` and the counters the
program keeps (``trees/grow.py::HOST_SYNCS``).  The reference and the
comparison never import it.
"""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning.factory import ltr_algorithm_factory
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.metrics import metric_factory
from quickrank_tpu_torch.trees import grow
from quickrank_tpu_torch.trees.structs import EnsembleTensors


def dataset(features: torch.Tensor, labels: torch.Tensor, counts: np.ndarray,
            name: str) -> Dataset:
    qids = np.repeat(np.arange(1, len(counts) + 1), counts)
    return Dataset.from_arrays(features.cpu().numpy(), labels.cpu().numpy(), qids, name=name)


def learner(cfg: dict, ntrees: int):
    """A fresh learner of the configuration with ``ntrees`` trees, built as
    quicklearn builds it: by its name and its command-line parameters."""
    return ltr_algorithm_factory(cfg["algo"], **dict(cfg["params"], num_trees=ntrees))


def metric(cfg: dict):
    return metric_factory(cfg["metric"])


def train_data(ds: Dataset, cfg: dict, device) -> TrainData:
    return TrainData.build(ds, cfg["params"]["num_thresholds"], device=device)


def host_syncs() -> int:
    return grow.HOST_SYNCS


def trees_of(model) -> list:
    """The model's trees as numpy node arrays (feature, threshold, left,
    right, is_leaf, leaf_value, weight), root at node 0."""
    h = model.ensemble.numpy()
    keys = ("feature", "threshold", "left", "right", "is_leaf", "leaf_value")
    return [dict({k: h[k][t] for k in keys}, weight=float(h["weight"][t]))
            for t in range(h["num_trees"])]


def serving_model(cfg: dict, nodes: dict):
    """A learner of the configuration holding ``nodes`` (node arrays of an
    ensemble) as its model."""
    model = ltr_algorithm_factory(cfg["algo"], **cfg["params"])
    model.ensemble = EnsembleTensors.from_numpy(nodes)
    return model


def empty_dataset(num_features: int) -> Dataset:
    return Dataset.from_arrays(np.zeros((1, num_features), np.float32),
                               np.zeros(1, np.float32), np.ones(1, np.int64))
