"""Learning-to-rank algorithm interface (counterpart of
quickrank_tpu/learning/base.py's ``LTRAlgorithm``).  Scoring is a batched
dataset-level operation on an explicit device."""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card, and
    without one it is an error; nothing moves to the CPU unless the caller
    passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "quickrank_tpu_torch runs on a CUDA device by default and none "
                'is available; pass device="cpu" to run the plain PyTorch '
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class LTRAlgorithm:
    NAME = "ABSTRACT"

    def learn(self, train: Dataset, valid=None, metric=None,
              verbose: bool = True, device=None) -> dict:
        raise NotImplementedError

    def group_refusal(self):
        """What of this learner does not train under a query-sharded group
        (``learn(mesh=...)``, quicklearn's ``--num-shards``), or None when
        all of it does; by default the learner itself (ROADMAP.md §A item
        10b)."""
        return self.NAME

    def score_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        """float32 scores per doc in dataset order, computed on ``device``
        (``None`` = the CUDA card; see :func:`resolve_device`)."""
        raise NotImplementedError

    def evaluate(self, ds: Dataset, metric, device=None) -> float:
        """``metric`` of this model's scores on ``ds`` (scored on
        ``device``), the mean over queries of metric.h:77-106."""
        from quickrank_tpu_torch.data.dataset import pack_doc_values, shard_and_pad

        padded = shard_and_pad(ds)
        scores = pack_doc_values(padded, torch.from_numpy(self.score_dataset(ds, device)))
        return metric.evaluate_dataset(padded, scores)

    @staticmethod
    def default_metric():
        from quickrank_tpu_torch.metrics.metrics import Ndcg

        return Ndcg(10)

    def get_weights(self) -> np.ndarray:
        raise NotImplementedError

    def save(self, path: str) -> None:
        from quickrank_tpu_torch.io import xml_model

        xml_model.save_model(self, path)

    @staticmethod
    def load(path: str) -> "LTRAlgorithm":
        from quickrank_tpu_torch.io import xml_model

        return xml_model.load_model(path)
