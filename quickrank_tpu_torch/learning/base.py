"""Learning-to-rank algorithm interface (counterpart of
quickrank_tpu/learning/base.py's ``LTRAlgorithm``).  Scoring is a batched
dataset-level operation on an explicit device."""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset


class LTRAlgorithm:
    NAME = "ABSTRACT"

    def learn(self, train: Dataset, valid=None, metric=None,
              verbose: bool = True) -> dict:
        raise NotImplementedError

    def score_dataset(self, ds: Dataset, device="cpu") -> np.ndarray:
        """float32 scores per doc in dataset order, computed on ``device``."""
        raise NotImplementedError

    def evaluate(self, ds: Dataset, metric, device="cpu") -> float:
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
