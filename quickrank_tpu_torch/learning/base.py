"""Learning-to-rank algorithm interface (counterpart of
quickrank_tpu/learning/base.py's ``LTRAlgorithm``).  Scoring is a batched
dataset-level operation on an explicit device.  ``evaluate`` waits for the
metrics port (ROADMAP.md §A item 2)."""

from __future__ import annotations

import numpy as np

from quickrank_tpu_torch.data.dataset import Dataset


class LTRAlgorithm:
    NAME = "ABSTRACT"

    def learn(self, train: Dataset, valid=None, metric=None,
              verbose: bool = True) -> dict:
        raise NotImplementedError

    def score_dataset(self, ds: Dataset, device="cpu") -> np.ndarray:
        """float32 scores per doc in dataset order, computed on ``device``."""
        raise NotImplementedError

    def get_weights(self) -> np.ndarray:
        raise NotImplementedError

    def save(self, path: str) -> None:
        from quickrank_tpu_torch.io import xml_model

        xml_model.save_model(self, path)

    @staticmethod
    def load(path: str) -> "LTRAlgorithm":
        from quickrank_tpu_torch.io import xml_model

        return xml_model.load_model(path)
