"""CustomLTR, the skeleton algorithm (counterpart of
quickrank_tpu/learning/custom.py, after src/learning/custom/custom_ltr.cc):
the least surface a new algorithm implements (learn, score_dataset, XML save
and load).  Every document scores the reference's fixed constant."""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning.base import LTRAlgorithm, resolve_device


class CustomLTR(LTRAlgorithm):
    NAME = "CUSTOM"
    FIXED_SCORE = 666.0  # custom_ltr.cc's fixed score

    def __init__(self):
        self.history: dict = {}

    def learn(self, train: Dataset, valid=None, metric=None, verbose: bool = True,
              device=None) -> dict:
        metric = metric or self.default_metric()
        if verbose:
            print(f"# {self.NAME}: fixed-score example ranker")
        self.history = {"train": [self.evaluate(train, metric, device)], "valid": []}
        return self.history

    def scorer_path(self) -> str:
        return "custom"

    def device_scorer(self, ds: Dataset, device=None):
        """(fn, features on ``device``): ``fn`` gives every row the fixed
        score, float64."""
        device = resolve_device(device)
        X = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32)).to(device)
        return (lambda x: torch.full((x.shape[0],), self.FIXED_SCORE, dtype=torch.float64,
                                     device=x.device)), X

    def score_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        resolve_device(device)
        return np.full(ds.num_docs, self.FIXED_SCORE, np.float64)

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        return root

    @classmethod
    def _from_xml(cls, root):
        return cls()
