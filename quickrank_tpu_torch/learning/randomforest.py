"""Random Forest, bagged regression trees on the raw labels (counterpart of
quickrank_tpu/learning/randomforest.py, after
src/learning/forests/randomforest.cc:35-52): Mart whose pseudoresponses are
the labels at every iteration, with no gradient feedback; the randomness is
the ``subsample`` and ``max_features`` bagging."""

from __future__ import annotations

from quickrank_tpu_torch.learning.mart import Mart, StepData


class RandomForest(Mart):
    NAME = "RANDOMFOREST"
    _shardable = False  # ROADMAP.md §A item 10b

    def _gradients(self, sd: StepData, scores, sample_mask, full_mask=False):
        return sd.labels.float(), None
