"""LambdaMART (counterpart of quickrank_tpu/learning/lambdamart.py).  Its
inference is Mart's; the lambda-gradient training waits for the training
slice (ROADMAP.md §A item 3)."""

from __future__ import annotations

from quickrank_tpu_torch.learning.mart import Mart


class LambdaMart(Mart):
    NAME = "LAMBDAMART"
