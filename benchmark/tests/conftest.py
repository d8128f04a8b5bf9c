"""Shared helpers of the benchmark's CPU tests: cells cut to a size the CPU
runs in seconds (the harness, the reference and the program's plain
versions; no number from them is a device number)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402

TRAIN = ["train.lambdamart-best16.mslr30k", "train.oblivious-d4.mslr30k"]
SCORE = ["score.oblivious-d4x1000.b131k", "score.lambdamart-qs16x1000.b131k"]
#: a seed past 32 signed bits, as the benchmark's runs get
SEED = 2 ** 31 + 977


def tiny(name: str) -> cells.Cell:
    c = cells.Cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["data"].update(train_queries=60, valid_queries=20)
    c.config["ntrees"] = 4
    c.config["serving"]["trees"] = 40
    c.traffic = dict(c.traffic, batch_docs=1024, pool_batches=3, warmup_batches=2,
                     sample_batches=8, trace_batches=6)
    return c


@pytest.fixture
def cuda_device():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
