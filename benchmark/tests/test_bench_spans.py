"""The readers of the program's spans (``metrics/_spans.py`` and the six
metrics that use it) on traces captured on the CPU by the harness itself
(``harness/trace.py::capture`` around a cell's traced stretch, at a tiny
size): each agrees with the spans' lengths summed here, and each returns
``None`` from a trace that holds no program span.  On the CPU the trace has
no device interval, so the whole stretch is one idle gap."""

import math
import types

import numpy as np
import pytest
import torch
from conftest import SCORE, SEED, TRAIN, tiny

from benchmark.harness import cell as cells
from benchmark.harness.trace import capture

TRAIN_READERS = ["learn_init_s.train", "lambdas_ms_per_tree", "grow_ms_per_tree",
                 "wait_ms_per_tree.train", "grow_idle_ms_per_tree"]
READERS = TRAIN_READERS + ["dispatch_us.score"]


def _traced(name):
    loop = tiny(name).loop(SEED, "cpu")
    loop.setup()
    traced, tr = capture(loop.traced)
    return types.SimpleNamespace(trace=tr, traced=traced)


def _lengths(ctx, pick):
    return [e - s for s, e, n in ctx.trace.cpu if pick(n)]


@pytest.fixture(scope="module", params=TRAIN)
def train_ctx(request):
    return _traced(request.param)


@pytest.fixture(scope="module", params=SCORE)
def score_ctx(request):
    return _traced(request.param)


def test_training_readers_agree_with_the_spans(train_ctx):
    ctx = train_ctx
    trees = ctx.traced["trees"]
    init = _lengths(ctx, lambda n: n == "qr.learn.init")
    grow = sum(_lengths(ctx, lambda n: n == "qr.grow"))
    split_waits = sum(_lengths(ctx, lambda n: n == "qr.grow.readback"))
    waits = sum(_lengths(ctx, lambda n: n.startswith("qr.") and n.endswith(".readback")))
    want = {
        "learn_init_s.train": sum(init) * 1e-9 / len(init),
        # no program span opens inside the lambda pass
        "lambdas_ms_per_tree": sum(_lengths(ctx, lambda n: n == "qr.boost.lambdas"))
        * 1e-6 / trees,
        "grow_ms_per_tree": (grow - split_waits) * 1e-6 / trees,
        "wait_ms_per_tree.train": waits * 1e-6 / trees,
        # one gap, the whole stretch, holds every grower span
        "grow_idle_ms_per_tree": grow * 1e-6 / trees,
    }
    assert len(init) == 1 and len(ctx.trace.gaps) == 1
    assert waits > 0 and grow > split_waits
    for name, value in want.items():
        got = cells.reader(name)(ctx)
        assert math.isfinite(got) and got > 0, name
        assert got == pytest.approx(value, rel=1e-12), name


def test_dispatch_reader_agrees_with_the_spans(score_ctx):
    calls = _lengths(score_ctx, lambda n: n == "qr.score.dispatch")
    assert len(calls) == score_ctx.traced["batches"]
    got = cells.reader("dispatch_us.score")(score_ctx)
    assert math.isfinite(got) and got == pytest.approx(float(np.median(calls)) * 1e-3)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_program_spans(name):
    _, tr = capture(lambda: torch.ones(64).cumsum(0).sum())
    assert not [c for c in tr.cpu if c[2].startswith("qr.")]
    read = cells.reader(name)
    assert read(types.SimpleNamespace(trace=tr, traced={"trees": 4, "batches": 4})) is None
    assert read(types.SimpleNamespace(trace=None, traced=None)) is None
