"""The port's spans (``utils/profiling.py::span``) on the CPU: where the
boosting loop, the growers and the scorer dispatch open them, how they nest,
that every read of the device by the loop sits in a ``*.readback`` span, and
that tracing changes no output bit.  With no profiler running, ``span`` is
one shared no-op context."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quickrank_tpu_torch.data.synthetic import make_train_valid_test
from quickrank_tpu_torch.learning import LambdaMart, ObliviousLambdaMart
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.trees import grow
from quickrank_tpu_torch.utils import profiling

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

NTREES = 3
#: learner, and the level spans a tree (the level-wise growers open one a level)
CASES = {
    "best": (lambda: LambdaMart(ntrees=NTREES, nleaves=8, seed=1), 0),
    "bestk": (lambda: LambdaMart(ntrees=NTREES, nleaves=8, seed=1, growth="bestk"), 0),
    "cluster": (lambda: LambdaMart(ntrees=NTREES, nleaves=8, seed=1, cluster="on"), 0),
    "level": (lambda: LambdaMart(ntrees=NTREES, nleaves=8, seed=1, growth="level",
                                 max_depth=3), 3),
    "oblivious": (lambda: ObliviousLambdaMart(ntrees=NTREES, treedepth=4, seed=1), 4),
}
#: the best-first growers read each split (or round) back to the host
READS_SPLITS = {"best", "bestk", "cluster"}


def _spans(prof):
    """Host events of a profile as (start, end, name), in start order."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU)


def _inside(outer, events):
    s, e, _ = outer
    return [x for x in events if s <= x[0] and x[1] <= e and x is not outer]


def _named(events, name):
    return [x for x in events if x[2] == name]


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(30, 10, 10))


@pytest.fixture(scope="module", params=list(CASES))
def run(request, folds):
    """One untraced and one traced ``learn`` of the case's learner, on a
    train fold prepared once (as a user who trains model after model)."""
    train, valid, _ = folds
    td = TrainData.build(train, 255, device="cpu")
    make, levels = CASES[request.param]
    plain = make()
    plain.learn(td, valid, Ndcg(10), verbose=False, device="cpu")
    traced = make()
    syncs0 = grow.HOST_SYNCS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced.learn(td, valid, Ndcg(10), verbose=False, device="cpu")
    return dict(case=request.param, levels=levels, plain=plain, traced=traced,
                syncs=grow.HOST_SYNCS - syncs0, events=_spans(prof))


def test_learn_spans_nest(run):
    ev = run["events"]
    init = _named(ev, "qr.learn.init")
    assert len(init) == 1
    assert len(_named(_inside(init[0], ev), "qr.data.build")) == 1  # the valid fold
    iters = _named(ev, "qr.boost.iter")
    assert len(iters) == NTREES == len(run["traced"].history["train"])
    for it in iters:
        inner = _inside(it, ev)
        for name in ("qr.boost.lambdas", "qr.grow", "qr.boost.metrics"):
            assert len(_named(inner, name)) == 1, name
        assert len(_named(inner, "qr.grow.level")) == run["levels"]
    readbacks = _named(ev, "qr.grow.readback")
    assert len(readbacks) == run["syncs"]
    assert (run["syncs"] > 0) == (run["case"] in READS_SPLITS)
    assert not _named(ev, "qr.score.dispatch")


def test_device_reads_sit_in_readback_spans(run):
    """Every read of a tensor's value by the boosting loop (``item``, the
    ``_local_scalar_dense`` under it) lies inside a ``*.readback`` span."""
    ev = run["events"]
    reads = [x for x in ev if x[2].endswith(".readback")]
    for it in _named(ev, "qr.boost.iter"):
        for x in _named(_inside(it, ev), "aten::_local_scalar_dense"):
            assert any(r[0] <= x[0] and x[1] <= r[1] for r in reads), x


def test_traced_learn_is_bitwise_untraced(run):
    a, b = run["plain"], run["traced"]
    ha, hb = a.ensemble.numpy(), b.ensemble.numpy()
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    assert a.history["train"] == b.history["train"]
    assert a.history["valid"] == b.history["valid"]
    assert torch.equal(a.train_scores, b.train_scores)


def test_each_scorer_call_opens_one_dispatch_span(run, folds):
    model = run["traced"]
    fn, X = model.device_scorer(folds[2], device="cpu")
    want = fn(X)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [fn(X) for _ in range(3)]
    assert len(_named(_spans(prof), "qr.score.dispatch")) == 3
    assert all(torch.equal(g, want) for g in got)


def test_span_without_a_profiler_is_the_shared_no_op():
    a, b = profiling.span("qr.x"), profiling.span("qr.y")
    assert a is b is profiling._OFF
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("qr.x") is not profiling._OFF
    assert profiling.span("qr.x") is profiling._OFF
