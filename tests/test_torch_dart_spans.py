"""DART's spans and counters (``learning/dart.py``) on the CPU, after
``tests/test_torch_spans.py``: where ``Dart.learn`` opens the boosting
loop's spans and its own ``qr.dart.*`` ones, that every read of the device
by the loop sits in a ``*.readback`` span, that ``DROPPED`` and ``RESCORES``
count what the history records, and that tracing changes no output bit."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quickrank_tpu_torch.data.synthetic import make_train_valid_test
from quickrank_tpu_torch.learning import dart
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.metrics import Ndcg

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

NTREES = 13
#: learner options, and whether the run has a valid fold; without one the
#: train metric improves and an iteration past the 11th rescores
CASES = {
    "uniform": (dict(), False),
    "uniform_valid": (dict(), True),
    "contr": (dict(sample_type="CONTR", normalize_type="CONTR"), False),
    "keep_linesearch": (dict(keep_drop=True, normalize_type="LINESEARCH"), True),
}
#: the iteration's own spans, one each
ONCE = ("qr.dart.drop", "qr.dart.restore", "qr.boost.lambdas", "qr.grow", "qr.dart.compact")


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
    """One untraced and one traced ``learn`` of the case's learner on a
    train fold prepared once, and the counters' steps over the traced one."""
    train, valid, _ = folds
    td = TrainData.build(train, 255, device="cpu")
    kw, with_valid = CASES[request.param]

    def make():
        return dart.Dart(ntrees=NTREES, nleaves=8, seed=1, esr=0, rate_drop=0.2, **kw)

    va = valid if with_valid else None
    plain = make()
    plain.learn(td, va, Ndcg(10), verbose=False, device="cpu")
    traced = make()
    dropped0, rescores0 = dart.DROPPED, dart.RESCORES
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced.learn(td, va, Ndcg(10), verbose=False, device="cpu")
    return dict(case=request.param, valid=with_valid, plain=plain, traced=traced,
                dropped=dart.DROPPED - dropped0, rescores=dart.RESCORES - rescores0,
                events=_spans(prof))


def test_learn_spans_nest(run):
    ev, h = run["events"], run["traced"].history
    init = _named(ev, "qr.learn.init")
    assert len(init) == 1
    assert len(_named(_inside(init[0], ev), "qr.data.build")) == int(run["valid"])
    iters = _named(ev, "qr.boost.iter")
    assert len(iters) == len(h["train"]) == len(h["dropped_per_iter"])
    for it in iters:
        inner = _inside(it, ev)
        for name in ONCE:
            assert len(_named(inner, name)) <= 1, name
        for name in ONCE[:-1]:
            assert len(_named(inner, name)) == 1, name
        assert _named(inner, "qr.boost.metrics") and _named(inner, "qr.boost.readback")
    # a compaction whenever the best model improved, a rescore when it rescored
    assert len(_named(ev, "qr.dart.rescore")) == len(h["rescored"]) == run["rescores"]
    assert not _named(ev, "qr.score.dispatch")


def test_counters_follow_the_history(run):
    h = run["traced"].history
    assert run["dropped"] == sum(h["dropped_per_iter"]) > 0
    assert run["rescores"] == len(h["rescored"])
    assert run["rescores"] > 0 or run["valid"]


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
    np.testing.assert_array_equal(a.history["train"], b.history["train"])
    np.testing.assert_array_equal(a.history["valid"], b.history["valid"])  # nan: no fold
    for k in ("best_iteration", "dropped_per_iter", "dropped", "rescored"):
        assert a.history[k] == b.history[k], k
