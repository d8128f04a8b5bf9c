"""The DART cell (``train.dart-best16.mslr30k``) at a tiny size on the CPU:
well-formed and correct runs, traced and not; its check failing on the
controls and on faults planted in the program; its readers against the
spans and counters they read; and its rooflines against counts worked by
hand.  No number here is a device number."""

import copy
import math
import re
import types

import pytest
import torch
from conftest import SEED

from benchmark.harness import cell as cells, runner
from benchmark.harness.trace import capture
from benchmark.metrics import _spans
from benchmark.roofline import dart_step, k1_delta, train_step
from quickrank_tpu_torch.learning import dart

NAME = "train.dart-best16.mslr30k"
#: 16 trees: iterations 6 to 15 drop one tree, the 16th two
TREES = 16


def tiny() -> cells.Cell:
    c = cells.Cell(NAME)
    c.config = copy.deepcopy(c.config)
    c.config["data"].update(train_queries=60, valid_queries=20)
    c.config["ntrees"] = TREES
    return c


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not numbers[k] <= lim for k, lim in limits.items())


@pytest.fixture(scope="module")
def traced_run():
    """A tiny traced run, and the counters' steps over it."""
    d0 = dart.DROPPED
    r = runner.run(tiny(), SEED, 0.1, True, "cpu")
    return r, dart.DROPPED - d0


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_well_formed_and_correct(trace, traced_run):
    c = tiny()
    r = traced_run[0] if trace else runner.run(c, SEED, 0.1, False, "cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == {"ndcg_gap", "grad_gap", "change_gap", "delta_gap", "drop_gap"}
    assert r["checks"]["drop_gap"]["value"] == 0.0
    wanted = {m["name"]: m["source"] for m in (c.per_layer if trace else c.end_to_end)}
    got = set(r["metrics"])
    assert got <= set(wanted)
    # every metric but the device's (none is read on the CPU) and the card's mfu
    assert got == {n for n, s in wanted.items() if s != "device_trace" and "mfu" not in n}
    if trace:
        assert r["metrics"]["drops_per_tree.dart"]["value"] == 12 / TREES


def test_drops_are_the_programs_counter(traced_run):
    """The window's drops, read from the jobs' histories, are what
    ``dart.DROPPED`` counts: the warm-up job, the window's and the traced."""
    r, counted = traced_run
    warmup = sum(math.floor(0.1 * t + 0.5) for t in range(8))  # 8 trees, T = 0..7
    window = r["metrics"]["drops_per_tree.dart"]["value"] * TREES
    assert counted == warmup + 2 * window  # the window's job and the traced job


def test_controls_fail():
    c = tiny()
    for seed in (SEED, SEED + 1, SEED + 2):
        loop = c.loop(seed, "cpu")
        loop.draw()
        assert _fails(loop.control(torch.bfloat16), c.limits)
    loop = c.loop(SEED, "cpu")
    loop.draw()
    sound = loop.control(torch.float64)
    assert not _fails(sound, c.limits) and sound["drop_gap"] == 0.0
    for fault in ("half", "altered", "unchanged", "undropped"):
        assert _fails(loop.control(torch.float32, fault), c.limits), fault


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_delta_gap_alone_holds_the_delta(offset):
    """``delta_gap`` passes the reference in float32 and fails it with the
    dropped trees left in the scores, which no other number catches here."""
    c = tiny()
    loop = c.loop(SEED + offset, "cpu")
    loop.draw()
    limits = dict(c.limits)
    limit = limits.pop("delta_gap")
    assert loop.control(torch.float32)["delta_gap"] <= limit
    undropped = loop.control(torch.float32, "undropped")
    assert undropped["delta_gap"] > limit and not _fails(undropped, limits)


def test_program_without_the_delta_fails(monkeypatch):
    """The dropped trees left in the scores by the program itself."""
    real = dart.DropTable.delta

    def zero(self, *a, **kw):
        return torch.zeros_like(real(self, *a, **kw))

    monkeypatch.setattr(dart.DropTable, "delta", zero)
    assert runner.run(tiny(), SEED, 0.1, False, "cpu")["correct"] is False


def test_program_dropping_other_trees_fails(monkeypatch):
    real = dart.Dart._select_dropout

    def shifted(self, rng, weights, *a, **kw):
        return [(t + 1) % len(weights) for t in real(self, rng, weights, *a, **kw)]

    monkeypatch.setattr(dart.Dart, "_select_dropout", shifted)
    r = runner.run(tiny(), SEED, 0.1, False, "cpu")
    assert r["correct"] is False and r["checks"]["drop_gap"]["value"] >= 1


def test_dart_reader_agrees_with_the_spans():
    loop = tiny().loop(SEED, "cpu")
    loop.setup()
    traced, tr = capture(loop.traced)
    ctx = types.SimpleNamespace(trace=tr, traced=traced)
    every = _spans.spans(ctx)
    own = [s for s in every if s[2].startswith("qr.dart.")]
    names = {s[2] for s in own}
    assert {"qr.dart.drop", "qr.dart.restore", "qr.dart.compact"} <= names
    inner = _spans.inside(own, every)
    assert inner and all(s[2].startswith("qr.") for s in inner)
    want = (_spans.total_ns(own) - _spans.overlap_ns(own, inner)) * 1e-6 / TREES
    got = cells.reader("dart_ms_per_tree")(ctx)
    assert traced["trees"] == TREES and len(traced["drop_counts"]) == TREES
    assert math.isfinite(got) and got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["dart_ms_per_tree", "k1_delta_roofline"])
def test_readers_find_nothing_without_their_spans_or_kernels(name):
    _, tr = capture(lambda: torch.ones(64).cumsum(0).sum())
    read = cells.reader(name)
    work = dict(docs=100, valid_docs=10, features=136, leaves=16)
    traced = {"trees": 4, "drop_counts": [0, 1, 1, 2], "rescored": []}
    assert read(types.SimpleNamespace(trace=tr, traced=traced, work=work)) is None
    assert read(types.SimpleNamespace(trace=None, traced=None, work=work)) is None


class _Kernels:
    """A trace's device intervals, for the kernel readers."""

    def __init__(self, launches):
        self.launches = launches

    def kernel_seconds(self, pattern):
        return sum(s for n, s in self.launches if re.search(pattern, n))


def test_k1_delta_reader_takes_the_u8_scoring_launches():
    names = {"void (anonymous namespace)::qs_score_kernel<unsigned char, true, false>(x)": 1e-3,
             "void (anonymous namespace)::qs_score_wide_kernel<unsigned char, false, false>(x)":
                 1e-3,
             "void (anonymous namespace)::qs_score_kernel<float, true, false>(x)": 5.0,
             "void (anonymous namespace)::qs_score_kernel<unsigned char, true, true>(x)": 5.0,
             "void histogram_kernel<unsigned char, 3>(x)": 5.0}
    work = dict(docs=2558169, valid_docs=731000, features=136, leaves=16)
    traced = {"trees": 3, "drop_counts": [0, 1, 2], "rescored": [3]}
    ctx = types.SimpleNamespace(trace=_Kernels(names.items()), traced=traced, work=work)
    least = k1_delta.job_seconds(2558169, 731000, 136, 16, [0, 1, 2], [3])
    assert cells.reader("k1_delta_roofline")(ctx) == pytest.approx(100 * least / 2e-3)


def test_k1_delta_bound_by_hand():
    # 2,558,169 docs x 136 u8 ids read, 4-byte scores written, 25 trees of
    # 15 {feature, threshold} records and 16 leaf values: 358.1 MB, 0.1069
    # ms at 3.35 TB/s; 2,558,169 x 25 x (4 + 4) operations: 0.0076 ms
    moved = 2558169 * 136 + 2558169 * 4 + 25 * (15 * 8 + 16 * 4)
    assert k1_delta.seconds(2558169, 136, 25, 16) == pytest.approx(moved / 3.35e12)
    assert k1_delta.seconds(2558169, 136, 25, 16) * 1e3 == pytest.approx(0.1069, abs=5e-5)
    # a million trees: the 8 operations a tree and doc bound it
    assert k1_delta.seconds(1000, 136, 10 ** 6, 16) == pytest.approx(1000 * 10 ** 6 * 8 / 6.7e13)
    assert k1_delta.delta_seconds(2558169, 731000, 136, 16, 0) == 0.0
    both = k1_delta.seconds(2558169, 136, 3, 16) + k1_delta.seconds(731000, 136, 3, 16)
    assert k1_delta.delta_seconds(2558169, 731000, 136, 16, 3) == both
    # a job: iterations with 0, 1 and 2 dropped trees, a rescore at iteration 3
    job = k1_delta.job_seconds(2558169, 731000, 136, 16, [0, 1, 2], [3])
    assert job == pytest.approx(sum(k1_delta.delta_seconds(2558169, 731000, 136, 16, k)
                                    for k in (1, 2, 3)))


def test_dart_step_by_hand():
    step = train_step.seconds(2558169, 136, int(4.06e8), 16)
    # the 500-tree job's iterations: 5 drop nothing, 10 each drop 1..49, 5 drop 50
    counts = {0: 5, **{k: 10 for k in range(1, 50)}, 50: 5}
    mean = sum(n * k1_delta.delta_seconds(2558169, 731000, 136, 16, k)
               for k, n in counts.items()) / 500
    got = dart_step.seconds(2558169, 731000, 136, int(4.06e8), 16, counts)
    assert got == pytest.approx(step + mean)
    # the delta's bytes barely grow with its trees: ~0.137 ms an iteration
    assert mean * 1e3 == pytest.approx(0.137, abs=0.003)
    assert dart_step.seconds(2558169, 731000, 136, int(4.06e8), 16, {0: 7}) == step
