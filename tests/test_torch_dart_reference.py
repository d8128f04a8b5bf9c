"""The benchmark's plain DART reference (``benchmark/reference/dart.py``)
against the port's ``Dart`` on the CPU, on the benchmark's own draws
(``benchmark/harness/draws.py``) at 60 queries and 14 trees of 16 leaves:
every iteration from the sixth drops a tree.

Two runs of DART agree only as far as their rounding breaks the same ties.
Once a dropped tree leaves the scores, docs whose kept trees sum to the same
score tie a last bit apart, their rank order follows those bits, and the
lambdas with it (ROADMAP §C, "DART's runs agree only until the first
drop").  So the outputs are compared up to the *horizon*: the first
iteration at which the reference's own float32 and float64 runs part.
Before it the port, in float32, must agree with the float64 reference as a
float32 run can; the case's draws are chosen so that the horizon lies past
two iterations with a drop, and the test says so."""

import numpy as np
import pytest
import torch

from benchmark.harness import draws
from benchmark.reference import dart as ref_dart, letor, trees as ref_trees
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning.dart import Dart
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.metrics import Ndcg

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

QUERIES, NTREES, LEAVES = 60, 14, 16
SHRINKAGE, RATE_DROP = 0.1, 0.1
#: the draws' seed: the reference's float32 and float64 runs agree through
#: iteration 8 (three iterations with a drop) for both samplers
DRAWS_SEED = 3
#: tree outputs, relative to the reference's norm: float32 histograms and
#: Newton sums (~1e-6), and a split of a small node may go to a gain tied
#: within float32's rounding (~1e-5 of the output's norm)
OUT_TOL = 1e-4
#: train NDCG@10: a mean of per-query float32 values over 60 queries
NDCG_TOL = 1e-6
#: tree weights: s/(s+k) and the products of k/(k+s) in float32
WEIGHT_TOL = 1e-6
#: first drop (0-based iteration): rate_drop * 5 trees rounds up to 1
FIRST_DROP = 5


@pytest.fixture(scope="module")
def fold():
    x, labels, counts = draws.letor_fold(QUERIES, 116, 136, 11, DRAWS_SEED, 0, "cpu")
    lay = letor.Layout(counts, "cpu")
    table = letor.thresholds(x, 255)
    qids = np.repeat(np.arange(1, len(counts) + 1), counts)
    ds = Dataset.from_arrays(x.numpy(), labels.numpy(), qids)
    return dict(x=x, labels=labels, lay=lay, table=table, bins=letor.bins(x, table),
                td=TrainData.build(ds, 255, device="cpu"))


def _reference(fold, sample_type, dtype=torch.float64, fault=""):
    return ref_dart.run(fold["bins"], fold["table"], fold["labels"], fold["lay"], NTREES,
                        nleaves=LEAVES, min_leaf_support=1, shrinkage=SHRINKAGE,
                        rate_drop=RATE_DROP, skip_drop=0.0, seed=0, sample_type=sample_type,
                        dtype=dtype, fault=fault)


def _gap(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _horizon(a, b) -> int:
    """The first iteration at which two runs' trees or NDCG part."""
    for i, (oa, ob) in enumerate(zip(a["out"], b["out"])):
        if _gap(oa, ob) > OUT_TOL or abs(a["ndcg"][i] - b["ndcg"][i]) > NDCG_TOL:
            return i
    return len(a["out"])


_CASES: dict = {}


def _case(fold, st):
    """The port's run and the reference's of sampler ``st``, once a module."""
    if st not in _CASES:
        _CASES[st] = _run(fold, st)
    return _CASES[st]


@pytest.fixture(scope="module", params=["UNIFORM", "CONTR"])
def case(request, fold):
    return _case(fold, request.param)


@pytest.fixture(scope="module")
def uniform(fold):
    return _case(fold, "UNIFORM")


def _run(fold, st):
    model = Dart(ntrees=NTREES, nleaves=LEAVES, nthresholds=255, shrinkage=SHRINKAGE,
                 minleafsupport=1, esr=0, seed=0, sample_type=st, normalize_type="TREE",
                 adaptive_type="FIXED", rate_drop=RATE_DROP, skip_drop=0.0)
    model.learn(fold["td"], None, Ndcg(10), verbose=False, device="cpu")
    h = model.ensemble.numpy()
    trees = [{k: h[k][t] for k in ("feature", "threshold", "left", "right", "is_leaf",
                                    "leaf_value")} for t in range(h["num_trees"])]
    ref = _reference(fold, st)
    return dict(sample_type=st, model=model, weights=h["weight"][:h["num_trees"]],
                out=[ref_trees.tree_output(fold["x"], t) for t in trees], ref=ref,
                horizon=_horizon(_reference(fold, st, torch.float32), ref))


def _agrees(case, got_ndcg, got_out, ref) -> bool:
    """Whether the outputs and NDCG agree with ``ref`` up to the horizon."""
    return all(abs(got_ndcg[i] - ref["ndcg"][i]) <= NDCG_TOL
               and (i >= len(got_out) or _gap(got_out[i], ref["out"][i]) <= OUT_TOL)
               for i in range(case["horizon"]))


def test_horizon_lies_past_two_drops(case):
    assert case["horizon"] >= FIRST_DROP + 2
    assert all(case["ref"]["dropped"][i] for i in range(FIRST_DROP, NTREES))


def test_dropped_sets_are_equal(case):
    """UNIFORM draws from the generator and the model's size alone: every
    iteration's set is the reference's.  CONTR draws by contribution, equal
    up to the horizon (past it the trees, and so the contributions, part)."""
    got, want = case["model"].history["dropped"], case["ref"]["dropped"]
    upto = NTREES if case["sample_type"] == "UNIFORM" else case["horizon"]
    assert len(got) == NTREES and got[:upto] == want[:upto]


def test_ndcg_and_tree_outputs_agree_up_to_the_horizon(case):
    hist = case["model"].history["train"]
    assert len(case["out"]) >= case["horizon"]
    assert _agrees(case, hist, case["out"], case["ref"])


def test_weights_follow_the_tree_normalization(uniform):
    """The kept trees' final weights: the reference's, after the best
    iteration (UNIFORM's schedule needs no tree; CONTR's sets, and so its
    weights, part past the horizon)."""
    case = uniform
    model = case["model"]
    _, want = ref_dart.schedule(model.best_iteration, RATE_DROP, 0.0, 0, SHRINKAGE)
    assert len(case["weights"]) == model.best_iteration
    np.testing.assert_allclose(case["weights"], want, rtol=WEIGHT_TOL)


def test_planted_undropped_fault_fails(uniform, fold):
    """The reference with the dropped trees left in the scores (the delta
    left out) in the port's place fails the comparison."""
    case = uniform
    bad = _reference(fold, "UNIFORM", torch.float32, "undropped")
    assert _agrees(case, case["model"].history["train"], case["out"], case["ref"])
    assert not _agrees(case, bad["ndcg"], bad["out"], case["ref"])
