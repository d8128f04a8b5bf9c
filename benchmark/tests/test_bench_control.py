"""Each check's control and faults come out as not correct, at a size the
CPU holds: the reference in bfloat16 in the program's place, and runs of
the harness with the timed path broken underneath (the look for a card
skipped: the runner is driven on the CPU)."""

import dataclasses

import pytest
import torch
from conftest import SCORE, SEED, TRAIN, tiny

from benchmark import control
from benchmark.harness import runner
from quickrank_tpu_torch.learning import lambdamart, mart


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not numbers[k] <= lim for k, lim in limits.items())


@pytest.mark.parametrize("name", TRAIN + SCORE)
def test_bf16_control_fails(name):
    c = tiny(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        assert _fails(control.readings(c, seed, "bf16", "cpu"), c.limits)


@pytest.mark.parametrize("variant", ["half", "altered", "unchanged"])
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_in_the_reference_fail(name, variant):
    c = tiny(name)
    assert _fails(control.readings(c, SEED, variant, "cpu"), c.limits)


def _run(name):
    return runner.run(tiny(name), SEED, 0.2, False, "cpu")


@pytest.mark.parametrize("name", TRAIN)
def test_training_step_that_changes_nothing(name, monkeypatch):
    real = mart.leaf_outputs

    def frozen(tree, *a, **kw):
        out = real(tree, *a, **kw)
        return dataclasses.replace(out, leaf_value=torch.zeros_like(out.leaf_value))

    monkeypatch.setattr(mart, "leaf_outputs", frozen)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_training_half_the_batch_left_out(name, monkeypatch):
    real = lambdamart.LambdaMart._gradients

    def half(self, sd, *a, **kw):
        lam, w = real(self, sd, *a, **kw)
        keep = (sd.inv_q % 2 == 0).to(lam.dtype)
        return lam * keep, w * keep

    monkeypatch.setattr(lambdamart.LambdaMart, "_gradients", half)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_training_answer_altered(name, monkeypatch):
    real = mart.leaf_outputs

    def altered(tree, *a, **kw):
        out = real(tree, *a, **kw)
        return dataclasses.replace(out, leaf_value=out.leaf_value * 1.01)

    monkeypatch.setattr(mart, "leaf_outputs", altered)
    assert _run(name)["correct"] is False


def _broken_scorer(monkeypatch, breaks):
    real = mart.Mart.device_scorer

    def scorer(self, ds, device=None):
        fn, x = real(self, ds, device)
        return (lambda rows: breaks(fn(rows))), x

    monkeypatch.setattr(mart.Mart, "device_scorer", scorer)


@pytest.mark.parametrize("name", SCORE)
def test_scoring_half_the_batch_left_out(name, monkeypatch):
    def half(s):
        s = s.clone()
        s[s.shape[0] // 2:] = 0.0
        return s

    _broken_scorer(monkeypatch, half)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", SCORE)
def test_scoring_answer_altered(name, monkeypatch):
    def altered(s):
        # one doc's score off by one tree's weight, as if a tree were skipped
        s = s.clone()
        s[7] += 0.1
        return s

    _broken_scorer(monkeypatch, altered)
    assert _run(name)["correct"] is False


def test_unbroken_runs_are_correct():
    assert all(_run(n)["correct"] for n in (TRAIN[0], SCORE[0]))
