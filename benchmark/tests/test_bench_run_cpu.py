"""A run of every cell at a tiny size on the CPU (the program's plain
versions): a well-formed result, correct against the reference, and no
device-sourced metric; ``run.py`` itself refuses to run without a card."""

import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT, SCORE, SEED, TRAIN, tiny

from benchmark.harness import runner


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", TRAIN + SCORE)
def test_tiny_run_is_well_formed(name, trace):
    c = tiny(name)
    r = runner.run(c, SEED, 0.3, bool(trace), "cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    json.dumps(r)
    wanted = c.per_layer if trace else c.end_to_end
    sources = {m["name"]: m["source"] for m in wanted}
    for name_, m in r["metrics"].items():
        assert name_ in sources and sources[name_] != "device_trace"
        assert m["value"] > 0 or name_ == "host_syncs_per_tree"
    assert not any("mfu" in k or "roofline" in k for k in r["metrics"])
    if not trace:
        assert "setup_s" in r["metrics"]
    assert set(r["checks"]) == set(c.limits)


def test_same_seed_same_inputs():
    a, b = tiny(TRAIN[0]).loop(SEED, "cpu"), tiny(TRAIN[0]).loop(SEED, "cpu")
    a.draw()
    b.draw()
    assert (a.x == b.x).all() and (a.labels == b.labels).all()
    c = tiny(TRAIN[0]).loop(SEED + 1, "cpu")
    c.draw()
    assert sorted(c.counts) == sorted(a.counts) and not (c.x[:10] == a.x[:10]).all()


def test_run_py_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", SCORE[0],
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
