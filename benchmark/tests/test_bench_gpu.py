"""On the card: a short run of each scoring cell through ``run.py``, which
must print a correct, well-formed result line (skips without a card)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT, SCORE, SEED


@pytest.mark.gpu
@pytest.mark.parametrize("name", SCORE)
def test_short_run_on_the_card(name, cuda_device):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                        str(SEED), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
