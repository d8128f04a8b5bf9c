"""The roofline arithmetic against the bounds of PERF.md's kernel table."""

import numpy as np
import pytest

from benchmark.roofline import k1, k3, k4, peaks, train_step


def test_peaks():
    p = peaks()
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["fp32_flops_per_s"] == 6.7e13


def test_k3_headline_bound():
    # 131,072 x 136 float32 features read once: 0.0215 ms, bytes-bound
    assert k3.seconds(131072, 136, 1000, 4) * 1e3 == pytest.approx(0.0215, abs=5e-5)


def test_k1_bound_is_bytes_at_16_leaves():
    depths = np.full(1000, 5.0)
    assert k1.seconds(131072, 136, 1000, 16, depths) * 1e3 == pytest.approx(0.0215, abs=5e-5)
    deep = np.full(1000, 60.0)  # operations take over past ~11 levels
    assert k1.seconds(131072, 136, 1000, 16, deep) > k1.seconds(131072, 136, 1000, 16, depths)


def test_k4_pass_and_tree():
    one = k4.seconds(2558169, 136, 256, 1)
    assert one * 1e3 == pytest.approx((2558169 * 136 + 2558169 * 8 + 136 * 256 * 2 * 8)
                                      / 3.35e12 * 1e3)
    assert k4.tree_seconds(2558169, 136, 256, 4) * 1e3 == pytest.approx(0.45, abs=0.02)


def test_train_step_is_mostly_histogram_passes():
    s = train_step.seconds(2558169, 136, int(4.06e8), 16)
    assert 0.4e-3 < s < 0.6e-3
