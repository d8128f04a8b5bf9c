"""Least times of the program's kernels and of a training step, from their
shapes, at the published peaks of ``peaks.json``: the larger of the bytes
that must move (each input read once, each output written once) over the
memory bandwidth, and the operations over the float32 rate."""

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def least_seconds(bytes_moved: float, operations: float) -> float:
    p = peaks()
    return max(bytes_moved / p["hbm_bytes_per_s"], operations / p["fp32_flops_per_s"])
