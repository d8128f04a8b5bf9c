#!/usr/bin/env python3
"""The growers' split scan, node statistics and XLA-order sums
(``csrc/split_scan.cu``, ``ops/kernel_split.py``) on one CUDA card, at the
shapes the training path gives them: each held bit for bit against its plain
version (the Python loops, on the same card tensors), then timed.

For each case: ms a call between CUDA events over 200 back-to-back calls
(the host's enqueue bounds it when the kernel is shorter), the host's ms to
enqueue a call, each kernel's device microseconds a launch from
``torch.profiler``, the plain version's ms a call, and the bound: the bytes
the function needs (each input value it reads once, each output once) over
3.35 TB/s, beside its float32 operations over 67 TFLOP/s.

Run from the repository root:
    python scripts/profile_torch_split_scan.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_split_scan: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from quickrank_tpu_torch.ops import histogram, kernel_split
    from quickrank_tpu_torch.trees import grow

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def hist(k, F, B, C=3):
        cnt = torch.randint(0, 40, (k, F, B), generator=gen, device=dev).float()
        g = torch.randn((k, F, B), generator=gen, device=dev) * cnt
        return torch.stack([cnt, g, g * g][:C], dim=-1).contiguous()

    def plain_node_stats(h, dv, start, count):
        dv[start:start + count] = grow._deviance(*grow._node_stats(h[start:start + count]))

    cases = []
    for k, B in ((1, 256), (4, 256), (1, 16384)):
        h = hist(k, 160, B)
        m = torch.ones((k, 160), dtype=torch.bool, device=dev)
        cases.append((f"split_scan [{k}, 160, {B}, 3]",
                      lambda h=h, m=m: kernel_split.split_scan(h, m, 1),
                      lambda h=h, m=m: grow._best_splits_plain(h, m, 1),
                      k * 160 * B * 2 * 4 + k * 160 + k * 21, k * 160 * B * 11))
    for B in (256, 16384):
        h = hist(3, 160, B)
        dv, dv2 = torch.zeros(3, device=dev), torch.zeros(3, device=dev)
        cases.append((f"node_stats 2 nodes of [160, {B}, 3]",
                      lambda h=h, dv=dv: (kernel_split.node_stats(h, dv, 1, 2), dv)[1],
                      lambda h=h, dv=dv2: (plain_node_stats(h, dv, 1, 2), dv)[1],
                      2 * B * 3 * 4 + 2 * 4, 2 * (3 * B + 4)))
    for shape, dim in (((8, 160, 256, 2), 2), ((1, 160, 16384, 3), 2)):
        x = torch.randn(shape, generator=gen, device=dev)
        n = x.numel()
        cases.append((f"prefix_sum {list(shape)} dim {dim}",
                      lambda x=x, d=dim: kernel_split.prefix_sum(x, d),
                      lambda x=x, d=dim: histogram._prefix_sum_loops(x, d), 2 * n * 4, n))
    for shape in ((160, 256, 8), (2, 2558976)):
        x = torch.randn(shape, generator=gen, device=dev)
        n = x.numel()
        cases.append((f"tree_sum {list(shape)}", lambda x=x: kernel_split.tree_sum(x),
                      lambda x=x: histogram._tree_sum_loops(x),
                      (n + n // shape[-1]) * 4, n))

    report = {"card": card, "cases": {}}
    for label, kernel, plain, nbytes, ops in cases:
        got, want = kernel(), plain()
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        same = all(a.dtype == b.dtype and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
                   for a, b in zip(got, want))
        if not same:
            print(f"{label}: differs from its plain version", file=sys.stderr)
            return 1
        row = {"bitwise_plain": True, **time_calls(torch, kernel),
               "plain_ms_per_call": round(time_plain(torch, plain), 4),
               "bound_us": round(max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e6, 4),
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
               else "ops"}
        report["cases"][label] = row
        print(f"{label}: {row}")
    print(json.dumps(report))
    return 0


def time_calls(torch, fn, reps=200):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key[:48]: round(e.device_time_total / e.count, 2)
               for e in prof.key_averages() if e.device_time_total > 0}
    return {"events_ms_per_call": round(start.elapsed_time(stop) / reps, 4),
            "host_enqueue_ms_per_call": round(enqueue, 4), "device_us_per_launch": kernels}


def time_plain(torch, fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


if __name__ == "__main__":
    sys.exit(main())
