#!/usr/bin/env python3
"""K4 and K5 at wide bin axes on one CUDA card: this tree's launch, the
wide-bin path where the launch takes the block path, another checkout's
kernel and one ``index_add_``, timed in turns on the same inputs in one
process.

The inputs are those of ``chip_smoke.py`` phase 42: MSLR-shaped synthetic
data (19,000 queries, 2,558,976 padded rows x 160 columns), binned on the
card at 1,023, 2,047, 4,095, 16,383, 32,767 and 65,535 thresholds (the
u16 wire), doc
channels (1, g, g^2) of a random gradient under the doc mask (K4, C = 3: the
root pass, k = 1; four slots, k = 4; and a node of a sixteenth of the docs,
k = 1, as best-first growth asks for deeper in a tree) and (g, u) over every
row (K5, C = 2).  Every candidate's int64 sums are held bit for bit against
``kernel_histogram.node_histogram_fixed_int`` before any timing.

Timed (ms a call between CUDA events, the mean of two passes over the
candidates, the second in reverse order): this tree's launch
(``node_histogram_int`` / ``histogram_int``: the block path, or the
wide-bin path past one block's shared memory), as "launch"; where the
launch takes the block path, ``csrc/histogram_wide.cu`` built alone and
called on the same inputs, as "wide" (the switch point between the two);
with ``--parent DIR``, ``csrc/histogram.cu`` of the checkout at DIR (for
example the parent commit, ``git archive`` unpacked under ``local/``),
built alone and called through its ``histogram_launch``, as "parent"; and
``torch.zeros(W * B, C).index_add_(0, flat, values)``, the flat (feature,
bin) index of every (doc, feature) given.

Run from the repository root (about five minutes on an H100):
    python scripts/profile_torch_wide_bins.py [--parent local/parent]
        [--bins 1023,4095,16383] [--out wide_bins.json]
It prints one JSON object last, and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ms(fn, reps, warm=1):
    """Mean ms a call between CUDA events, after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


#: an entry point with histogram_launch's arguments that always takes the
#: wide-bin path (the launch clears acc first, as histogram_launch does)
WIDE_ENTRY = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "histogram.cuh"
extern "C" int histogram_wide_only(const void* binned, int bin_bytes, int64_t n,
                                   int64_t width, int features, const float* values,
                                   int channels, int64_t stride_c, int64_t stride_n,
                                   const int32_t* pos, int n0, int k, int num_bins,
                                   const unsigned int* maxbits, int64_t n_scale,
                                   unsigned long long* acc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cells = static_cast<size_t>(features) * num_bins * k * channels;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * cells, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(qr::histogram_wide_launch(
      binned, bin_bytes, n, width, features, values, channels, stride_c, stride_n, pos, n0,
      k, num_bins, maxbits, n_scale, acc, s));
}
"""


def build_libraries(parent, out_dir):
    """name -> the entry point (histogram_launch's arguments) of the
    libraries built from ``csrc/histogram_wide.cu`` alone (``wide``) and from
    the parent's ``histogram.cu`` alone; the nvcc processes started
    together."""
    from quickrank_tpu_torch.ops import _cuda

    nvcc = _cuda.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    os.makedirs(out_dir, exist_ok=True)
    entry = os.path.join(out_dir, "wide_entry.cu")
    with open(entry, "w") as f:
        f.write(WIDE_ENTRY)
    # name -> (sources, entry point with histogram_launch's arguments)
    jobs = {"wide": ([entry, os.path.join(_cuda.CSRC, "histogram_wide.cu")],
                     "histogram_wide_only")}
    if parent:
        jobs["parent"] = ([os.path.join(parent, "quickrank_tpu_torch", "csrc", "histogram.cu")],
                          "histogram_launch")
    procs = {}
    for name, (srcs, _) in jobs.items():
        out = os.path.join(out_dir, f"libhist_{name}.so")
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-o", out, *srcs]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = getattr(ctypes.CDLL(out), jobs[name][1])
        fn.argtypes = _cuda.SIGNATURES["histogram_launch"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def raw_launch(fn, binned, values, stride_c, stride_n, pos, k, num_bins, channels, maxbits,
               n_scale):
    """One launch of a separately built library's entry point, which takes
    histogram_launch's arguments: int64 [W, B, k*C]."""
    import torch

    N, W = binned.shape
    acc = torch.empty((W, num_bins, k * channels), dtype=torch.int64, device=binned.device)
    args = (binned.data_ptr(), binned.element_size(), N, W, W, values.data_ptr(), channels,
            stride_c, stride_n, pos.data_ptr() if pos is not None else None, 0, k, num_bins,
            maxbits.data_ptr(), int(n_scale), acc.data_ptr())
    stream = torch.cuda.current_stream(binned.device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"histogram launch failed: CUDA error {rc}")
    return acc


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--parent", default="", help="checkout whose csrc/histogram.cu is timed too")
    p.add_argument("--bins", default="1023,2047,4095,16383,32767,65535",
                   help="thresholds of each wire")
    p.add_argument("--queries", type=int, default=19000)
    p.add_argument("--out", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_wide_bins: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.ops import _cuda, binning, kernel_histogram as kh
    from quickrank_tpu_torch.ops.histogram import doc_channels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    log = _cuda.build(force=True)
    _cuda.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    wide_entry = False  # ptxas's lines of the wide-bin kernels
    for line in log.splitlines():
        if "Compiling entry function" in line:
            wide_entry = "histogram_wide" in line
            if wide_entry:
                print("  ptxas:", line.split("'")[1])
        elif wide_entry and ("registers" in line or "spill" in line):
            print("  ptxas:  ", line.strip())
    t0 = time.perf_counter()
    libs = build_libraries(os.path.abspath(args.parent) if args.parent else "",
                           os.path.join(_cuda.BUILD_DIR, "wide_bins"))
    print(f"separate builds: {time.perf_counter() - t0:.1f} s ({sorted(libs)})")

    ds = make_ranking_dataset(num_queries=args.queries, seed=11)
    gen = torch.Generator(device="cpu").manual_seed(5)
    report = {"card": card, "rows": {}}
    inputs = None
    for nthr in (int(x) for x in args.bins.split(",")):
        t0 = time.perf_counter()
        td = TrainData.build(ds, nthr, device=dev)
        bw, B = td.step.binned, td.num_bins
        N, W = bw.shape
        if inputs is None:
            g = torch.randn(N, generator=gen).to(dev)
            vt = doc_channels(g, td.step.doc_mask).T.contiguous()
            pos_root = torch.where(td.step.doc_mask, 0, 1).to(torch.int32)
            pos4 = torch.randint(0, 4, (N,), generator=gen, dtype=torch.int32).to(dev)
            vals = torch.stack([g, torch.rand(N, generator=gen).to(dev)], dim=-1).contiguous()
            rows = td.step.doc_mask.nonzero()[:, 0]
            small = (torch.rand(N, generator=gen) < 1 / 16).to(dev) & td.step.doc_mask
            pos16 = torch.where(small, 0, 1).to(torch.int32)
            inputs = (vt, pos_root, pos4, vals, rows, pos16)
        vt, pos_root, pos4, vals, rows, pos16 = inputs
        bits3, bits2 = kh.channel_max_bits(vt), kh.channel_max_bits(vals.T)
        past = kh.past_shared_memory(3, B)
        plan3, plan2 = kh.wide_plan(3, B), kh.wide_plan(2, B)
        print(f"{B} bins on the {bw.dtype} wire, {N} x {W} (binning "
              f"{time.perf_counter() - t0:.1f} s); past shared memory (the wide-bin path "
              f"by itself): C=3 {past}, C=2 {kh.past_shared_memory(2, B)}; wide-bin plan C=3 "
              f"{plan3}, C=2 {plan2}")

        # every candidate: (K4 root, K4 k=4, K5, K4 small node) launches
        cands = {"launch": (
            lambda: kh.node_histogram_int(bw, vt, pos_root, B, 0, 1, bits3, N),
            lambda: kh.node_histogram_int(bw, vt, pos4, B, 0, 4, bits3, N),
            lambda: kh.histogram_int(bw, vals, B, bits2, N),
            lambda: kh.node_histogram_int(bw, vt, pos16, B, 0, 1, bits3, N))}
        for name, entry in libs.items():
            if name == "wide" and past:
                continue  # the launch itself takes the wide-bin path
            cands[name] = (
                lambda e=entry: raw_launch(e, bw, vt, N, 1, pos_root, 1, B, 3, bits3, N),
                lambda e=entry: raw_launch(e, bw, vt, N, 1, pos4, 4, B, 3, bits3, N),
                lambda e=entry: raw_launch(e, bw, vals, 1, 2, None, 1, B, 2, bits2, N),
                lambda e=entry: raw_launch(e, bw, vt, N, 1, pos16, 1, B, 3, bits3, N))
        want = (kh.node_histogram_fixed_int(bw, vt, pos_root, B, 0, 1, bits3, N),
                kh.node_histogram_fixed_int(bw, vt, pos4, B, 0, 4, bits3, N),
                kh.node_histogram_fixed_int(bw, vals.T.contiguous(), None, B, 0, 1, bits2, N),
                kh.node_histogram_fixed_int(bw, vt, pos16, B, 0, 1, bits3, N))
        for name, fns in cands.items():
            for what, fn, w in zip(("K4 root", "K4 k=4", "K5", "K4 small node"), fns, want):
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, w):
                    raise RuntimeError(f"{name} {what} at {B} bins differs from "
                                       "node_histogram_fixed_int")
        del want
        print(f"  bitwise node_histogram_fixed_int: {sorted(cands)}")

        slow = B > 8192
        times = {name: [[], [], [], []] for name in cands}
        order = list(cands)
        for sweep in (order, order[::-1]):
            for name in sweep:
                for j, fn in enumerate(cands[name]):
                    times[name][j].append(time_ms(fn, reps=5 if slow else 20))
        ms = {name: [sum(t) / len(t) for t in ts] for name, ts in times.items()}
        flat = (torch.arange(W, device=dev)[None, :] * B
                + binning.bin_rows(bw, rows).long()).reshape(-1)
        v4 = vt[:, rows].T[:, None, :].expand(-1, W, -1).reshape(-1, 3)
        lib4 = time_ms(lambda: torch.zeros((W * B, 3), device=dev).index_add_(0, flat, v4),
                       reps=3)
        del flat, v4
        flat = (torch.arange(W, device=dev)[None, :] * B + binning.widen(bw).long()).reshape(-1)
        v5 = vals[:, None, :].expand(-1, W, -1).reshape(-1, 2)
        lib5 = time_ms(lambda: torch.zeros((W * B, 2), device=dev).index_add_(0, flat, v5),
                       reps=3)
        del flat, v5
        for name, (a, b, c, d) in ms.items():
            print(f"  {name}: K4 root {a:.4f} ms, k=4 {b:.4f}, K5 {c:.4f}, K4 small node {d:.4f}")
        print(f"  index_add_: K4 root {lib4:.4f} ms, K5 {lib5:.4f}")
        report["rows"][B] = {"ms": ms, "passes": times, "index_add_k4": lib4,
                             "index_add_k5": lib5, "plan3": plan3.__dict__,
                             "plan2": plan2.__dict__}
        del td, bw, cands
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
