#!/usr/bin/env python3
"""The bin matrix written on one CUDA card (``csrc/bin_apply.cu``,
``ops/binning.py::device_bin_wire``) against the host binner, at the shapes
of an MSLR-sized fold: 136 float32 features, query lengths in [38, 232).

For each fold size (the valid fold's ~0.85M docs and the train fold's
~2.56M by default) and thresholds count: the kernel's ms a launch between
CUDA events over 20 launches on rows already on the card, beside its bound
(each input byte read once, each output byte written once, over 3.35 TB/s)
and beside the one PyTorch call that computes the same ids (``searchsorted``,
clamped and laid out as the wire; timed, never used by the program);
the pageable upload of the rows; ``TrainData.build`` on the card with its
thresholds given (host clock, ending in a sync; the median of 3); and the
host path it replaces (``ops/binning.py::host_bin_ids`` of the padded
layout and ``bin_wire``, the build's CPU branch).  Each wire is held bit for bit against the host's.
One JSON line a case.

Run from the repository root:
    python scripts/profile_torch_binning.py [--docs 850000,2558000] [--thresholds 255,1023]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--docs", default="850000,2558000")
    p.add_argument("--thresholds", default="255,1023")
    p.add_argument("--features", type=int, default=136)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_binning: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from quickrank_tpu_torch.data.dataset import Dataset, shard_and_pad
    from quickrank_tpu_torch.learning.mart import TrainData, column_map
    from quickrank_tpu_torch.ops import binning

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    F = args.features
    rng = np.random.default_rng(5)
    for docs in (int(d) for d in args.docs.split(",")):
        counts = rng.integers(38, 232, size=docs // 135 + 1)
        counts = counts[np.cumsum(counts) <= docs]
        n = int(counts.sum())
        gen = torch.Generator(device=dev).manual_seed(docs)
        x = (torch.randn((n, F), generator=gen, device=dev)
             * torch.rand((1, F), generator=gen, device=dev) * 10).round_(decimals=2)
        ds = Dataset.from_arrays(x.cpu().numpy(), np.zeros(n, np.float32),
                                 np.repeat(np.arange(len(counts)), counts))
        del x
        for nthr in (int(t) for t in args.thresholds.split(",")):
            th, _ = binning.build_thresholds(ds.features, nthr)
            B = th.shape[1]
            padded = shard_and_pad(ds)
            n_loc = padded.num_docs_padded
            g_align = 64 if B <= 64 else 32
            f_blk = (F + g_align - 1) // g_align * g_align
            f_blk += g_align if f_blk - F < 8 else 0
            cmap = column_map(F, f_blk, None)
            t0 = time.perf_counter()
            want = torch.from_numpy(binning.bin_wire(
                binning.host_bin_ids(padded.features, th, cmap), B))
            host_s = time.perf_counter() - t0
            del padded

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xd = torch.from_numpy(ds.features).to(dev)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            thd = torch.from_numpy(th).to(dev)
            cmd = torch.from_numpy(cmap.astype(np.int32)).to(dev)
            out = torch.empty((n_loc, f_blk), dtype=want.dtype, device=dev)

            def launch():
                binning.bin_apply(xd, thd, cmd, out)

            # torch's uint16 has few kernels: the u16 wire's ids as int16
            lib_dtype = torch.int16 if want.dtype == torch.uint16 else want.dtype

            def library():
                # the one PyTorch call that computes the ids: lower_bound per
                # feature (NaN and +inf land past the table), clamped to the
                # top bin, laid out as the wire with the pad rows' bins of 0.0
                ids = torch.searchsorted(thd, xd.T.contiguous()).clamp_(max=B - 1)
                pad = torch.searchsorted(thd, torch.zeros((F, 1), device=dev)).clamp_(max=B - 1)
                lib_out = torch.zeros((n_loc, f_blk), dtype=lib_dtype, device=dev)
                lib_out[:n, :F] = ids.T
                lib_out[n:, :F] = pad.T
                return lib_out

            def per_launch_ms(fn, reps):
                fn()
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                for _ in range(reps):
                    fn()
                ev[1].record()
                torch.cuda.synchronize()
                return ev[0].elapsed_time(ev[1]) / reps

            launch()
            torch.cuda.synchronize()
            same_kernel = np.array_equal(out.cpu().numpy(), want.numpy())
            same_library = np.array_equal(library().cpu().numpy(), want.numpy())
            kernel_ms = per_launch_ms(launch, 20)
            library_ms = per_launch_ms(library, 5)
            del xd, out

            build_s = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                td = TrainData.build(ds, nthr, thresholds=th, device=dev)
                torch.cuda.synchronize()
                build_s.append(time.perf_counter() - t0)
            same_build = np.array_equal(td.step.binned.cpu().numpy(), want.numpy())
            del td
            torch.cuda.empty_cache()
            nbytes = n * F * 4 + n_loc * f_blk * want.element_size() + F * B * 4 + f_blk * 4
            print(json.dumps(dict(
                case=f"bin_apply_wire [{n}, {F}] -> [{n_loc}, {f_blk}] at {B} bins",
                card=card, kernel_ms=round(kernel_ms, 4),
                bound_ms=round(nbytes / HBM_BYTES_PER_S * 1e3, 4),
                library_ms=round(library_ms, 4), bitwise_library=same_library,
                upload_s=round(upload_s, 4), build_s=[round(s, 4) for s in build_s],
                build_median_s=round(statistics.median(build_s), 4),
                host_path_s=round(host_s, 4), bitwise_kernel=same_kernel,
                bitwise_build=same_build)), flush=True)
            if not (same_kernel and same_build):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
