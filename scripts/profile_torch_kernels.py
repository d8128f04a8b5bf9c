#!/usr/bin/env python3
"""What the QuickScorer kernel (K1) and the node-histogram kernel (K4) spend
their time on, on one CUDA card: builds variants of the kernels with nvcc and
times them at the shapes of the main paths.

1. The first design of K4 (a block a feature group, one doc a thread; kept
   here as a string, it is no longer in ``csrc/``) with one cost taken away at
   a time: the atomics replaced by a register sum, every doc sent to one bin
   or to uniformly random bins, half and a tenth of the docs in range
   (scattered against contiguous), the bins loaded as 16-byte vectors.  The
   shipped kernel is timed on the same inputs beside it.
2. The shipped ``csrc/histogram.cu`` on the growers' shapes, rebuilt with
   other waves of blocks, threads a block and docs in flight (its constants,
   edited in a copy of the source), and with its atomics cut down (the low
   word's add without its return and carry; the high words' adds alone:
   wrong sums, timed only).
3. ``csrc/qs_score.cu`` rebuilt with 1, 2, 4 and 8 threads a doc
   (``kLanes``) at 131,072 docs x 136 features, each held bitwise
   against the plain scorer, with ptxas's registers and spills.
4. ``csrc/perfect_score.cu`` (K2) rebuilt with 1, 2 and 4 threads a doc
   (``kLanes``) times 1, 2 and 4 trees walked at once by a thread
   (``kInFlight``), and with all 2^D - 1 nodes of a tree tested without the
   dependent chain (``kAllTests``), at 1000 trees of depth 4 and 5 on
   131,072 x 136 and at 1000 x depth 4 on 8,192 x 700 (rows too wide to
   stage); each held bitwise against the plain scorer, with K1 on the same
   depth-4 ensemble timed beside them.
5. ``csrc/oblivious_score.cu`` (K3) rebuilt with 2, 4 and 8 trees in
   flight (``kInFlight``, and ``kInFlightUnstaged`` for rows read from
   global memory, at most 8) times 1, 2 and 4 docs a thread
   (``kDocsPerThread``); with 16 trees in flight at one doc a thread (the
   shipped kernel: 12, and 8 on rows read from global memory); with 1, 2,
   4 and 16 trees in flight past depth 12 (``kInFlightDeep``; shipped: 8);
   and on rows read from global memory with 32 and 128 docs a block
   (``kDocsUnstaged``; shipped: 64) and with 16 trees in flight.  The
   shapes are ``chip_smoke.py``'s OBLIVIOUS_CASES and its u8 bin-space
   shape.  Beside them: this tree's launch through its wrapper
   (``kernel_oblivious.score_oblivious``, the packed tables built), the
   shipped kernel called alone, and with ``--parent DIR`` the checkout at
   DIR's ``csrc/oblivious_score.cu`` (for example the parent commit, ``git
   archive`` unpacked under ``local/``) built alone and called with its own
   arguments (fid, thresholds and ``wleaf`` built once), and with ``wleaf``
   rebuilt a call, as its wrapper did.  Every candidate is held bitwise
   against the plain version before it is timed; times are the mean of two
   passes over the candidates, the second in reverse order.

Run from the repository root (about three minutes on an H100; section 5
about four more):
    python scripts/profile_torch_kernels.py [--sections 1,2,3,4,5]
        [--parent local/parent]
It prints one JSON object last, and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

FIRST_K4 = r'''
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChannels = 8;
#ifndef ABL_FPB
constexpr int kSmemTarget = 110 * 1024;   // two blocks per SM
#else
constexpr int kSmemTarget = ABL_FPB * 6144;  // ABL_FPB features of 256 bins x 3
#endif
constexpr int kSmemMax = 232448;          // one block's dynamic maximum

__device__ inline int channel_shift(unsigned int maxbits, int64_t n) {
  const float m = __uint_as_float(maxbits);
  if (!(m > 0.f) || maxbits >= 0x7f800000u) return 0;  // all zero, or non-finite
  int e;
  frexpf(m, &e);                                      // m < 2^e
  const int nb = 64 - __clzll(static_cast<unsigned long long>(n));  // n < 2^nb
  return 62 - e - nb;
}

// cell += v (mod 2^64) in shared memory with 32-bit atomics: a 64-bit
// shared atomicAdd compiles to a compare-and-swap loop on sm_90, the 32-bit
// one to a native add.  The low word's add returns the old word, so the
// thread whose add wraps it knows, and carries one into the high word; the
// two words then hold the exact 64-bit sum (little-endian: low word first).
__device__ inline void add_u64(unsigned long long* cell, unsigned long long v) {
  unsigned int* w = reinterpret_cast<unsigned int*>(cell);
  const unsigned int lo = static_cast<unsigned int>(v);
  unsigned int hi = static_cast<unsigned int>(v >> 32);
  if (lo != 0u) {
    const unsigned int old = atomicAdd(w, lo);
    hi += (old + lo < lo) ? 1u : 0u;
  }
  if (hi != 0u) atomicAdd(w + 1, hi);
}

// max |v| per channel, as IEEE bits (they order like the values for
// non-negative floats; NaN sorts above inf).  Max is order-free.
__global__ void absmax_kernel(const float* __restrict__ values, int64_t n,
                              int channels, int64_t stride_c, int64_t stride_n,
                              unsigned int* __restrict__ maxbits) {
  unsigned int local[kMaxChannels] = {0u};
  for (int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       d < n; d += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    for (int c = 0; c < channels; ++c) {
      const unsigned int b = __float_as_uint(fabsf(values[c * stride_c + d * stride_n]));
      local[c] = max(local[c], b);
    }
  }
  for (int c = 0; c < channels; ++c) {
    unsigned int v = local[c];
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0 && v) atomicMax(maxbits + c, v);
  }
}

template <typename BinT>
__global__ void histogram_kernel(const BinT* __restrict__ binned, int64_t n,
                                 int64_t width, int features,
                                 int features_per_block,
                                 const float* __restrict__ values, int channels,
                                 int64_t stride_c, int64_t stride_n,
                                 const int32_t* __restrict__ pos, int n0, int k,
                                 int num_bins, int64_t docs_per_block,
                                 const unsigned int* __restrict__ maxbits,
                                 unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long cells[];
  const int f0 = blockIdx.x * features_per_block;
  const int fb = min(features_per_block, features - f0);
  const int kc = k * channels;
  const int per_feature = num_bins * kc;
  const int ncells = fb * per_feature;
  for (int i = threadIdx.x; i < ncells; i += blockDim.x) cells[i] = 0ull;
  double scale[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    scale[c] = c < channels ? ldexp(1.0, channel_shift(maxbits[c], n)) : 0.0;
  __syncthreads();

#ifdef ABL_NO_ATOMICS
  unsigned long long sink = 0ull;
#endif
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * docs_per_block;
  const int64_t d1 = min(n, d0 + docs_per_block);
  for (int64_t d = d0 + threadIdx.x; d < d1; d += blockDim.x) {
    int node = 0;
    if (pos != nullptr) {
      node = pos[d] - n0;
      if (node < 0 || node >= k) continue;
    }
    unsigned long long q[kMaxChannels];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      q[c] = 0ull;
      if (c < channels) {
        const double v = static_cast<double>(values[c * stride_c + d * stride_n]);
        q[c] = static_cast<unsigned long long>(__double2ll_rn(v * scale[c]));
        any |= q[c] != 0ull;
      }
    }
    if (!any) continue;
    const BinT* row = binned + d * width + f0;
#ifdef ABL_VEC16
    // 16 u8 bins as one 16-byte load (f0 is a multiple of 16 with ABL_FPB 16)
    union { uint4 raw; unsigned char byte[16]; } bins;
    bins.raw = *reinterpret_cast<const uint4*>(row);
#endif
#ifdef ABL_VEC16
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      const int64_t b = bins.byte[f];
#else
    for (int f = 0; f < fb; ++f) {
      const int64_t b = static_cast<int64_t>(row[f]);
#endif
      if (b < 0 || b >= num_bins) continue;
      unsigned long long* cell =
          cells + (static_cast<int64_t>(f) * num_bins + b) * kc + node * channels;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
#ifdef ABL_NO_ATOMICS
        // a register sum in place of the atomics; the cell's address still
        // feeds it so that the bin read and the index arithmetic stay
        if (c < channels && q[c] != 0ull)
          sink += q[c] ^ static_cast<unsigned long long>(cell - cells + c);
#else
        if (c < channels && q[c] != 0ull) add_u64(cell + c, q[c]);
#endif
      }
    }
  }
#ifdef ABL_NO_ATOMICS
  if (sink == 0x9e3779b97f4a7c15ull) cells[0] = sink;  // keeps the sum alive
#endif
  __syncthreads();
  unsigned long long* out = acc + static_cast<int64_t>(f0) * per_feature;
  for (int i = threadIdx.x; i < ncells; i += blockDim.x) {
    const unsigned long long v = cells[i];
    if (v != 0ull) atomicAdd(out + i, v);
  }
}

__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                int64_t ncells, int channels, int64_t n,
                                const unsigned int* __restrict__ maxbits,
                                float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= ncells) return;
  const int c = static_cast<int>(i % channels);
  const unsigned int bits = maxbits[c];
  if (bits >= 0x7f800000u) {
    out[i] = __int_as_float(0x7fc00000);
    return;
  }
  const double sum = static_cast<double>(static_cast<long long>(acc[i]));
  out[i] = static_cast<float>(ldexp(sum, -channel_shift(bits, n)));
}

template <typename BinT>
cudaError_t launch(const BinT* binned, int64_t n, int64_t width, int features,
                   const float* values, int channels, int64_t stride_c,
                   int64_t stride_n, const int32_t* pos, int n0, int k,
                   int num_bins, unsigned int* maxbits,
                   unsigned long long* acc, float* out, cudaStream_t stream) {
  const int64_t per_feature_bytes =
      static_cast<int64_t>(num_bins) * k * channels * 8;
  if (per_feature_bytes > kSmemMax) return cudaErrorInvalidValue;
  const int fpb = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(features, kSmemTarget / per_feature_bytes)));
  const int smem = static_cast<int>(fpb * per_feature_bytes);
  const int64_t ncells = static_cast<int64_t>(features) * num_bins * k * channels;

  cudaError_t err = cudaMemsetAsync(maxbits, 0, sizeof(unsigned int) * channels, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * ncells, stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int64_t max_blocks = (n + kThreads - 1) / kThreads;
    absmax_kernel<<<static_cast<unsigned int>(std::min<int64_t>(max_blocks, 4 * sms)),
                    kThreads, 0, stream>>>(values, n, channels, stride_c,
                                           stride_n, maxbits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    err = cudaFuncSetAttribute(histogram_kernel<BinT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int groups = (features + fpb - 1) / fpb;
    // about four blocks per SM over the whole grid
    const int64_t splits = std::max<int64_t>(
        1, std::min<int64_t>(max_blocks, (4 * sms + groups - 1) / groups));
    const int64_t docs_per_block = (n + splits - 1) / splits;
    const dim3 grid(groups, static_cast<unsigned int>((n + docs_per_block - 1) / docs_per_block));
    histogram_kernel<BinT><<<grid, kThreads, smem, stream>>>(
        binned, n, width, features, fpb, values, channels, stride_c, stride_n,
        pos, n0, k, num_bins, docs_per_block, maxbits, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (ncells > 0) {
    to_float_kernel<<<static_cast<unsigned int>((ncells + 255) / 256), 256, 0,
                      stream>>>(acc, ncells, channels, n, maxbits, out);
  }
  return cudaGetLastError();
}


}  // namespace

extern "C" int histogram_launch(const void* binned, int bin_bytes, int64_t n,
                                int64_t width, int features,
                                const float* values, int channels,
                                int64_t stride_c, int64_t stride_n,
                                const int32_t* pos, int n0, int k, int num_bins,
                                unsigned long long* scratch, float* out, void* stream) {
  if (bin_bytes != 1) return static_cast<int>(cudaErrorInvalidValue);
  // the shipped entry's scratch: the accumulator, then the max bits
  const int64_t ncells = static_cast<int64_t>(features) * num_bins * k * channels;
  return static_cast<int>(launch(static_cast<const uint8_t*>(binned), n, width, features,
                                 values, channels, stride_c, stride_n, pos, n0, k,
                                 num_bins, reinterpret_cast<unsigned int*>(scratch + ncells),
                                 scratch, out, static_cast<cudaStream_t>(stream)));
}
'''

#: variant name -> nvcc defines, of the first design of K4
FIRST_K4_VARIANTS = {
    "first design": [],
    "no atomics (register sum)": ["-DABL_NO_ATOMICS"],
    "16 features a block, byte loads": ["-DABL_FPB=16"],
    "16 features a block, 16-byte loads": ["-DABL_FPB=16", "-DABL_VEC16"],
    "16 features a block, 16-byte loads, no atomics": [
        "-DABL_FPB=16", "-DABL_VEC16", "-DABL_NO_ATOMICS"],
}
#: variant name -> ([(text of csrc/histogram.cu, replacement)], whether the
#: sums stay right), of the shipped K4
LOW_ADD = ("const unsigned int old = atomicAdd(lo_cells + c, lo);\n"
           "      high[c] += (old + lo < lo) ? 1u : 0u;")
SHIPPED_K4_VARIANTS = {
    "as shipped": ([], True),
    "4 waves of blocks": ([("kMaxWaves = 8;", "kMaxWaves = 4;")], True),
    "16 waves of blocks": ([("kMaxWaves = 8;", "kMaxWaves = 16;")], True),
    "512 threads a block": ([("kMaxThreads = 1024;", "kMaxThreads = 512;")], True),
    "1 doc in flight": ([("kDocsInFlight = 4;", "kDocsInFlight = 1;")], True),
    "2 docs in flight": ([("kDocsInFlight = 4;", "kDocsInFlight = 2;")], True),
    "8 docs in flight": ([("kDocsInFlight = 4;", "kDocsInFlight = 8;")], True),
    "low add without return and carry": ([(LOW_ADD, "atomicAdd(lo_cells + c, lo);")], False),
    "high adds only": ([(LOW_ADD, "high[c] += lo >> 31;")], False),
}
LANES = (1, 2, 4, 8)
QS_CASES = [(1000, 16, 5), (100, 64, 6), (20, 128, 7)]  # trees, leaves, seed
#: K2's variants: label -> edits of csrc/perfect_score.cu (the same threads a
#: doc and trees in flight for staged rows and for rows read from global memory)
def _k2_edits(lanes, k, all_tests=False):
    return [("kLanes = 1;", f"kLanes = {lanes};"), ("kInFlight = 8;", f"kInFlight = {k};"),
            ("kLanesUnstaged = 4;", f"kLanesUnstaged = {lanes};"),
            ("kInFlightUnstaged = 4;", f"kInFlightUnstaged = {k};"),
            ("kAllTests = false;", f"kAllTests = {'true' if all_tests else 'false'};")]


#: K3's variants: label -> edits of csrc/oblivious_score.cu
def _k3_edits(k, p):
    return [("kInFlight = 12;", f"kInFlight = {k};"),
            ("kDocsPerThread = 1;", f"kDocsPerThread = {p};"),
            ("kInFlightUnstaged = 8;", f"kInFlightUnstaged = {min(k, 8)};")]


K3_VARIANTS = {
    **{f"{k} in flight, {p} docs a thread": _k3_edits(k, p)
       for k in (2, 4, 8) for p in (1, 2, 4)},
    **{f"{k} in flight, 1 docs a thread": _k3_edits(k, 1) for k in (16,)},
    **{f"{k} in flight past depth 12": [("kInFlightDeep = 8;", f"kInFlightDeep = {k};")]
       for k in (1, 2, 4, 16)},
    **{f"{docs} docs a block unstaged": [("kDocsUnstaged = 64;", f"kDocsUnstaged = {docs};")]
       for docs in (32, 128)},
    "16 in flight unstaged": [("kInFlightUnstaged = 8;", "kInFlightUnstaged = 16;")],
}
#: the parent's C entry: x, x_kind, n, f, fid, thr, wleaf, trees, depth, out, stream
PARENT_K3_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


K2_VARIANTS = {
    **{f"{lanes} a doc, {k} in flight": _k2_edits(lanes, k)
       for lanes in (1, 2, 4) for k in (1, 2, 4, 8)},
    **{f"{lanes} a doc, all nodes tested": _k2_edits(lanes, 1, True) for lanes in (1, 4)},
}


def ptxas_report(log):
    """ptxas's lines on registers and spills, each kernel under its mangled
    name (which holds the template's types)."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            out.append(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            out.append("  " + line.strip())
    return out


def time_ms(fn, reps=10, warm=2):
    """Mean ms per call between CUDA events, after ``warm`` calls."""
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


class Variant:
    """A kernel library in which the entry points of one rebuilt source take
    the place of the package's; the rest are the package's own."""

    def __init__(self, path, base, signatures):
        self._lib, self._base = ctypes.CDLL(path), base
        for name, argtypes in signatures.items():
            if hasattr(self._lib, name):
                fn = getattr(self._lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def __getattr__(self, name):
        lib = self._lib if hasattr(self._lib, name) else self._base
        return getattr(lib, name)


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--queries", type=int, default=19000)
    p.add_argument("--out", help="also write the JSON report here")
    p.add_argument("--sections", default="1,2,3,4,5",
                   help="comma-separated sections to run (default: all)")
    p.add_argument("--parent", help="section 5: a checkout whose csrc/oblivious_score.cu "
                   "is built alone and timed beside this tree's")
    args = p.parse_args()
    sections = {int(x) for x in args.sections.split(",")}
    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from quickrank_tpu_torch._build import BUILD_DIR
    from quickrank_tpu_torch.ops import _cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    base = _cuda.library()
    nvcc = _cuda.find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    first_src = os.path.join(BUILD_DIR, "first_k4.cu")
    with open(first_src, "w") as f:
        f.write(FIRST_K4)

    # -- build every variant, all nvcc processes started together -----------
    jobs = {}

    def start(key, src, defines):
        out = os.path.join(BUILD_DIR, f"variant_{len(jobs)}.so")
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", *defines, "-o", out, src]
        jobs[key] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))

    def start_edited(key, source, edits):
        """Build a copy of ``csrc/<source>`` with ``edits`` made in its text."""
        with open(os.path.join(_cuda.CSRC, source)) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/{source} no longer holds {old!r}")
            text = text.replace(old, new)
        path = os.path.join(BUILD_DIR, f"edited_{len(jobs)}_{source}")
        with open(path, "w") as f:
            f.write(text)
        start(key, path, [])

    if 1 in sections:
        for name, defines in FIRST_K4_VARIANTS.items():
            start(("first", name), first_src, defines)
    if 2 in sections:
        for name, (edits, _) in SHIPPED_K4_VARIANTS.items():
            start_edited(("shipped", name), "histogram.cu", edits)
    if 3 in sections:
        for n in LANES:
            start_edited(("lanes", n), "qs_score.cu", [("kLanes = 4;", f"kLanes = {n};")])
    if 4 in sections:
        for name, edits in K2_VARIANTS.items():
            start_edited(("k2", name), "perfect_score.cu", edits)
    if 5 in sections:
        for name, edits in K3_VARIANTS.items():
            start_edited(("k3", name), "oblivious_score.cu", edits)
        if args.parent:
            start(("k3", "parent"), os.path.join(
                args.parent, "quickrank_tpu_torch", "csrc", "oblivious_score.cu"), [])
    libs, ptxas = {}, {}
    for key, (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        if key == ("k3", "parent"):
            libs[key] = ctypes.CDLL(out).oblivious_score
            libs[key].argtypes, libs[key].restype = PARENT_K3_ARGS, ctypes.c_int
        else:
            libs[key] = Variant(out, base, _cuda.SIGNATURES)
        ptxas[key] = err

    def with_lib(key, fn):
        """Run ``fn`` with the package's wrappers bound to variant ``key``."""
        _cuda._lib = libs[key] if key is not None else base
        try:
            return fn()
        finally:
            _cuda._lib = base

    report = {"card": card, "k4_first_design_ms": {}, "k4_shipped_ms": {}, "k1_lanes": {},
              "k2_variants": {}, "k3": {}}
    if 1 in sections or 2 in sections:
        section_k4(args, sections, report, dev, with_lib, ptxas)
    if 3 in sections:
        section_k1(report, dev, with_lib, ptxas)
    if 4 in sections:
        section_k2(report, dev, with_lib, ptxas)
    if 5 in sections:
        section_k3(report, dev, libs, base, ptxas)

    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


def section_k4(args, sections, report, dev, with_lib, ptxas):
    """Sections 1 and 2: K4's first design taken apart, the shipped K4's
    variants on the growers' shapes."""
    import torch

    from quickrank_tpu_torch.data.synthetic import make_ranking_dataset
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.ops.histogram import doc_channels

    td = TrainData.build(make_ranking_dataset(num_queries=args.queries, seed=11), 255,
                         device=dev)
    binned, mask = td.step.binned, td.step.doc_mask
    N, W = binned.shape
    gen = torch.Generator(device="cpu").manual_seed(5)
    g = torch.randn(N, generator=gen).to(dev)
    vt = doc_channels(g, mask).T.contiguous()

    def subset(share, scattered):
        """pos row (0 in range, 1 outside) of ``share`` of the docs."""
        if scattered:
            keep = torch.rand(N, generator=gen).to(dev) < share
        else:
            keep = torch.zeros(N, dtype=torch.bool, device=dev)
            start_row = N // 3
            keep[start_row:start_row + int(N * share)] = True
        return torch.where(keep & mask, 0, 1).to(torch.int32)

    pos_root = torch.where(mask, 0, 1).to(torch.int32)
    inputs = {
        "root, the data's bins": (binned, pos_root),
        "root, every doc in bin 0": (torch.zeros_like(binned), pos_root),
        "root, uniformly random bins": (
            torch.randint(0, 256, (N, W), generator=gen, dtype=torch.uint8).to(dev), pos_root),
        "half the docs, scattered": (binned, subset(0.5, True)),
        "half the docs, contiguous": (binned, subset(0.5, False)),
        "a tenth of the docs, scattered": (binned, subset(0.1, True)),
        "a tenth of the docs, contiguous": (binned, subset(0.1, False)),
    }
    if 1 in sections:
        section_k4_first(report, inputs, vt, with_lib)
    if 2 in sections:
        section_k4_shipped(report, dev, gen, binned, g, vt, pos_root,
                           inputs["a tenth of the docs, scattered"][1], with_lib, ptxas)


def section_k4_first(report, inputs, vt, with_lib):
    """Section 1: the first design of K4, one cost taken away at a time."""
    import torch

    from quickrank_tpu_torch.ops import kernel_histogram

    want = {name: kernel_histogram.node_histogram_fixed(b, vt, pos, 256, 0, 1)
            for name, (b, pos) in inputs.items()}
    N, W = inputs["root, the data's bins"][0].shape
    print(f"1. K4 at {N} x {W} u8, 256 bins, C = 3, k = 1: ms a launch")
    for variant in [("first", v) for v in FIRST_K4_VARIANTS] + [None]:
        label = variant[1] if variant else "the shipped kernel"
        row = {}
        for name, (b, pos) in inputs.items():
            call = lambda: kernel_histogram.node_histogram(b, vt, pos, 256, 0, 1)  # noqa: E731
            got = with_lib(variant, call)
            if "no atomics" not in label and not torch.equal(got, want[name]):
                raise RuntimeError(f"{label}, {name}: differs from node_histogram_fixed")
            row[name] = with_lib(variant, lambda: time_ms(call))
        report["k4_first_design_ms"][label] = row
        print(f"  {label}:")
        for name, ms in row.items():
            print(f"    {name}: {ms:.4f}")


def section_k4_shipped(report, dev, gen, binned, g, vt, pos_root, tenth, with_lib, ptxas):
    """Section 2: the shipped K4 (and K5) on the growers' shapes, and its
    variants."""
    import torch

    from quickrank_tpu_torch.ops import kernel_histogram

    N = binned.shape[0]
    pos_nodes = torch.randint(0, 16, (N,), generator=gen, dtype=torch.int32).to(dev)
    # level-wise growth's uneven nodes: node i holds about 2^-(i+1) of the docs
    skew = torch.rand(N, generator=gen).to(dev)
    pos_skew = (-torch.log2(skew.clamp_min(2.0 ** -8))).floor().clamp(0, 7).to(torch.int32)
    vt2 = vt[:2].contiguous()
    rows = (tenth == 0).nonzero()[:, 0]
    run = (binned[rows].contiguous(), vt[:, rows].contiguous(),
           torch.zeros(rows.shape[0], dtype=torch.int32, device=dev))
    shapes = {
        "root (k=1, C=3)": (binned, vt, pos_root, 0, 1),
        "no doc in range (k=1, C=3)": (binned, vt, pos_root, 5, 1),
        "a tenth of the docs, scattered (k=1, C=3)": (binned, vt, tenth, 0, 1),
        "the same docs as a run": (*run, 0, 1),
        "k=8, C=3, even nodes": (binned, vt, pos_nodes, 0, 8),
        "k=8, C=3, uneven nodes": (binned, vt, pos_skew, 0, 8),
        "k=10, C=3, n0=3": (binned, vt, pos_nodes, 3, 10),
        "k=16, C=2": (binned, vt2, pos_nodes, 0, 16),
    }
    slots = torch.randint(0, 32, (N, 1), generator=gen, dtype=torch.int32).to(dev)
    vals = torch.stack([g, torch.rand(N, generator=gen).to(dev)], dim=-1).contiguous()
    want = {name: kernel_histogram.node_histogram_fixed(b, v, pos, 256, n0, k)
            for name, (b, v, pos, n0, k) in shapes.items()}
    want_k5 = kernel_histogram.node_histogram_fixed(slots, vals.T.contiguous(), None, 32, 0, 1)
    print("2. the shipped K4 (and K5) and its variants: ms a launch")
    for variant, (_, exact) in SHIPPED_K4_VARIANTS.items():
        key = ("shipped", variant)
        row = {}
        for name, (b, v, pos, n0, k) in shapes.items():
            call = lambda: kernel_histogram.node_histogram(b, v, pos, 256, n0, k)  # noqa: E731
            if exact and not torch.equal(with_lib(key, call), want[name]):
                raise RuntimeError(f"{variant}, {name}: differs from node_histogram_fixed")
            row[name] = with_lib(key, lambda: time_ms(call))
        call = lambda: kernel_histogram.histogram(slots, vals, 32)  # noqa: E731
        if exact and not torch.equal(with_lib(key, call), want_k5):
            raise RuntimeError(f"{variant}, K5: differs from node_histogram_fixed")
        row["K5, 32 slots, C=2"] = with_lib(key, lambda: time_ms(call, reps=20))
        report["k4_shipped_ms"][variant] = row
        print(f"  {variant}: " + ", ".join(f"{name} {ms:.4f}" for name, ms in row.items()))
    regs = ptxas_report(ptxas[("shipped", "as shipped")])
    report["k4_ptxas"] = regs
    for line in regs:
        print(f"      ptxas: {line}")


def section_k1(report, dev, with_lib, ptxas):
    """Section 3: K1 by threads a doc."""
    import numpy as np
    import torch

    from quickrank_tpu_torch.ops import kernel_qs
    from quickrank_tpu_torch.trees.qs import ensemble_to_qs, score_qs
    from quickrank_tpu_torch.trees.random_ensemble import random_bestfirst_ensemble

    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1 << 17, 136), dtype=np.float32)).to(dev)
    X8 = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, size=(1 << 17, 136), dtype=np.uint8)).to(dev)
    print(f"3. K1 at {X.shape[0]} docs x {X.shape[1]} features by threads a doc "
          f"(kLanes): ms a launch")
    tables = {}
    for T, leaves, seed in QS_CASES:
        t = ensemble_to_qs(random_bestfirst_ensemble(T, leaves, 136, seed=seed)).to(dev)
        tables[f"{T} x {leaves} leaves"] = (t, score_qs(X, t))
    bins_table = ensemble_to_qs(random_bestfirst_ensemble(1000, 16, 136, seed=5))
    bins_table.thr = torch.from_numpy(np.random.default_rng(9).integers(
        0, 255, size=tuple(bins_table.thr.shape)).astype(np.float32))
    bins_table = bins_table.to(dev)
    bins_want = score_qs(X8, bins_table)
    for n in LANES:
        row = {}
        for name, (t, plain) in tables.items():
            call = lambda: kernel_qs.score_qs(X, t)  # noqa: E731
            if not torch.equal(with_lib(("lanes", n), call), plain):
                raise RuntimeError(f"{n} threads a doc, {name}: differs from the plain scorer")
            row[name] = with_lib(("lanes", n), lambda: time_ms(call))
        call = lambda: kernel_qs.score_qs(X8, bins_table)  # noqa: E731
        if not torch.equal(with_lib(("lanes", n), call), bins_want):
            raise RuntimeError(f"{n} threads a doc, u8 rows: differs from the plain scorer")
        row["1000 x 16 leaves, u8 rows"] = with_lib(("lanes", n), lambda: time_ms(call))
        regs = ptxas_report(ptxas[("lanes", n)])
        report["k1_lanes"][str(n)] = {"ms": row, "ptxas": regs}
        print(f"  {n}: " + ", ".join(f"{name} {ms:.4f}" for name, ms in row.items()))
        for line in regs:
            print(f"      ptxas: {line}")


def section_k2(report, dev, with_lib, ptxas):
    """Section 4: K2 by threads a doc, trees in flight and the chain-free
    form, with K1 on the same depth-4 ensemble beside it."""
    import numpy as np
    import torch

    from quickrank_tpu_torch.ops import kernel_perfect, kernel_qs
    from quickrank_tpu_torch.trees.perfect import ensemble_to_perfect, score_perfect
    from quickrank_tpu_torch.trees.qs import ensemble_to_qs, score_qs
    from quickrank_tpu_torch.trees.random_ensemble import random_balanced_ensemble

    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1 << 17, 136), dtype=np.float32)).to(dev)
    X_wide = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (8192, 700), dtype=np.float32)).to(dev)
    cases = {}
    for depth in (4, 5):
        pe = ensemble_to_perfect(random_balanced_ensemble(1000, depth, 136, seed=0)).to(dev)
        cases[f"1000 x depth {depth}"] = (X, pe, score_perfect(X, pe))
    pe = ensemble_to_perfect(random_balanced_ensemble(1000, 4, 700, seed=9)).to(dev)
    cases["1000 x depth 4, 8192 x 700 (unstaged)"] = (X_wide, pe, score_perfect(X_wide, pe))
    print(f"4. K2 at {X.shape[0]} docs x {X.shape[1]} features by threads a doc, trees in "
          f"flight and the chain-free form: ms a launch")
    for name, edits in K2_VARIANTS.items():
        key = ("k2", name)
        row = {}
        for case, (feats, pe, plain) in cases.items():
            call = lambda: kernel_perfect.score_perfect(feats, pe)  # noqa: E731
            if not torch.equal(with_lib(key, call), plain):
                raise RuntimeError(f"K2 {name}, {case}: differs from the plain scorer")
            row[case] = with_lib(key, lambda: time_ms(call, reps=20))
        regs = ptxas_report(ptxas[key])
        report["k2_variants"][name] = {"ms": row, "ptxas": regs}
        print(f"  {name}: " + ", ".join(f"{case} {ms:.4f}" for case, ms in row.items()))
        for line in regs:
            print(f"      ptxas: {line}")
    pe = cases["1000 x depth 4"][1]
    qs = ensemble_to_qs(random_balanced_ensemble(1000, 4, 136, seed=0)).to(dev)
    if not torch.equal(kernel_qs.score_qs(X, qs), score_qs(X, qs)):
        raise RuntimeError("K1 on the depth-4 ensemble differs from the plain scorer")
    shipped = time_ms(lambda: kernel_perfect.score_perfect(X, pe), reps=20)
    k1 = time_ms(lambda: kernel_qs.score_qs(X, qs), reps=20)
    report["k2_shipped_vs_k1_ms"] = {"perfect_score": shipped, "qs_score": k1}
    print(f"  the shipped K2 {shipped:.4f} ms, K1 on the same ensemble {k1:.4f} ms")


def section_k3(report, dev, libs, base, ptxas):
    """Section 5: K3's candidates on OBLIVIOUS_CASES and the u8 shape."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import (
        OBLIVIOUS_BINS_CASE,
        OBLIVIOUS_CASES,
        oblivious_bins_inputs,
        oblivious_inputs,
    )
    from quickrank_tpu_torch.ops import kernel_oblivious
    from quickrank_tpu_torch.ops import oblivious as plain_oblivious

    cases = {}
    for T, depth, n_docs, n_feat in OBLIVIOUS_CASES:
        feats, obl = oblivious_inputs(T, depth, n_docs, n_feat)
        cases[f"{T} x depth {depth}, {n_docs} x {n_feat}"] = (
            torch.from_numpy(feats).to(dev), obl.to(dev))
    bins, obl = oblivious_bins_inputs()
    T, depth, n_docs, n_feat = OBLIVIOUS_BINS_CASE
    cases[f"{T} x depth {depth}, {n_docs} x {n_feat} u8"] = (bins.to(dev), obl.to(dev))

    def entry(lib, X, obl, out):
        """A raw call of a library's oblivious_score on the packed tables."""
        kind = 0 if X.dtype == torch.float32 else 1
        packed = obl.packed(kind == 1)
        stream = torch.cuda.current_stream(dev).cuda_stream
        return lambda: _cuda_ok(lib.oblivious_score(
            X.data_ptr(), kind, X.shape[0], X.shape[1], packed.data_ptr(), obl.capacity,
            obl.depth, out.data_ptr(), stream))

    def parent_entry(fn, X, obl, out, rebuild):
        """A raw call of the parent's entry; with ``rebuild`` wleaf is built
        anew each call, as the parent's wrapper built it."""
        kind = 0 if X.dtype == torch.float32 else 1
        thr = obl.thr_bin if kind else obl.thr
        wleaf = obl.wleaf()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            w = obl.wleaf() if rebuild else wleaf
            _cuda_ok(fn(X.data_ptr(), kind, X.shape[0], X.shape[1], obl.fid.data_ptr(),
                        thr.data_ptr(), w.data_ptr(), obl.capacity, obl.depth,
                        out.data_ptr(), stream))
        return call

    print("5. K3 by trees in flight and docs a thread, beside the parent's kernel: ms a "
          "launch (mean of two passes, the second in reverse order)")
    rows = {}
    for case, (X, obl) in cases.items():
        binned = X.dtype != torch.float32
        want = (plain_oblivious.score_oblivious_binned if binned
                else plain_oblivious.score_oblivious)(X, obl)
        out = torch.empty(X.shape[0], dtype=torch.float32, device=dev)
        calls = {"launch": lambda X=X, obl=obl: kernel_oblivious.score_oblivious(X, obl),
                 "shipped": entry(base, X, obl, out)}
        for key, lib in libs.items():
            if key[0] != "k3":
                continue
            if key[1] == "parent":
                calls["parent"] = parent_entry(lib, X, obl, out, False)
                calls["parent, wleaf a call"] = parent_entry(lib, X, obl, out, True)
            else:
                calls[key[1]] = entry(lib, X, obl, out)
        for name, call in calls.items():
            out.fill_(float("nan"))
            got = call() if name == "launch" else (call(), out)[1]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K3 {name}, {case}: differs from the plain version on "
                                   f"{int((got != want).sum())} docs")
        order = list(calls)
        ms = {name: [] for name in order}
        for names in (order, order[::-1]):
            for name in names:
                ms[name].append(time_ms(calls[name], reps=20))
        design = kernel_oblivious.design(X, obl)
        rows[case] = {"design": design, "ms": {k: sum(v) / len(v) for k, v in ms.items()},
                      "passes": ms}
        print(f"  {case} (shipped: {design}):")
        for name, v in ms.items():
            print(f"    {name}: {sum(v) / len(v):.4f} ({v[0]:.4f}, {v[1]:.4f})")
    report["k3"] = {"cases": rows,
                    "ptxas": {k[1]: ptxas_report(v) for k, v in ptxas.items() if k[0] == "k3"}}
    # printed: the depth-4 kernels and the parent's (all in the report)
    for name, lines in report["k3"]["ptxas"].items():
        print(f"  ptxas, {name}:")
        shown = False
        for line in lines:
            if not line.startswith(" "):
                shown = "oblivious_depth_kernel" not in line or re.search(r"I[fh]Li4E", line)
            if shown:
                print(f"      {line}")


def _cuda_ok(rc):
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")


if __name__ == "__main__":
    sys.exit(main())
