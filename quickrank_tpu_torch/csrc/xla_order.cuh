// XLA's CPU order for a scan and a sum over one axis, as device functions,
// for sm_90a.
//
// ops/histogram.py::prefix_sum and ::tree_sum repeat, in Python loops on the
// CPU, the order in which XLA on the CPU associates jnp.cumsum and a reduce
// over a histogram's bin axis; the growers pick their splits from those
// sums, so the port's trees are the JAX package's bit for bit.  This header
// is the same order written once for the card (csrc/split_scan.cu):
//
//  * the scan: sequential within blocks of 16 (the first element taken as
//    it is, then one add per element); the block totals scanned the same
//    way, recursively while more than 16 are left; then each block's
//    elements plus the scanned total of the blocks before it (+0.0 for the
//    first block, which still takes the add: -0.0 becomes +0.0 there).  A
//    row of at most 16 elements is one sequential scan and takes no add.
//  * the sum: while at least 32 values are left, windows of 32 over the
//    values padded with zeros to a multiple of 32, p // 2 zeros in front and
//    the rest behind (p the padding), each window added in order from an
//    accumulator of +0.0; then the last fewer than 32 values the same way.
//    The padded zeros change no bit: an accumulator that starts at +0.0 is
//    never -0.0.
//
// Every add is __fadd_rn: nvcc would otherwise contract the callers'
// products and sums into FMAs and change bits.  A row is scanned by one
// warp (a lane a block of 16, loaded into registers at once, the levels of
// block totals in shared memory) and summed by one block (windows of 32
// from global memory into shared memory, the upper levels there); any
// length works up to the shared memory it asks.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace xla_order {

constexpr int kScanBlock = 16;
constexpr int kSumWindow = 32;
// window levels of a sum (a row of up to 32^6 values)
constexpr int kMaxSumLevels = 6;

template <int C>
struct Vec {
  float v[C];
};

template <int C>
__device__ __forceinline__ Vec<C> vadd(Vec<C> a, const Vec<C>& b) {
#pragma unroll
  for (int c = 0; c < C; ++c) a.v[c] = __fadd_rn(a.v[c], b.v[c]);
  return a;
}

template <int C>
__device__ __forceinline__ Vec<C> vzero() {
  Vec<C> z;
#pragma unroll
  for (int c = 0; c < C; ++c) z.v[c] = 0.0f;
  return z;
}

// Values of shared-memory scratch one warp's scan of n elements takes: the
// block totals of every level above the row.
__host__ __device__ inline int64_t scan_scratch(int64_t n) {
  int64_t total = 0;
  for (int64_t m = n; m > kScanBlock; ) {
    m = (m + kScanBlock - 1) / kScanBlock;
    total += m;
  }
  return total;
}

// A block of up to 16 values [i0, i0 + 16) of a row of n, loaded at once
// (the loads in flight together) into v; returns how many.
template <int C, class Load>
__device__ __forceinline__ int load_block(const Load& load, int64_t i0, int64_t n,
                                          Vec<C> (&v)[kScanBlock]) {
  const int cnt = n - i0 < kScanBlock ? static_cast<int>(n - i0) : kScanBlock;
#pragma unroll
  for (int t = 0; t < kScanBlock; ++t)
    if (t < cnt) v[t] = load(i0 + t);
  return cnt;
}

// v[0] + v[1] + ... + v[cnt - 1], added in order from v[0].
template <int C>
__device__ __forceinline__ Vec<C> block_total(const Vec<C> (&v)[kScanBlock], int cnt) {
  Vec<C> acc = v[0];
#pragma unroll
  for (int t = 1; t < kScanBlock; ++t)
    if (t < cnt) acc = vadd(acc, v[t]);
  return acc;
}

// Calls emit(i0 + t, scan_t + carry) for t < cnt, scan_t the block's own
// inclusive scan; with_carry false takes no add (a row of at most 16).
template <int C, class Emit>
__device__ __forceinline__ void emit_block(const Vec<C> (&v)[kScanBlock], int cnt, int64_t i0,
                                           const Vec<C>& carry, bool with_carry,
                                           const Emit& emit) {
  Vec<C> acc = v[0];
  emit(i0, with_carry ? vadd(acc, carry) : acc);
#pragma unroll
  for (int t = 1; t < kScanBlock; ++t) {
    if (t < cnt) {
      acc = vadd(acc, v[t]);
      emit(i0 + t, with_carry ? vadd(acc, carry) : acc);
    }
  }
}

// Scans the block totals t[0, m) in place in XLA's order; the levels above
// them go to t + m onwards.  All 32 lanes of the warp call it.
template <int C>
__device__ void scan_levels(Vec<C>* t, int64_t m, int lane) {
  // the levels: sizes and offsets, bottom (t itself) to top (<= 16 values)
  int64_t size[8], off[8];
  int top = 0;
  size[0] = m;
  off[0] = 0;
  while (size[top] > kScanBlock) {
    size[top + 1] = (size[top] + kScanBlock - 1) / kScanBlock;
    off[top + 1] = off[top] + size[top];
    ++top;
  }
  Vec<C> v[kScanBlock];
  // up: each level's block totals into the level above
  for (int l = 0; l < top; ++l) {
    const Vec<C>* src = t + off[l];
    auto from = [src](int64_t i) { return src[i]; };
    for (int64_t j = lane; j < size[l + 1]; j += 32) {
      const int cnt = load_block<C>(from, j * kScanBlock, size[l], v);
      t[off[l + 1] + j] = block_total<C>(v, cnt);
    }
    __syncwarp();
  }
  // the top level: one sequential scan, no carry
  if (lane == 0) {
    Vec<C>* s = t + off[top];
    auto from = [s](int64_t i) { return s[i]; };
    const int cnt = load_block<C>(from, 0, size[top], v);
    emit_block<C>(v, cnt, 0, vzero<C>(), false, [s](int64_t i, const Vec<C>& x) { s[i] = x; });
  }
  __syncwarp();
  // down: each level's blocks scanned again, plus the scanned total of the
  // blocks before them
  for (int l = top - 1; l >= 0; --l) {
    Vec<C>* s = t + off[l];
    const Vec<C>* up = t + off[l + 1];
    auto from = [s](int64_t i) { return s[i]; };
    for (int64_t j = lane; j < size[l + 1]; j += 32) {
      const int cnt = load_block<C>(from, j * kScanBlock, size[l], v);
      emit_block<C>(v, cnt, j * kScanBlock, j == 0 ? vzero<C>() : up[j - 1], true,
                    [s](int64_t i, const Vec<C>& x) { s[i] = x; });
    }
    __syncwarp();
  }
}

// One warp's first pass over the row load(0..n): the totals of its blocks
// of 16 into scratch (scan_scratch(n) values), scanned in XLA's order.  A
// row of at most 16 elements has none.  All 32 lanes call it.
template <int C, class Load>
__device__ void warp_scan_totals(int64_t n, const Load& load, Vec<C>* scratch, int lane) {
  if (n <= kScanBlock) return;
  const int64_t m = (n + kScanBlock - 1) / kScanBlock;
  Vec<C> v[kScanBlock];
  for (int64_t j = lane; j < m; j += 32) {
    const int cnt = load_block<C>(load, j * kScanBlock, n, v);
    scratch[j] = block_total<C>(v, cnt);
  }
  __syncwarp();
  scan_levels<C>(scratch, m, lane);
}

// The second pass, after warp_scan_totals on the same scratch: calls
// emit(i, cum_i) once for every i of the inclusive scan, from the lane that
// owns i's block, in increasing i within a block.  All 32 lanes call it.
template <int C, class Load, class Emit>
__device__ void warp_scan_emit(int64_t n, const Load& load, const Emit& emit,
                               const Vec<C>* scratch, int lane) {
  Vec<C> v[kScanBlock];
  if (n <= kScanBlock) {
    if (lane == 0) {
      const int cnt = load_block<C>(load, 0, n, v);
      emit_block<C>(v, cnt, 0, vzero<C>(), false, emit);
    }
    __syncwarp();
    return;
  }
  const int64_t m = (n + kScanBlock - 1) / kScanBlock;
  for (int64_t j = lane; j < m; j += 32) {
    const int cnt = load_block<C>(load, j * kScanBlock, n, v);
    emit_block<C>(v, cnt, j * kScanBlock, j == 0 ? vzero<C>() : scratch[j - 1], true, emit);
  }
  __syncwarp();
}

// The scan's last value, computed by the calling lane alone after
// warp_scan_totals on the same scratch.
template <int C, class Load>
__device__ Vec<C> scan_last(int64_t n, const Load& load, const Vec<C>* scratch) {
  Vec<C> v[kScanBlock];
  if (n <= kScanBlock) return block_total<C>(v, load_block<C>(load, 0, n, v));
  const int64_t m = (n + kScanBlock - 1) / kScanBlock;
  const int cnt = load_block<C>(load, (m - 1) * kScanBlock, n, v);
  return vadd(block_total<C>(v, cnt), scratch[m - 2]);
}

// The window levels of a sum of n values: size[0] = n, size[l] =
// ceil(size[l-1] / 32) for l = 1..depth (depth 0 when n < 32), front[l] the
// zeros in front of level l-1's values.
struct SumLevels {
  int depth;
  int64_t size[kMaxSumLevels + 1];
  int64_t front[kMaxSumLevels + 1];
};

// false when n needs more than kMaxSumLevels levels
__host__ __device__ inline bool sum_levels(int64_t n, SumLevels* lv) {
  lv->depth = 0;
  lv->size[0] = n;
  lv->front[0] = 0;
  while (lv->size[lv->depth] >= kSumWindow) {
    if (lv->depth == kMaxSumLevels) return false;
    const int64_t prev = lv->size[lv->depth];
    const int64_t m = (prev + kSumWindow - 1) / kSumWindow;
    ++lv->depth;
    lv->size[lv->depth] = m;
    lv->front[lv->depth] = (m * kSumWindow - prev) / 2;
  }
  return true;
}

// Window j over the prev values of a level below (front zeros in front),
// added in order from +0.0, its 32 loads in flight together.  The padded
// zeros are added too: they change no bit.
template <class Load>
__device__ __forceinline__ float window(int64_t j, int64_t prev, int64_t front,
                                        const Load& load) {
  const int64_t lo = j * kSumWindow - front;
  float v[kSumWindow];
#pragma unroll
  for (int t = 0; t < kSumWindow; ++t) v[t] = lo + t >= 0 && lo + t < prev ? load(lo + t) : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < kSumWindow; ++t) acc = __fadd_rn(acc, v[t]);
  return acc;
}

// Value j of level D, from the row itself (level 0, load); above level 1
// the windows' values are themselves windows, taken one at a time.
template <int D, class Load>
__device__ float window_sum(const SumLevels& lv, int64_t j, const Load& load) {
  if constexpr (D == 1) {
    return window(j, lv.size[0], lv.front[1], load);
  } else {
    float acc = 0.0f;
    const int64_t lo = j * kSumWindow - lv.front[D];
#pragma unroll 1
    for (int t = 0; t < kSumWindow; ++t) {
      const int64_t i = lo + t;
      if (i >= 0 && i < lv.size[D - 1]) acc = __fadd_rn(acc, window_sum<D - 1>(lv, i, load));
    }
    return acc;
  }
}

// The deepest level a block builds straight from the row: level `start`
// holds at most `cap` values (computed by the host, 1..3).
__host__ __device__ inline int sum_start_level(const SumLevels& lv, int64_t cap) {
  int s = 1;
  while (s < lv.depth && lv.size[s] > cap) ++s;
  return s;
}

// One block's sum of the row load(0..n) in XLA's order (lv = sum_levels(n)),
// returned to thread 0.  buf holds 2 * cap floats; start =
// sum_start_level(lv, cap), at most 3.  Every thread of the block calls it.
template <class Load>
__device__ float block_tree_sum(const SumLevels& lv, int start, const Load& load, float* buf,
                                int64_t cap) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (lv.depth == 0) {
    float acc = 0.0f;
    if (tid == 0)
      for (int64_t i = 0; i < lv.size[0]; ++i) acc = __fadd_rn(acc, load(i));
    return acc;
  }
  float* cur = buf;
  float* nxt = buf + cap;
  for (int64_t j = tid; j < lv.size[start]; j += nt) {
    float v;
    if (start == 1) {
      v = window_sum<1>(lv, j, load);
    } else if (start == 2) {
      v = window_sum<2>(lv, j, load);
    } else {
      v = window_sum<3>(lv, j, load);
    }
    cur[j] = v;
  }
  __syncthreads();
  for (int l = start + 1; l <= lv.depth; ++l) {
    const float* src = cur;
    auto from_smem = [src](int64_t i) { return src[i]; };
    for (int64_t j = tid; j < lv.size[l]; j += nt)
      nxt[j] = window(j, lv.size[l - 1], lv.front[l], from_smem);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  float acc = 0.0f;
  if (tid == 0)
    for (int64_t i = 0; i < lv.size[lv.depth]; ++i) acc = __fadd_rn(acc, cur[i]);
  __syncthreads();  // buf is free again when the caller reuses it
  return acc;
}

}  // namespace xla_order
