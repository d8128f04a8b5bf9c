// The growers' split scan and node statistics, and the two sums they rest
// on, in XLA's CPU order (csrc/xla_order.cuh), for sm_90a.
//
// Not ports of TPU kernels: on the TPU, XLA fuses trees/grow.py's jitted
// scan, gain and argmax into its own kernels.  The port's growers ran them
// as Python loops of small launches (ops/histogram.py::prefix_sum and
// ::tree_sum repeat XLA's order on any device): ~180 launches a best-first
// split, which kept the card idle while the host dispatched them.  Each
// entry here is one launch, with the loops' adds in the loops' order, so
// the trees stay bit for bit those of the loops, and so the JAX package's.
//
//  * split_scan: trees/grow.py::_best_splits.  For k nodes' histograms
//    [k, F, B, C] (channel 0 the count, 1 the gradient sum) under feature
//    masks [k, F]: each (node, feature) row's inclusive scan, the gain
//    ls*ls/max(lc,1) + rs*rs/max(rc,1) of every bin whose children both hold
//    min-leaf-support docs (rc, rs from the row's last cumulative value),
//    and the first maximum over the flat (feature, bin) index, as
//    torch.argmax picks it: (can_split, feature, bin, gain) a node.
//  * node_stats: trees/grow.py::_node_stats and ::_deviance for a run of
//    nodes: feature 0's bins summed for the three channels, and the deviance
//    s2 - s*s/max(c,1) (0 where c <= 0) written to deviance[node].
//  * xla_prefix_sum, xla_tree_sum: prefix_sum along any axis and tree_sum
//    over the last, at any shape and strides (the oblivious and level-wise
//    growers, DART's mean over docs).
//
// Every multiply, divide and add is __fmul_rn, __fdiv_rn or __fadd_rn, as
// PyTorch's elementwise kernels round each operation alone.
//
// Bounds: a best-first split reads two channels of one node's histogram,
// 160 x 256 x 2 float32 (328 KB, in L2 after the histogram pass): 0.1 us
// at 3.35 TB/s.  The launch is latency-bound: a warp a (node, feature) row,
// four rows a block, so that a node's 160 rows spread over 40 SMs; a lane a
// block of 16 bins, its loads in flight together (the scan's two passes
// read the row from L2, then L1); the row's block totals in shared memory;
// the best (gain, index) key reduced over the lanes and warps, then over a
// node's blocks by the last of them to finish.  A masked-out feature is
// not read.  node_stats gives a block a node; the generic sums a warp a row
// (scan), and a block a row of 32 or more (sum) or a thread a shorter one.

#include <cuda_runtime.h>

#include <cstdint>

#include "xla_order.cuh"

namespace {

using xla_order::Vec;

// warps (rows) of a split-scan block
constexpr int kSplitWarps = 4;
// batch dimensions of a generic row layout
constexpr int kMaxDims = 8;
// floats of each of a summing block's two level buffers (32 KB together)
constexpr int64_t kSumCap = 4096;
constexpr int kSumThreads = 512;
constexpr int kScanWarps = 8;
// dynamic shared memory a launch here asks for without opting in
constexpr int64_t kSmemDefault = 48 * 1024;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xFF800000u); }

// torch.argmax's order as an integer: the gain's bits made monotone (NaN
// above everything, -0.0 as +0.0), then the flat index inverted, so that
// the larger key is the larger gain and, among equal gains, the first index.
__device__ __forceinline__ uint32_t gain_key(float g) {
  if (g != g) return 0xFFFFFFFFu;
  const uint32_t b = __float_as_uint(g == 0.0f ? 0.0f : g);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_gain(uint32_t k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FFFFFFFu);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long split_key(float g, int64_t flat) {
  return (static_cast<unsigned long long>(gain_key(g)) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(flat));
}

// Block (x, node) scans the rows f = x * warps + warp of its node, a warp a
// row, and writes its best key and whether any bin was valid to
// partial[node * gridDim.x + x]; the node's last block to finish (a ticket
// from counter[node], which it sets back to 0) reduces them and writes the
// node's outputs.
__global__ void __launch_bounds__(kSplitWarps * 32)
split_scan_kernel(const float* __restrict__ hist, int64_t F, int64_t B, int C,
                  const uint8_t* __restrict__ masks, float minls,
                  unsigned long long* __restrict__ partial, unsigned int* __restrict__ counter,
                  uint8_t* __restrict__ can, int64_t* __restrict__ fstar,
                  int64_t* __restrict__ tstar, float* __restrict__ gain) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long warp_best[kSplitWarps];
  __shared__ int warp_any[kSplitWarps];
  __shared__ bool last;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int64_t node = blockIdx.y;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * nw + warp;
  unsigned long long best = 0;  // below every key
  bool any = false;
  if (f < F && !masks[node * F + f]) {
    best = split_key(neg_inf(), f * B);  // every bin -inf: the row's first index stands for it
  } else if (f < F) {
    Vec<2>* scratch = reinterpret_cast<Vec<2>*>(smem) + warp * xla_order::scan_scratch(B);
    const float* row = hist + (node * F + f) * B * C;
    auto load = [row, C](int64_t i) {
      Vec<2> v;
      v.v[0] = __ldg(row + i * C);
      v.v[1] = __ldg(row + i * C + 1);
      return v;
    };
    xla_order::warp_scan_totals<2>(B, load, scratch, lane);
    const Vec<2> total = xla_order::scan_last<2>(B, load, scratch);
    auto emit = [&](int64_t i, const Vec<2>& cum) {
      const float lc = cum.v[0];
      const float ls = cum.v[1];
      const float rc = __fsub_rn(total.v[0], lc);
      const float rs = __fsub_rn(total.v[1], ls);
      const bool valid = lc >= minls && rc >= minls;
      float g = neg_inf();
      if (valid)
        g = __fadd_rn(__fdiv_rn(__fmul_rn(ls, ls), fmaxf(lc, 1.0f)),
                      __fdiv_rn(__fmul_rn(rs, rs), fmaxf(rc, 1.0f)));
      any = any || valid;
      best = kmax(best, split_key(g, f * B + i));
    };
    xla_order::warp_scan_emit<2>(B, load, emit, scratch, lane);
  }
  for (int o = 16; o > 0; o >>= 1) best = kmax(best, __shfl_xor_sync(0xFFFFFFFFu, best, o));
  const bool warp_has = __any_sync(0xFFFFFFFFu, any);
  if (lane == 0) {
    warp_best[warp] = best;
    warp_any[warp] = warp_has;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool has = false;
    for (int w = 0; w < nw; ++w) {
      best = kmax(best, warp_best[w]);
      has = has || warp_any[w];
    }
    unsigned long long* mine = partial + 2 * (node * gridDim.x + blockIdx.x);
    mine[0] = best;
    mine[1] = has;
    __threadfence();
    last = atomicAdd(counter + node, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  bool has = false;
  for (unsigned x = 0; x < gridDim.x; ++x) {
    const unsigned long long* theirs = partial + 2 * (node * gridDim.x + x);
    best = kmax(best, __ldcg(theirs));
    has = has || __ldcg(theirs + 1) != 0;
  }
  counter[node] = 0;
  const int64_t flat = 0xFFFFFFFFu - static_cast<uint32_t>(best);
  can[node] = has;
  fstar[node] = flat / B;
  tstar[node] = flat % B;
  gain[node] = key_gain(static_cast<uint32_t>(best >> 32));
}

__global__ void __launch_bounds__(kSumThreads)
node_stats_kernel(const float* __restrict__ hist, int64_t F, int64_t B, int C, int64_t start,
                  xla_order::SumLevels lv, int level, float* __restrict__ deviance) {
  __shared__ float buf[2 * kSumCap];
  const int64_t node = start + blockIdx.x;
  const float* row = hist + node * F * B * C;  // feature 0
  float s[3];
  for (int c = 0; c < 3; ++c)
    s[c] = xla_order::block_tree_sum(
        lv, level, [row, C, c](int64_t i) { return __ldg(row + i * C + c); }, buf, kSumCap);
  if (threadIdx.x == 0)
    deviance[node] = s[0] > 0.0f
        ? __fsub_rn(s[2], __fdiv_rn(__fmul_rn(s[1], s[1]), fmaxf(s[0], 1.0f)))
        : 0.0f;
}

// A row's place in a strided tensor: the batch dimensions' sizes and
// strides (elements), and the stride of the scanned or summed axis.
struct RowLayout {
  int ndim;
  int64_t size[kMaxDims];
  int64_t stride[kMaxDims];
  int64_t axis_stride;
};

__device__ __forceinline__ int64_t row_offset(const RowLayout& lay, int64_t r) {
  int64_t off = 0;
  for (int d = lay.ndim - 1; d >= 0; --d) {
    off += (r % lay.size[d]) * lay.stride[d];
    r /= lay.size[d];
  }
  return off;
}

__global__ void __launch_bounds__(kScanWarps * 32)
prefix_sum_kernel(const float* __restrict__ x, RowLayout lay, int64_t rows, int64_t n,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (row >= rows) return;  // the whole warp: the scan syncs warps only
  Vec<1>* scratch = reinterpret_cast<Vec<1>*>(smem) + warp * xla_order::scan_scratch(n);
  const float* base = x + row_offset(lay, row);
  const int64_t s = lay.axis_stride;
  float* o = out + row * n;
  auto load = [base, s](int64_t i) {
    Vec<1> v;
    v.v[0] = __ldg(base + i * s);
    return v;
  };
  auto emit = [o](int64_t i, const Vec<1>& v) { o[i] = v.v[0]; };
  xla_order::warp_scan_totals<1>(n, load, scratch, lane);
  xla_order::warp_scan_emit<1>(n, load, emit, scratch, lane);
}

__global__ void __launch_bounds__(kSumThreads)
tree_sum_short_kernel(const float* __restrict__ x, RowLayout lay, int64_t rows, int64_t n,
                      float* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (row >= rows) return;
  const float* base = x + row_offset(lay, row);
  float acc = 0.0f;
  for (int64_t i = 0; i < n; ++i) acc = __fadd_rn(acc, base[i * lay.axis_stride]);
  out[row] = acc;
}

__global__ void __launch_bounds__(kSumThreads)
tree_sum_block_kernel(const float* __restrict__ x, RowLayout lay, xla_order::SumLevels lv,
                      int level, float* __restrict__ out) {
  __shared__ float buf[2 * kSumCap];
  const int64_t row = blockIdx.x;
  const float* base = x + row_offset(lay, row);
  const int64_t s = lay.axis_stride;
  const float v = xla_order::block_tree_sum(
      lv, level, [base, s](int64_t i) { return __ldg(base + i * s); }, buf, kSumCap);
  if (threadIdx.x == 0) out[row] = v;
}

bool make_layout(int ndim, const int64_t* sizes, const int64_t* strides, int64_t axis_stride,
                 RowLayout* lay) {
  if (ndim < 0 || ndim > kMaxDims) return false;
  lay->ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    lay->size[d] = sizes[d];
    lay->stride[d] = strides[d];
  }
  lay->axis_stride = axis_stride;
  return true;
}

// The level a summing block builds from the row, 0 where n is too long
int sum_plan(int64_t n, xla_order::SumLevels* lv) {
  if (!xla_order::sum_levels(n, lv)) return 0;
  if (lv->depth == 0) return 1;
  const int level = xla_order::sum_start_level(*lv, kSumCap);
  return level <= 3 ? level : 0;
}

}  // namespace

// Blocks a node's rows take (one warp a row), 0 where one warp's block
// totals overflow the default shared memory.
extern "C" int split_scan_blocks(int64_t F, int64_t B) {
  const int64_t per_warp = xla_order::scan_scratch(B) * static_cast<int64_t>(sizeof(Vec<2>));
  int64_t warps = per_warp ? kSmemDefault / per_warp : kSplitWarps;
  warps = warps < kSplitWarps ? warps : kSplitWarps;
  return warps < 1 ? 0 : static_cast<int>((F + warps - 1) / warps);
}

// hist: float32 [k, F, B, C] contiguous, C >= 2; masks: bool [k, F];
// partial: 2 * k * split_scan_blocks(F, B) uint64 of scratch; counter: k
// uint32, 0 before the launch and after it; outputs [k] each: can (bool),
// fstar, tstar (int64), gain (float32).
extern "C" int split_scan(const float* hist, int64_t k, int64_t F, int64_t B, int C,
                          const uint8_t* masks, float minls, unsigned long long* partial,
                          unsigned int* counter, uint8_t* can, int64_t* fstar, int64_t* tstar,
                          float* gain, void* stream) {
  if (k == 0) return static_cast<int>(cudaSuccess);
  const int blocks = split_scan_blocks(F, B);
  if (F < 1 || B < 1 || C < 2 || F * B > 0xFFFFFFFFll || k > 65535 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = (F + blocks - 1) / blocks;
  const size_t smem = static_cast<size_t>(warps * xla_order::scan_scratch(B)) * sizeof(Vec<2>);
  split_scan_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(k)),
                      static_cast<unsigned>(warps * 32), smem,
                      static_cast<cudaStream_t>(stream)>>>(hist, F, B, C, masks, minls, partial,
                                                           counter, can, fstar, tstar, gain);
  return static_cast<int>(cudaGetLastError());
}

// hist: float32 [nodes, F, B, C] contiguous, C >= 3; writes deviance[start
// .. start + count) from hist's nodes of the same ids.
extern "C" int node_stats(const float* hist, int64_t F, int64_t B, int C, int64_t start,
                          int64_t count, float* deviance, void* stream) {
  if (count == 0) return static_cast<int>(cudaSuccess);
  xla_order::SumLevels lv;
  const int level = sum_plan(B, &lv);
  if (F < 1 || C < 3 || level == 0 || count > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  node_stats_kernel<<<static_cast<unsigned>(count), kSumThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(hist, F, B, C, start, lv, level,
                                                           deviance);
  return static_cast<int>(cudaGetLastError());
}

// x: float32 rows of n elements, row r at the offset of its batch index in
// (sizes, strides) and elements axis_stride apart; out: float32 [rows, n].
extern "C" int xla_prefix_sum(const float* x, int ndim, const int64_t* sizes,
                              const int64_t* strides, int64_t axis_stride, int64_t rows,
                              int64_t n, float* out, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  RowLayout lay;
  const int64_t per_warp = xla_order::scan_scratch(n) * static_cast<int64_t>(sizeof(float));
  int64_t warps = per_warp ? kSmemDefault / per_warp : kScanWarps;
  warps = warps < kScanWarps ? warps : kScanWarps;
  if (n < 1 || warps < 1 || !make_layout(ndim, sizes, strides, axis_stride, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + warps - 1) / warps;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  prefix_sum_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(warps * 32),
                      static_cast<size_t>(warps * per_warp),
                      static_cast<cudaStream_t>(stream)>>>(x, lay, rows, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The same rows; out: float32 [rows].
extern "C" int xla_tree_sum(const float* x, int ndim, const int64_t* sizes,
                            const int64_t* strides, int64_t axis_stride, int64_t rows, int64_t n,
                            float* out, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  RowLayout lay;
  xla_order::SumLevels lv;
  const int level = sum_plan(n, &lv);
  if (n < 1 || level == 0 || !make_layout(ndim, sizes, strides, axis_stride, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lv.depth == 0) {
    const int64_t blocks = (rows + kSumThreads - 1) / kSumThreads;
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    tree_sum_short_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0, st>>>(x, lay, rows,
                                                                                 n, out);
  } else {
    if (rows > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    tree_sum_block_kernel<<<static_cast<unsigned>(rows), kSumThreads, 0, st>>>(x, lay, lv,
                                                                               level, out);
  }
  return static_cast<int>(cudaGetLastError());
}
