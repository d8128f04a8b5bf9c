// Sums over one axis of a per-query view in an order fixed by construction,
// for sm_90a.
//
// Not a port of a TPU kernel: it serves metrics/core.py::query_sum on the
// card, where a query's lambda pairs and metric terms are summed.  CUDA's
// float32 reductions take their order from the tensor's shape and each
// row's alignment, so a query's sum would depend on which queries share its
// batch (its chunk, or its rank's block under query sharding).  Here the
// order is a pairwise tree over the axis padded with +0.0 to a power of two
// P: at each level h = P/2, P/4, ..., 1 element i takes x[i] + x[i + h].  It
// depends on the axis length only, so a row sums to the same bits in any
// batch.  The plain version is the same halving in PyTorch
// (ops/kernel_query_sum.py::pairwise_sum); every add is __fadd_rn.
//
// The view is [outer, length, inner] (the summed axis in the middle; inner
// = 1 for the last axis).  A row is one (outer, inner) pair; tpr threads of
// a block of 256 take a row (half its padded length, at most 256: a short
// row takes few threads and a block many rows) and hold up to kSmemRow
// elements of it in shared memory.  With inner = 1 a row's threads are
// adjacent (coalesced along the axis); otherwise adjacent threads take
// adjacent rows (coalesced along inner).  A row longer than kSmemRow is
// folded first: thread i adds x[i + k * kSmemRow] over k in registers, with
// the same halving order over k, which is the top levels of the tree.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemRow = 4096;
constexpr int kMaxFold = 16;

__global__ void __launch_bounds__(kThreads)
query_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t rows,
                 int64_t length, int64_t inner, int kept, int fold, int tpr) {
  extern __shared__ float s[];
  const int rpb = kThreads / tpr;
  int rib, lane;
  if (inner == 1) {
    rib = threadIdx.x / tpr;
    lane = threadIdx.x % tpr;
  } else {
    rib = threadIdx.x % rpb;
    lane = threadIdx.x / rpb;
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rpb + rib;
  const bool live = row < rows;
  const int64_t o = live ? row / inner : 0;
  const int64_t in = live ? row % inner : 0;
  const float* base = x + o * length * inner + in;
  float* sr = s + rib * kept;
  for (int i = lane; i < kept; i += tpr) {
    float buf[kMaxFold];
    for (int k = 0; k < fold; ++k) {
      const int64_t j = i + static_cast<int64_t>(k) * kept;
      buf[k] = (live && j < length) ? base[j * inner] : 0.0f;
    }
    for (int h = fold / 2; h >= 1; h /= 2)
      for (int k = 0; k < h; ++k) buf[k] = __fadd_rn(buf[k], buf[k + h]);
    sr[i] = buf[0];
  }
  __syncthreads();
  for (int h = kept / 2; h >= 1; h /= 2) {
    for (int i = lane; i < h; i += tpr) sr[i] = __fadd_rn(sr[i], sr[i + h]);
    __syncthreads();
  }
  if (live && lane == 0) out[row] = sr[0];
}

}  // namespace

// x: float32 [outer, length, inner] contiguous, rows = outer * inner;
// out: float32 [rows] in (outer, inner) order.
extern "C" int query_sum(const float* x, int64_t rows, int64_t length, int64_t inner,
                         float* out, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (length < 1 || inner < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t padded = 1;
  while (padded < length) padded <<= 1;
  const int kept = static_cast<int>(padded < kSmemRow ? padded : kSmemRow);
  const int64_t fold = padded / kept;
  if (fold > kMaxFold) return static_cast<int>(cudaErrorInvalidValue);
  int tpr = kept / 2;
  tpr = tpr < 1 ? 1 : (tpr > kThreads ? kThreads : tpr);
  const int rpb = kThreads / tpr;
  const int64_t blocks = (rows + rpb - 1) / rpb;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rpb) * kept * sizeof(float);
  query_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, length, inner, kept, static_cast<int>(fold), tpr);
  return static_cast<int>(cudaGetLastError());
}
