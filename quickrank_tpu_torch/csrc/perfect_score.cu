// Perfect-tree ensemble scoring (trees of depth D <= 5 embedded in heap
// form), for sm_90a.
//
// Replaces quickrank_tpu/ops/pallas_perfect.py::score_perfect_pallas.  The
// Pallas kernel selects feature columns with a one-hot matmul over three
// bf16 planes and builds leaf membership as products of bit planes, for
// the TPU's matrix and vector units; here a thread walks the heap:
//   h = 0;  D times: h = 2h + 1 + (x[fid[h]] > thr[h])
//   acc += wleaf[t][h - (2^D - 1)]
// with wleaf = leaf * weight built on the host.  The sum over trees is a
// plain float32 sum in tree order (__fadd_rn, never contracted), as the
// Pallas kernel's is; it is not Kahan-compensated.
//
// What bounds it on an H100: per document T * D dependent 4-byte reads of
// its own feature row (4000 for 1000 trees of depth 4) and table reads at
// one address per warp (broadcasts from L2; 1000 depth-5 trees are
// ~0.25 MB).  Measured on an H100 SXM at 700 W: 8.7 ms for 1000 depth-4
// trees at 131,072 docs x 136 features, ~60 G feature reads/s, the rate
// qs_score.cu reaches too: the feature-row reads from L2 bound it.  Later
// work: document rows staged in shared memory, or a warp per tree block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void perfect_score_kernel(const float* __restrict__ x, int64_t n,
                                     int64_t f,
                                     const int32_t* __restrict__ fid,
                                     const float* __restrict__ thr,
                                     const float* __restrict__ wleaf,
                                     int trees, int depth,
                                     float* __restrict__ out) {
  const int64_t doc = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (doc >= n) return;
  const float* row = x + doc * f;
  const int nodes = (1 << depth) - 1;
  const int leaves = 1 << depth;
  float acc = 0.f;
  for (int t = 0; t < trees; ++t) {
    const int32_t* tf = fid + static_cast<int64_t>(t) * nodes;
    const float* tt = thr + static_cast<int64_t>(t) * nodes;
    int h = 0;
    for (int d = 0; d < depth; ++d) {
      h = 2 * h + 1 + (__ldg(row + tf[h]) > tt[h] ? 1 : 0);
    }
    acc = __fadd_rn(acc, wleaf[static_cast<int64_t>(t) * leaves + h - nodes]);
  }
  out[doc] = acc;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int perfect_score(const float* x, int64_t n, int64_t f,
                             const int32_t* fid, const float* thr,
                             const float* wleaf, int trees, int depth,
                             float* out, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  perfect_score_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, n, f, fid, thr, wleaf, trees, depth, out);
  return static_cast<int>(cudaGetLastError());
}
