// QuickScorer ensemble scoring for trees of any depth, for sm_90a.
//
// Replaces quickrank_tpu/ops/pallas_qs.py::score_qs_pallas.  The Pallas
// kernel emulates the bitwise AND of leaf masks and the find-first on the
// TPU's matrix unit (block-diagonal and triangular matmuls over bf16 bit
// planes); here they are a 64-bit `&` and `__ffsll`, and the feature is
// compared in float32 directly.
//
// One thread scores one document over all trees, in slot order:
//   mask = all ones over the tree's leaves
//   for each internal node i: if (x[fid[i]] > thr[i]) mask &= ~excl[i]
//   exit = first set bit of mask;  d = leafval[t][exit]
// and folds w_t * d into a Kahan-compensated float32 sum exactly as the
// plain scorer (trees/qs.py) and the compensated descent
// (ops/scoring.py::score_ensemble) do: y = fma(w, d, -c) rounded once,
// then s + y and (t - s) - y each rounded on its own.  The explicit _rn
// intrinsics keep nvcc from contracting any other step.  The leaf sets of
// trees with more than 64 leaves take several words; the words are
// scanned left to right and the comparisons repeated per word, which
// keeps the mask in one register.
//
// What bounds it on an H100: per document about T * I scattered 4-byte
// reads of its own feature row (15k for 1000 trees of 16 leaves, all
// inside its 544-byte row), and table reads that every
// thread of a warp makes at the same address (broadcasts; 1000 x 16-leaf
// tables are ~0.25 MB and stay in L2).  Measured on an H100 SXM at 700 W:
// 31.3 ms for 1000 x 16-leaf trees at 131,072 docs x 136 features, and
// the same ~62 G feature reads/s at 64 and 128 leaves and in
// perfect_score.cu, so the feature-row reads bound it: ~1,000 docs per
// SM hold ~540 KB of rows, more than L1, and most reads go to L2.  Later
// work: stage a tile of document rows in shared memory (128 x 544 B =
// 70 KB), or give a warp a block of trees per document tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename X>
__global__ void qs_score_kernel(const X* __restrict__ x, int64_t n,
                                int64_t f, const int32_t* __restrict__ fid,
                                const float* __restrict__ thr,
                                const unsigned long long* __restrict__ excl,
                                const float* __restrict__ leafval,
                                const float* __restrict__ weight, int trees,
                                int nodes, int leaves, int words,
                                float* __restrict__ out) {
  const int64_t doc = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (doc >= n) return;
  const X* row = x + doc * f;
  float s = 0.f;
  float c = 0.f;
  for (int t = 0; t < trees; ++t) {
    const int32_t* tf = fid + static_cast<int64_t>(t) * nodes;
    const float* tt = thr + static_cast<int64_t>(t) * nodes;
    const unsigned long long* te = excl + static_cast<int64_t>(t) * nodes * words;
    int exit_leaf = 0;
    for (int w = 0; w < words; ++w) {
      unsigned long long mask = ~0ull;
      for (int i = 0; i < nodes; ++i) {
        if (static_cast<float>(__ldg(row + tf[i])) > tt[i]) mask &= ~te[static_cast<int64_t>(i) * words + w];
      }
      if (mask != 0ull) {
        exit_leaf = w * 64 + __ffsll(static_cast<long long>(mask)) - 1;
        break;
      }
    }
    const float d = leafval[static_cast<int64_t>(t) * leaves + exit_leaf];
    const float y = __fmaf_rn(weight[t], d, -c);
    const float sum = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(sum, s), y);
    s = sum;
  }
  out[doc] = s;
}

template <typename X>
int launch(const X* x, int64_t n, int64_t f, const int32_t* fid,
           const float* thr, const unsigned long long* excl,
           const float* leafval, const float* weight, int trees, int nodes,
           int leaves, int words, float* out, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  qs_score_kernel<X><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, n, f, fid, thr, excl, leafval, weight, trees, nodes, leaves, words,
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int qs_score(const float* x, int64_t n, int64_t f,
                        const int32_t* fid, const float* thr,
                        const unsigned long long* excl, const float* leafval,
                        const float* weight, int trees, int nodes, int leaves,
                        int words, float* out, void* stream) {
  return launch(x, n, f, fid, thr, excl, leafval, weight, trees, nodes, leaves,
                words, out, stream);
}

// The same scorer on uint8 bin ids, for bin-space tables (thresholds hold
// bin ids as float32, exact): rescoring the binned training matrix without a
// float32 copy of it.
extern "C" int qs_score_u8(const uint8_t* x, int64_t n, int64_t f,
                           const int32_t* fid, const float* thr,
                           const unsigned long long* excl, const float* leafval,
                           const float* weight, int trees, int nodes,
                           int leaves, int words, float* out, void* stream) {
  return launch(x, n, f, fid, thr, excl, leafval, weight, trees, nodes, leaves,
                words, out, stream);
}

extern "C" const char* qr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
