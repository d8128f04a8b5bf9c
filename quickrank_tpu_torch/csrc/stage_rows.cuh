// Staging of a block's document rows in shared memory, feature-major, for
// the scoring kernels qs_score.cu and perfect_score.cu.  X is float32, or a
// uint8 or uint16 bin id (qs_score.cu's bin-space entries).
//
// A block of kDocs docs holds rows [doc0, doc0 + kDocs) of x [n, f], one
// contiguous range of global memory.  It is read in order (as 16-byte
// vectors when the range starts on a 16-byte boundary, else element by
// element, and the tail past the last whole vector element by element) and
// written transposed, s_x[feature * pitch + doc].  With the pitch padded by
// one 32-bit word the transposing writes of neighbouring features fall into
// neighbouring banks, and a warp's reads of one feature for 32 neighbouring
// docs are one conflict-free row.  The caller's next barrier publishes it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qr {

// element j of a 16-byte vector of X, j a constant after unrolling
template <typename X>
__device__ __forceinline__ X vec_elem(const int4& raw, int j) {
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(X));
  const int k = j / kPerWord;
  const int word = k == 0 ? raw.x : k == 1 ? raw.y : k == 2 ? raw.z : raw.w;
  if constexpr (sizeof(X) == 4) {
    return static_cast<X>(__int_as_float(word));
  } else {
    constexpr int kBits = 8 * static_cast<int>(sizeof(X));
    return static_cast<X>((static_cast<unsigned int>(word) >> (kBits * (j % kPerWord))) &
                          ((1u << kBits) - 1u));
  }
}

// pitch (elements) of a staged feature row of kDocs docs
template <typename X>
constexpr int stage_pitch(int docs) {
  return docs + 4 / static_cast<int>(sizeof(X));
}

template <typename X, int kDocs, int kThreads>
__device__ __forceinline__ void stage_rows(const X* __restrict__ x, int64_t n, int f,
                                           int64_t doc0, int pitch, X* s_x) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(X));
  const int tid = threadIdx.x;
  const int docs = n - doc0 < kDocs ? static_cast<int>(n - doc0) : kDocs;
  const int total = docs * f;
  const X* src = x + doc0 * f;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    const int nvec = total / kVec;
    for (int v = tid; v < nvec; v += kThreads) {
      const int4 raw = __ldg(src4 + v);
      int d = (v * kVec) / f;
      int c = v * kVec - d * f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s_x[c * pitch + d] = vec_elem<X>(raw, j);
        if (++c == f) { c = 0; ++d; }
      }
    }
    done = nvec * kVec;
  }
  for (int e = done + tid; e < total; e += kThreads) {
    const int d = e / f;
    s_x[(e - d * f) * pitch + d] = src[e];
  }
}

}  // namespace qr
