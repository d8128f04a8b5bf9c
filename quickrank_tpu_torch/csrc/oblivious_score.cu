// Oblivious (symmetric-tree) ensemble scoring, for sm_90a.
//
// Replaces quickrank_tpu/ops/pallas_oblivious.py::score_oblivious_pallas.
// Every level d of tree t tests one feature against one threshold for all
// docs, so a doc's leaf is the OR of its D comparison bits:
//   idx = 0;  for d in 0..D-1: idx = (idx << 1) | (x[fid[t][d]] > thr[t][d])
//   acc += wleaf[t][idx]
// with wleaf = leaf * weight built by the caller (each product rounded once,
// as the JAX package builds it).  The Pallas kernel selects the feature
// columns with a one-hot matmul over three bf16 planes and looks leaves up
// with 2^D masked accumulations, because a TPU has no cheap gather; here a
// thread reads x[fid] and compares it, which is exact by construction.  The
// sum over trees is a plain float32 sum in tree order (__fadd_rn, never
// contracted with the product), so the kernel is bitwise equal to its plain
// version (ops/oblivious.py); it is not Kahan-compensated, as the Pallas
// kernel's is not.  A value equal to its threshold routes left; a dead level
// carries FLT_MAX (or a bin no doc reaches) and routes left too.
//
// One thread scores one document, a block kThreads of them.  The block
// first stages its documents' rows in shared memory, feature-major
// (s_x[feature][doc], rows padded so the transposing writes spread over the
// banks): every thread of a warp tests the same feature, so a warp's 32
// reads of x[fid] are one conflict-free row of shared memory instead of 32
// scattered reads of global memory, and each feature byte leaves device
// memory once.  The model streams through shared memory in tiles of whole
// trees (fid and thr [tile, D], wleaf [tile, 2^D]; at most kModelTile
// bytes, so any tree count fits): fid and thr are read at one address per
// warp (broadcasts), wleaf at a data-dependent one.  Rows wider than shared
// memory holds (about 370 float32 features) are read from global memory
// through the same code (kStaged = false).  The same kernel scores binned
// docs (u8 bin ids against int32 bin thresholds), the form the bin matrix
// has on the card.
//
// Any depth.  Up to depth 12 a tree's tables fit a model tile.  From depth
// 13 one tree's leaf table alone (2^13 float32) fills kModelTile, so the
// tiles hold only fid and thr and a thread reads its leaf, wleaf[t, idx],
// from global memory (kLeafStaged = false): the L2 serves it, since the
// docs of a block read the same tree's table at once.  The terms and their
// order are the same, so that path is bitwise the plain version too.  The
// leaf index is a 32-bit int, so the kernel takes depths 1..31.
//
// What bounds it on an H100: the least the card could take is the feature
// matrix once over HBM (71 MB, 0.02 ms at 131,072 x 136).  The kernel is
// bound instead by shared-memory loads, about 3 D + 1 a tree and warp, at
// two blocks (8 warps) an SM; past depth 12 by the leaf reads from L2, one
// a tree and doc.  Later work: depth as a template parameter so fid and thr
// load as one vector each, and several docs a thread.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;            // docs a block
constexpr int kModelTile = 32 * 1024;    // model bytes staged at a time
constexpr int kSmemMax = 232448;         // one block's dynamic maximum
constexpr int kMaxDepth = 31;            // a leaf index is a 32-bit int

template <typename X, typename Th, bool kStaged, bool kLeafStaged>
__global__ void __launch_bounds__(kThreads)
oblivious_score_kernel(const X* __restrict__ x, int64_t n, int f,
                       const int32_t* __restrict__ fid,
                       const Th* __restrict__ thr,
                       const float* __restrict__ wleaf, int trees, int depth,
                       int tile_trees, int pitch, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int leaves = kLeafStaged ? 1 << depth : 0;  // leaves a staged tree
  int32_t* s_fid = reinterpret_cast<int32_t*>(smem);
  Th* s_thr = reinterpret_cast<Th*>(s_fid + tile_trees * depth);
  float* s_leaf = reinterpret_cast<float*>(s_thr + tile_trees * depth);
  X* s_x = reinterpret_cast<X*>(s_leaf + tile_trees * leaves);

  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t doc = doc0 + threadIdx.x;
  const bool live = doc < n;  // every thread stays for the barriers
  const X* row = x + (live ? doc : 0) * f;
  if (kStaged) {
    // the block's rows are one contiguous range: read it in order, write
    // it transposed; the first barrier of the tile loop publishes it
    const int docs = n - doc0 < kThreads ? static_cast<int>(n - doc0) : kThreads;
    const X* src = x + doc0 * f;
    for (int e = threadIdx.x; e < docs * f; e += kThreads) {
      const int d = e / f;
      s_x[(e - d * f) * pitch + d] = src[e];
    }
  }
  float acc = 0.f;
  for (int t0 = 0; t0 < trees; t0 += tile_trees) {
    const int tile = min(tile_trees, trees - t0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < tile * depth; i += kThreads) {
      s_fid[i] = fid[static_cast<int64_t>(t0) * depth + i];
      s_thr[i] = thr[static_cast<int64_t>(t0) * depth + i];
    }
    for (int i = threadIdx.x; i < tile * leaves; i += kThreads) {
      s_leaf[i] = wleaf[static_cast<int64_t>(t0) * leaves + i];
    }
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int t = 0; t < tile; ++t) {
        const int32_t* tf = s_fid + t * depth;
        const Th* tt = s_thr + t * depth;
        int idx = 0;
        for (int d = 0; d < depth; ++d) {
          const X v = kStaged ? s_x[tf[d] * pitch + threadIdx.x] : __ldg(row + tf[d]);
          idx = (idx << 1) | (static_cast<Th>(v) > tt[d] ? 1 : 0);
        }
        acc = __fadd_rn(acc, kLeafStaged
                                 ? s_leaf[t * leaves + idx]
                                 : __ldg(wleaf + (static_cast<int64_t>(t0 + t) << depth) + idx));
      }
    }
  }
  if (live) out[doc] = acc;
}

template <typename X, typename Th, bool kStaged, bool kLeafStaged>
int launch_kernel(const X* x, int64_t n, int f, const int32_t* fid, const Th* thr,
                  const float* wleaf, int trees, int depth, int tile_trees,
                  int pitch, size_t smem, float* out, cudaStream_t stream) {
  auto kernel = oblivious_score_kernel<X, Th, kStaged, kLeafStaged>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      x, n, f, fid, thr, wleaf, trees, depth, tile_trees, pitch, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename Th, bool kLeafStaged>
int launch_rows(const X* x, int64_t n, int64_t f, const int32_t* fid, const Th* thr,
                const float* wleaf, int trees, int depth, int tile_trees, size_t model,
                float* out, cudaStream_t stream) {
  // rows padded by one 32-bit word: the transposing writes of neighbouring
  // features then fall into neighbouring banks
  const int pitch = kThreads + 4 / static_cast<int>(sizeof(X));
  const size_t staged = model + static_cast<size_t>(f) * pitch * sizeof(X);
  const int fi = static_cast<int>(f);
  if (staged <= static_cast<size_t>(kSmemMax)) {
    return launch_kernel<X, Th, true, kLeafStaged>(x, n, fi, fid, thr, wleaf, trees, depth,
                                                   tile_trees, pitch, staged, out, stream);
  }
  return launch_kernel<X, Th, false, kLeafStaged>(x, n, fi, fid, thr, wleaf, trees, depth,
                                                  tile_trees, pitch, model, out, stream);
}

template <typename X, typename Th>
int launch(const void* x, int64_t n, int64_t f, const int32_t* fid,
           const void* thr, const float* wleaf, int trees, int depth,
           float* out, cudaStream_t stream) {
  // a tile holds whole trees' tables; past depth 12 only their fid and thr
  const int64_t per_tree = depth * 8 + (int64_t{4} << depth);
  const bool leaf_staged = per_tree <= kModelTile;
  const int64_t staged_tree = leaf_staged ? per_tree : depth * 8;
  const int tile_trees =
      static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(trees, kModelTile / staged_tree)));
  const size_t model = static_cast<size_t>(tile_trees) * staged_tree;
  const X* xs = static_cast<const X*>(x);
  const Th* th = static_cast<const Th*>(thr);
  if (leaf_staged) {
    return launch_rows<X, Th, true>(xs, n, f, fid, th, wleaf, trees, depth, tile_trees, model,
                                    out, stream);
  }
  return launch_rows<X, Th, false>(xs, n, f, fid, th, wleaf, trees, depth, tile_trees, model,
                                   out, stream);
}

}  // namespace

// x_kind: 0 = float32 features against float32 thresholds; 1 = uint8 bin
// ids against int32 bin thresholds.  Launches on `stream`;
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for an
// unknown x_kind, a depth outside [1, 31] or more than 2^31 - 1 features.
extern "C" int oblivious_score(const void* x, int x_kind, int64_t n, int64_t f,
                               const int32_t* fid, const void* thr,
                               const float* wleaf, int trees, int depth,
                               float* out, void* stream) {
  if (depth < 1 || depth > kMaxDepth || f > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case 0:
      return launch<float, float>(x, n, f, fid, thr, wleaf, trees, depth, out, s);
    case 1:
      return launch<uint8_t, int32_t>(x, n, f, fid, thr, wleaf, trees, depth, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
