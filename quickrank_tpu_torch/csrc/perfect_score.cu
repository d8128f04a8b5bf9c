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
// Pallas kernel's is; it is not Kahan-compensated.  A NaN feature goes left
// (x > thr is false), +inf goes right, and a pass-through node (thr =
// FLT_MAX) sends every finite value left, as in the plain version
// (trees/perfect.py::score_perfect).
//
// The design.  The first kernel (one thread a doc, D dependent reads of
// x[fid] from the doc's own row in global memory) ran at about 61 G reads/s,
// the rate the QuickScorer and oblivious kernels ran at before their rows
// were staged: a warp's 32 reads touched 32 rows.  Now
//   - a block of kDocs = 128 docs stages its rows in shared memory,
//     feature-major, read as 16-byte vectors (stage_rows.cuh); rows too
//     wide to stage beside a model tile (more than about 370 features) are
//     read from global memory by the same kernel (kStaged = false), chosen
//     from the shape;
//   - the model streams through shared memory in tiles of whole trees, in
//     the packed form trees/perfect.py::pack_perfect builds once per table:
//     per tree the 2^D - 1 node pairs {fid, thr bits} in heap order, then
//     the 2^D wleaf values, one 16-byte-aligned record (192 bytes at depth
//     4).  At level d the threads of a warp read at most 2^d neighbouring
//     8-byte pairs, and one broadcast at the root;
//   - the walk is a chain of D dependent pairs of shared-memory loads (the
//     node, then the feature).  Its latency is hidden by K trees walked at
//     once by each thread and L threads a doc: thread j of a doc walks the
//     tile's trees in groups of K, group j, j + L, ...  With one thread a
//     doc it adds the leaves in tree order itself; with several it parks
//     them in shared memory and, after a barrier, one thread a doc adds the
//     tile's leaves in tree order.  kAllTests = true instead tests all
//     2^D - 1 nodes of a tree with no chain (every thread of a warp on the
//     same node: broadcasts and conflict-free feature reads) and forms the
//     leaf from the bits.
// scripts/profile_torch_kernels.py rebuilds and times these; on an NVIDIA
// H100 80GB HBM3 at 700 W, 1000 trees of depth 4 at 131,072 docs x 136
// features: 0.4858 ms with one thread a doc and one tree in flight, 0.3481
// with 4 trees, 0.3265 with 8; 0.3628 with 4 threads a doc and 4 trees; all
// nodes tested 0.8163 (one thread) and 0.7252 (4 threads).  So staged rows
// get one thread a doc and 8 trees in flight (84 registers, no spill).  On
// rows read from global memory (1000 x depth 4 at 8,192 x 700) that takes
// 0.5021 ms and 4 threads a doc with 4 trees 0.2565: those get 4 and 4.
//
// What bounds it on an H100: the least the card could take is the feature
// matrix once over HBM (71 MB, 0.02 ms at 131,072 x 136).  The kernel is
// bound by shared-memory wavefronts: per tree and warp about 2 D loads on
// the walk (the feature reads of a level conflict where the warp's docs
// test different features) and one for the leaf.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kDocs = 128;               // docs a block
// threads a doc and trees a thread walks at once, for staged rows and for
// rows read from global memory (whose loads' latency wants more threads)
constexpr int kLanes = 1;
constexpr int kInFlight = 8;
constexpr int kLanesUnstaged = 4;
constexpr int kInFlightUnstaged = 4;
constexpr bool kAllTests = false;        // all nodes tested, no chain
constexpr int kModelTile = 40 * 1024;    // model bytes staged at a time
constexpr int kSmemMax = 232448;         // one block's dynamic maximum
constexpr int kMaxDepth = 5;

static_assert(kDocs * kLanes <= 1024 && kDocs * kLanesUnstaged <= 1024,
              "threads a doc must be 1..8");
static_assert(kInFlight >= 1 && kInFlightUnstaged >= 1, "trees in flight must be positive");

// leaf[k]: the leaf of the tree whose record starts at rec[k], k < K
template <int D, bool kStaged, int K>
__device__ __forceinline__ void walk(const int4* const* rec, const float* s_x,
                                     const float* row, int pitch, int dloc, int* leaf) {
  constexpr int kNodes = (1 << D) - 1;
  if (kAllTests) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unsigned int bits = 0;
#pragma unroll
      for (int j = 0; j < (kNodes + 1) / 2; ++j) {
        const int4 r = rec[k][j];  // nodes 2j and 2j + 1
        const float v0 = kStaged ? s_x[r.x * pitch + dloc] : __ldg(row + r.x);
        bits |= (v0 > __int_as_float(r.y) ? 1u : 0u) << (2 * j);
        if (2 * j + 1 < kNodes) {
          const float v1 = kStaged ? s_x[r.z * pitch + dloc] : __ldg(row + r.z);
          bits |= (v1 > __int_as_float(r.w) ? 1u : 0u) << (2 * j + 1);
        }
      }
      int h = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) h = 2 * h + 1 + static_cast<int>((bits >> h) & 1u);
      leaf[k] = h - kNodes;
    }
    return;
  }
  int h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) h[k] = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int2 r = reinterpret_cast<const int2*>(rec[k])[h[k]];
      const float v = kStaged ? s_x[r.x * pitch + dloc] : __ldg(row + r.x);
      h[k] = 2 * h[k] + 1 + (v > __int_as_float(r.y) ? 1 : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) leaf[k] = h[k] - kNodes;
}

// packed: per tree `stride4` 16-byte words (trees/perfect.py::pack_perfect);
// L threads a doc, each walking K trees at once
template <int D, bool kStaged, int L, int K>
__global__ void __launch_bounds__(kDocs * L, kDocs * L <= 512 ? 2 : 1)
perfect_score_kernel(const float* __restrict__ x, int64_t n, int f,
                     const int4* __restrict__ packed, int trees, int stride4,
                     int tile_trees, int pitch, float* __restrict__ out) {
  constexpr int kNodes = (1 << D) - 1;
  constexpr int kThreads = kDocs * L;
  constexpr int kGroup = L * K;  // trees a doc's threads walk at once
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_model = reinterpret_cast<int4*>(smem);
  float* s_d = reinterpret_cast<float*>(s_model + tile_trees * stride4);
  float* s_x = s_d + (L > 1 ? tile_trees * kDocs : 0);

  const int tid = threadIdx.x;
  const int dloc = tid % kDocs;   // a warp holds 32 neighbouring docs
  const int lane = tid / kDocs;   // and one tree lane
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * kDocs;
  const int64_t doc = doc0 + dloc;
  const bool live = doc < n;  // every thread stays for the barriers
  const float* row = x + (live ? doc : 0) * f;
  if (kStaged) qr::stage_rows<float, kDocs, kThreads>(x, n, f, doc0, pitch, s_x);

  float acc = 0.f;
  for (int t0 = 0; t0 < trees; t0 += tile_trees) {
    const int tile = min(tile_trees, trees - t0);
    __syncthreads();  // the previous tile has been read and folded
    const int4* src = packed + static_cast<int64_t>(t0) * stride4;
    for (int i = tid; i < tile * stride4; i += kThreads) s_model[i] = __ldg(src + i);
    __syncthreads();
    if (live) {
      for (int g = lane * K; g < tile; g += kGroup) {
        const int4* rec[K];
#pragma unroll
        for (int k = 0; k < K; ++k) rec[k] = s_model + min(g + k, tile - 1) * stride4;
        int leaf[K];
        walk<D, kStaged, K>(rec, s_x, row, pitch, dloc, leaf);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (g + k < tile) {
            const float w = reinterpret_cast<const float*>(
                reinterpret_cast<const int2*>(rec[k]) + kNodes)[leaf[k]];
            if (L == 1) {
              acc = __fadd_rn(acc, w);
            } else {
              s_d[(g + k) * kDocs + dloc] = w;
            }
          }
        }
      }
    }
    if (L > 1) {
      __syncthreads();
      if (live && lane == 0) {
        for (int t = 0; t < tile; ++t) acc = __fadd_rn(acc, s_d[t * kDocs + dloc]);
      }
    }
  }
  if (live && lane == 0) out[doc] = acc;
}

// trees a tile and the tile's shared bytes with L threads a doc, K trees in
// flight: a tile holds whole trees, their records and with several threads a
// doc one leaf value a tree and doc, and whole groups of L * K trees, so that
// no thread walks a tree twice
template <int L, int K>
int tile_trees_for(int trees, int stride4, size_t* bytes) {
  const size_t per_tree =
      static_cast<size_t>(stride4) * 16 + (L > 1 ? kDocs * sizeof(float) : 0);
  int tile = static_cast<int>(std::max<size_t>(
      1, std::min<size_t>(std::max(trees, 1), kModelTile / per_tree)));
  if (tile > L * K) tile -= tile % (L * K);
  *bytes = tile * per_tree;
  return tile;
}

template <int D, bool kStaged, int L, int K>
int launch_kernel(const float* x, int64_t n, int f, const int4* packed, int trees,
                  int stride4, int tile_trees, int pitch, size_t smem, float* out,
                  cudaStream_t stream) {
  auto kernel = perfect_score_kernel<D, kStaged, L, K>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int64_t blocks = (n + kDocs - 1) / kDocs;
  kernel<<<static_cast<unsigned int>(blocks), kDocs * L, smem, stream>>>(
      x, n, f, packed, trees, stride4, tile_trees, pitch, out);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const float* x, int64_t n, int f, const int4* packed, int trees,
           int stride4, float* out, cudaStream_t stream) {
  const int pitch = qr::stage_pitch<float>(kDocs);
  size_t model = 0;
  int tile = tile_trees_for<kLanes, kInFlight>(trees, stride4, &model);
  const size_t staged = model + static_cast<size_t>(f) * pitch * sizeof(float);
  if (staged <= static_cast<size_t>(kSmemMax)) {
    return launch_kernel<D, true, kLanes, kInFlight>(x, n, f, packed, trees, stride4,
                                                     tile, pitch, staged, out, stream);
  }
  tile = tile_trees_for<kLanesUnstaged, kInFlightUnstaged>(trees, stride4, &model);
  return launch_kernel<D, false, kLanesUnstaged, kInFlightUnstaged>(
      x, n, f, packed, trees, stride4, tile, pitch, model, out, stream);
}

}  // namespace

// x [n, f] float32 against the packed tables of trees/perfect.py::pack_perfect
// (int32 [trees, stride_words], 16-byte aligned) of trees of depth `depth`.
// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a depth outside [1, 5], a stride that does not
// hold a tree's record or more than 2^31 - 1 features.
extern "C" int perfect_score(const float* x, int64_t n, int64_t f, const void* packed,
                             int trees, int depth, int stride_words, float* out,
                             void* stream) {
  if (depth < 1 || depth > kMaxDepth || f < 1 || f > INT32_MAX || trees < 0 ||
      stride_words % 4 != 0 || stride_words < 3 * (1 << depth) - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int4* p4 = static_cast<const int4*>(packed);
  const int fi = static_cast<int>(f);
  const int s4 = stride_words / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1: return launch<1>(x, n, fi, p4, trees, s4, out, s);
    case 2: return launch<2>(x, n, fi, p4, trees, s4, out, s);
    case 3: return launch<3>(x, n, fi, p4, trees, s4, out, s);
    case 4: return launch<4>(x, n, fi, p4, trees, s4, out, s);
    default: return launch<5>(x, n, fi, p4, trees, s4, out, s);
  }
}
