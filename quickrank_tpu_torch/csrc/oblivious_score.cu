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
// kernel's is not.  A value equal to its threshold routes left; so do NaN
// and, for every finite value, a dead level, which carries FLT_MAX (or a
// bin no doc reaches).
//
// The model is read in the packed form trees/oblivious.py::pack_oblivious
// builds once per table: per tree one record of D pairs {fid, threshold
// bits} (float32 bits, or the int32 bin threshold), then the 2^D wleaf
// values, padded to whole 16-byte vectors (96 bytes at depth 4).  The same
// kernel scores binned docs (u8 bin ids against int32 bin thresholds).
//
// The design (depths 1..12, D a template parameter):
//   - a block of kDocs docs stages its rows in shared memory, feature-major,
//     read as 16-byte vectors (stage_rows.cuh).  Every thread of a warp
//     tests the same feature of 32 neighbouring docs: one conflict-free row;
//   - the records stream through shared memory in tiles of whole trees (at
//     most kModelTile bytes).  Staging a tile turns each fid into the byte
//     offset of its staged row, so the walk does no fid * pitch multiply;
//   - a tree's pairs load as 16-byte broadcasts (two at depth 4), its D
//     feature reads go out together (no chain: the bits are ORed after), and
//     its leaf is one read at a data-dependent address in 2^D neighbouring
//     words;
//   - each thread scores kInFlight trees at once, which gives the 8 warps
//     an SM holds (two blocks: 70 KB of rows each at 136 float32 features)
//     independent loads to hide their latency.  Each doc adds its leaves in
//     tree order.
// Rows wider than shared memory holds beside a tile (about 370 float32
// features) are read from global memory by the same kernel (kStaged =
// false), kDocsUnstaged docs a block so that a short batch still spreads
// over the SMs.  Past depth 12 one tree's leaf table alone (2^13 float32)
// fills a tile: a kernel with a runtime depth stages only the pairs, walks
// kInFlightDeep trees at once and reads each leaf, wleaf[t, idx], from the
// record in global memory (the L2 serves it: a block's docs read the same
// trees' tables at once).  The terms and their order are the same, so
// every path is bitwise the plain version.  The leaf index is a 32-bit
// int, so the kernel takes depths 1..31.
//
// Measured (scripts/profile_torch_kernels.py --sections 5, NVIDIA H100
// 80GB HBM3, 700.00 W; every candidate bitwise the plain version), ms a
// launch against the previous design of this file (one tree at a time,
// depth a runtime loop, fid and thresholds in two arrays, rows staged
// element by element): 1000 trees of depth 4 at 131,072 x 136 0.2509
// (0.6966), on u8 bins 0.2000 (0.4139); 200 x depth 6 0.1485 (0.2618);
// 64 x depth 4 at 8,192 x 700, rows from global memory, 0.0166 (0.0290);
// 1000 x depth 13 and 200 x depth 14 at 32,768 x 136 0.3932 and 0.0784
// (0.7624, 0.1219).  At depth 4: 2, 4, 8, 12 and 16 trees in flight 0.3935,
// 0.3603, 0.2738, 0.2509, 0.2833; 2 docs a thread (docs 32 apart, sharing
// a record's loads, at half the warps an SM) 0.4538 at 8 trees, 4 docs
// 0.7060.  Past depth 12, 1, 2, 4, 8 and 16 trees in flight: 0.7479,
// 0.4789, 0.4477, 0.3932, 0.6330 at depth 13.
//
// What bounds it on an H100: the least the card could take is the feature
// matrix once over HBM (71 MB, 0.0215 ms at 131,072 x 136).  The kernel is
// bound instead by the words shared memory delivers to a warp's registers
// (32 lanes x 4 bytes a clock an SM; a broadcast of 16 bytes costs four):
// per tree and warp 2 D for the pairs, D feature reads and one leaf, 13 at
// depth 4, or 0.23 ms for 4,096 warps x 1000 trees on 132 SMs at about
// 1.75 GHz (an estimate: ncu does not run on the card's host).  Past depth
// 12 the leaf reads from L2 bound it, one a tree and doc.  What is left:
// fewer record words a doc (16-bit offsets; several docs a thread where
// the rows are u8, whose blocks can stage 4x the docs at the same warps
// an SM).  A persistent kernel that stages the next block's rows while it
// scores was not built: by estimate (not measured) a block's 70 KB of rows
// take a few percent of its scoring time, and the SM's other block scores
// meanwhile.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kDocs = 128;               // docs a block, rows staged
// trees a thread scores at once and docs a thread, rows staged (threads a
// block: kDocs / kDocsPerThread); measured choices, see above
constexpr int kInFlight = 12;
constexpr int kDocsPerThread = 1;
// docs a block (a thread each) and trees in flight, rows read from global memory
constexpr int kDocsUnstaged = 64;
constexpr int kInFlightUnstaged = 8;
// trees in flight past depth 12 (the runtime-depth kernel)
constexpr int kInFlightDeep = 8;
constexpr int kModelTile = 32 * 1024;    // model bytes staged at a time
constexpr int kSmemMax = 232448;         // one block's dynamic maximum
constexpr int kMaxTemplatedDepth = 12;   // a tree's record fits a model tile
constexpr int kMaxDepth = 31;            // a leaf index is a 32-bit int

static_assert(kDocs % (32 * kDocsPerThread) == 0, "a block holds whole warps of docs");
static_assert(kDocsUnstaged % 32 == 0 && kDocsUnstaged <= 1024, "whole warps, one block");
static_assert(kInFlight >= 1 && kInFlightUnstaged >= 1 && kInFlightDeep >= 1,
              "trees in flight must be positive");

// 32-bit words of a tree's record: D pairs and 2^D leaves, in whole 16-byte
// vectors (trees/oblivious.py::record_words)
__host__ __device__ constexpr int64_t record_words(int depth) {
  return (2 * int64_t{depth} + (int64_t{1} << depth) + 3) / 4 * 4;
}

// trees a thread scores at once at depth D: k, or fewer where fewer records
// fit a tile
__host__ __device__ constexpr int group_trees(int depth, int k) {
  const int64_t fit = kModelTile / (record_words(depth) * 4);
  return fit < 1 ? 1 : (fit < k ? static_cast<int>(fit) : k);
}

template <typename X>
__device__ __forceinline__ int goes_right(X v, int thr_bits) {
  if constexpr (sizeof(X) == 4) {
    return v > __int_as_float(thr_bits) ? 1 : 0;
  } else {
    return static_cast<int>(v) > thr_bits ? 1 : 0;
  }
}

// Depth D <= 12.  packed: per tree kVec 16-byte words; a tile holds whole
// groups of G trees but the last.  P docs a thread: docs w*32*P + lane + 32 p
// of the block for warp w, p < P.
template <typename X, int D, bool kStaged, int K, int P, int kBlockDocs>
__global__ void __launch_bounds__(kBlockDocs / P)
oblivious_depth_kernel(const X* __restrict__ x, int64_t n, int f,
                       const int4* __restrict__ packed, int trees, int tile_trees,
                       int pitch, float* __restrict__ out) {
  constexpr int kThreads = kBlockDocs / P;
  constexpr int kVec = static_cast<int>(record_words(D) / 4);
  constexpr int kPairVecs = (2 * D + 3) / 4;
  constexpr int G = group_trees(D, K);
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_model = reinterpret_cast<int4*>(smem);
  X* s_x = reinterpret_cast<X*>(s_model + tile_trees * kVec);

  const int tid = threadIdx.x;
  const int dloc = (tid / 32) * 32 * P + tid % 32;
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * kBlockDocs;
  const bool live = doc0 + dloc < n;  // the thread's first doc; all stay for the barriers
  if (kStaged) qr::stage_rows<X, kBlockDocs, kThreads>(x, n, f, doc0, pitch, s_x);
  // staged: the thread's first doc in shared memory, offsets in bytes;
  // else the docs' rows, offsets in elements
  const unsigned char* mine = reinterpret_cast<const unsigned char*>(s_x + dloc);
  const X* rows[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t doc = doc0 + dloc + 32 * p;
    rows[p] = x + (doc < n ? doc : 0) * f;
  }
  const int scale = kStaged ? pitch * static_cast<int>(sizeof(X)) : 1;

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  for (int t0 = 0; t0 < trees; t0 += tile_trees) {
    const int tile = min(tile_trees, trees - t0);
    __syncthreads();  // the previous tile has been read by every thread
    const int4* src = packed + static_cast<int64_t>(t0) * kVec;
    for (int i = tid; i < tile * kVec; i += kThreads) {
      int4 v = __ldg(src + i);
      const int j = i % kVec;  // pairs 2j and 2j + 1 sit in vector j
      if (2 * j < D) v.x *= scale;
      if (2 * j + 1 < D) v.z *= scale;
      s_model[i] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int g = 0; g < tile; g += G) {
      int idx[G][P];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int4* rec = s_model + min(g + k, tile - 1) * kVec;
#pragma unroll
        for (int p = 0; p < P; ++p) idx[k][p] = 0;
#pragma unroll
        for (int j = 0; j < kPairVecs; ++j) {
          const int4 r = rec[j];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (2 * j + h < D) {
              const int off = h ? r.z : r.x;
              const int thr = h ? r.w : r.y;
#pragma unroll
              for (int p = 0; p < P; ++p) {
                const X v = kStaged ? *reinterpret_cast<const X*>(
                                          mine + off + 32 * p * static_cast<int>(sizeof(X)))
                                    : __ldg(rows[p] + off);
                idx[k][p] = (idx[k][p] << 1) | goes_right<X>(v, thr);
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (g + k < tile) {
          const float* leaves =
              reinterpret_cast<const float*>(s_model + (g + k) * kVec) + 2 * D;
#pragma unroll
          for (int p = 0; p < P; ++p) acc[p] = __fadd_rn(acc[p], leaves[idx[k][p]]);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t doc = doc0 + dloc + 32 * p;
    if (doc < n) out[doc] = acc[p];
  }
}

// Depth past 12, a runtime loop: the tiles hold the trees' pairs only, and
// a thread reads its leaves from the records in global memory.  One doc a
// thread, kDocs a block, G trees at once (a tile holds whole groups of G
// trees but the last), so that G chains of shared-memory loads and G leaf
// reads from L2 are in flight together.
template <typename X, bool kStaged, int G>
__global__ void __launch_bounds__(kDocs)
oblivious_deep_kernel(const X* __restrict__ x, int64_t n, int f,
                      const int32_t* __restrict__ packed, int64_t stride, int trees,
                      int depth, int tile_trees, int pitch, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_pair = reinterpret_cast<int2*>(smem);
  X* s_x = reinterpret_cast<X*>(s_pair + tile_trees * depth);

  const int tid = threadIdx.x;
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * kDocs;
  const int64_t doc = doc0 + tid;
  const bool live = doc < n;
  if (kStaged) qr::stage_rows<X, kDocs, kDocs>(x, n, f, doc0, pitch, s_x);
  const unsigned char* mine = reinterpret_cast<const unsigned char*>(s_x + tid);
  const X* row = x + (live ? doc : 0) * f;
  const int scale = kStaged ? pitch * static_cast<int>(sizeof(X)) : 1;

  float acc = 0.f;
  for (int t0 = 0; t0 < trees; t0 += tile_trees) {
    const int tile = min(tile_trees, trees - t0);
    __syncthreads();
    for (int i = tid; i < tile * depth; i += kDocs) {
      const int t = i / depth;
      int2 v = __ldg(reinterpret_cast<const int2*>(packed + (t0 + t) * stride) + (i - t * depth));
      v.x *= scale;
      s_pair[i] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int g = 0; g < tile; g += G) {
      const int2* tp[G];
      int idx[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        tp[k] = s_pair + min(g + k, tile - 1) * depth;
        idx[k] = 0;
      }
      for (int d = 0; d < depth; ++d) {
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const int2 r = tp[k][d];
          const X v = kStaged ? *reinterpret_cast<const X*>(mine + r.x) : __ldg(row + r.x);
          idx[k] = (idx[k] << 1) | goes_right<X>(v, r.y);
        }
      }
      float w[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int t = t0 + min(g + k, tile - 1);
        w[k] = __ldg(reinterpret_cast<const float*>(packed + t * stride + 2 * depth) + idx[k]);
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (g + k < tile) acc = __fadd_rn(acc, w[k]);
      }
    }
  }
  if (live) out[doc] = acc;
}

// How a launch scores: which kernel, its tile and shared memory.
struct Plan {
  bool templated;       // depth <= 12: oblivious_depth_kernel<D>
  bool staged;          // rows in shared memory
  int group;            // trees a thread scores at once
  int docs_per_thread;
  int block_docs;
  int tile;             // trees a model tile
  int pitch;            // elements a staged feature row
  size_t smem;
};

// trees a tile of `per_tree` bytes each: whole groups of `group` trees but
// the last, at most kModelTile bytes (one tree at the least)
int tile_trees_for(int trees, int64_t per_tree, int group) {
  int tile = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(std::max(trees, 1), kModelTile / per_tree)));
  if (tile > group) tile -= tile % group;
  return tile;
}

Plan make_plan(int elem_bytes, int64_t f, int trees, int depth) {
  Plan pl{};
  pl.templated = depth <= kMaxTemplatedDepth;
  pl.pitch = kDocs + 4 / elem_bytes;  // qr::stage_pitch
  const size_t rows = static_cast<size_t>(f) * pl.pitch * elem_bytes;
  if (pl.templated) {
    const int64_t per_tree = record_words(depth) * 4;
    pl.group = group_trees(depth, kInFlight);
    pl.tile = tile_trees_for(trees, per_tree, pl.group);
    pl.smem = static_cast<size_t>(pl.tile) * per_tree + rows;
    pl.staged = pl.smem <= static_cast<size_t>(kSmemMax);
    pl.docs_per_thread = kDocsPerThread;
    pl.block_docs = kDocs;
    if (!pl.staged) {
      pl.group = group_trees(depth, kInFlightUnstaged);
      pl.tile = tile_trees_for(trees, per_tree, pl.group);
      pl.smem = static_cast<size_t>(pl.tile) * per_tree;
      pl.docs_per_thread = 1;
      pl.block_docs = kDocsUnstaged;
    }
  } else {
    const int64_t per_tree = int64_t{depth} * 8;
    pl.group = kInFlightDeep;
    pl.tile = tile_trees_for(trees, per_tree, pl.group);
    pl.smem = static_cast<size_t>(pl.tile) * per_tree + rows;
    pl.staged = pl.smem <= static_cast<size_t>(kSmemMax);
    if (!pl.staged) pl.smem = static_cast<size_t>(pl.tile) * per_tree;
    pl.docs_per_thread = 1;
    pl.block_docs = kDocs;
  }
  return pl;
}

template <typename Kernel, typename... Args>
int launch_with(Kernel kernel, const Plan& pl, int64_t n, cudaStream_t stream, Args... args) {
  if (pl.smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int64_t blocks = (n + pl.block_docs - 1) / pl.block_docs;
  kernel<<<static_cast<unsigned int>(blocks), pl.block_docs / pl.docs_per_thread, pl.smem,
           stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, int D>
int launch_depth(const Plan& pl, const X* x, int64_t n, int f, const void* packed, int trees,
                 float* out, cudaStream_t s) {
  const int4* p4 = static_cast<const int4*>(packed);
  if (pl.staged) {
    return launch_with(oblivious_depth_kernel<X, D, true, kInFlight, kDocsPerThread, kDocs>,
                       pl, n, s, x, n, f, p4, trees, pl.tile, pl.pitch, out);
  }
  return launch_with(oblivious_depth_kernel<X, D, false, kInFlightUnstaged, 1, kDocsUnstaged>,
                     pl, n, s, x, n, f, p4, trees, pl.tile, pl.pitch, out);
}

template <typename X>
int launch(const void* xv, int64_t n, int64_t f64, const void* packed, int trees, int depth,
           float* out, cudaStream_t s) {
  const X* x = static_cast<const X*>(xv);
  const int f = static_cast<int>(f64);
  const Plan pl = make_plan(sizeof(X), f64, trees, depth);
  switch (depth) {
    case 1: return launch_depth<X, 1>(pl, x, n, f, packed, trees, out, s);
    case 2: return launch_depth<X, 2>(pl, x, n, f, packed, trees, out, s);
    case 3: return launch_depth<X, 3>(pl, x, n, f, packed, trees, out, s);
    case 4: return launch_depth<X, 4>(pl, x, n, f, packed, trees, out, s);
    case 5: return launch_depth<X, 5>(pl, x, n, f, packed, trees, out, s);
    case 6: return launch_depth<X, 6>(pl, x, n, f, packed, trees, out, s);
    case 7: return launch_depth<X, 7>(pl, x, n, f, packed, trees, out, s);
    case 8: return launch_depth<X, 8>(pl, x, n, f, packed, trees, out, s);
    case 9: return launch_depth<X, 9>(pl, x, n, f, packed, trees, out, s);
    case 10: return launch_depth<X, 10>(pl, x, n, f, packed, trees, out, s);
    case 11: return launch_depth<X, 11>(pl, x, n, f, packed, trees, out, s);
    case 12: return launch_depth<X, 12>(pl, x, n, f, packed, trees, out, s);
    default: break;
  }
  const int32_t* p = static_cast<const int32_t*>(packed);
  const int64_t stride = record_words(depth);
  if (pl.staged) {
    return launch_with(oblivious_deep_kernel<X, true, kInFlightDeep>, pl, n, s, x, n, f, p,
                       stride, trees, depth, pl.tile, pl.pitch, out);
  }
  return launch_with(oblivious_deep_kernel<X, false, kInFlightDeep>, pl, n, s, x, n, f, p,
                     stride, trees, depth, pl.tile, pl.pitch, out);
}

bool valid_shape(int x_kind, int64_t f, int trees, int depth) {
  return (x_kind == 0 || x_kind == 1) && depth >= 1 && depth <= kMaxDepth && f >= 1 &&
         f <= INT32_MAX && trees >= 0;
}

}  // namespace

// x [n, f]: x_kind 0 = float32 features against float32 thresholds; 1 = uint8
// bin ids against int32 bin thresholds.  packed: int32 [trees,
// record_words(depth)], 16-byte aligned (trees/oblivious.py::pack_oblivious).
// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown x_kind, a depth outside [1, 31], more
// than 2^31 - 1 features or a misaligned table.
extern "C" int oblivious_score(const void* x, int x_kind, int64_t n, int64_t f,
                               const void* packed, int trees, int depth, float* out,
                               void* stream) {
  if (!valid_shape(x_kind, f, trees, depth) ||
      (reinterpret_cast<uintptr_t>(packed) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_kind == 0 ? launch<float>(x, n, f, packed, trees, depth, out, s)
                     : launch<uint8_t>(x, n, f, packed, trees, depth, out, s);
}

// The design a launch with these arguments takes, into design[0..4]: 1 where
// depth is a template parameter (else the runtime-depth kernel, leaves from
// global memory), 1 where the rows are staged in shared memory, trees in
// flight, docs a thread, docs a block.  Returns cudaErrorInvalidValue where
// oblivious_score would.
extern "C" int oblivious_score_design(int x_kind, int64_t f, int trees, int depth,
                                      int* design) {
  if (!valid_shape(x_kind, f, trees, depth)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(x_kind == 0 ? 4 : 1, f, trees, depth);
  design[0] = pl.templated ? 1 : 0;
  design[1] = pl.staged ? 1 : 0;
  design[2] = pl.group;
  design[3] = pl.docs_per_thread;
  design[4] = pl.block_docs;
  return static_cast<int>(cudaSuccess);
}
