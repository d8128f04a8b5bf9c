// QuickScorer ensemble scoring for trees of any depth, for sm_90a.
//
// Replaces quickrank_tpu/ops/pallas_qs.py::score_qs_pallas.  The Pallas
// kernel emulates the bitwise AND of leaf masks and the find-first on the
// TPU's matrix unit (block-diagonal and triangular matmuls over bf16 bit
// planes); here they are a 64-bit `&` and `__ffsll`, and the feature is
// compared in float32 directly.
//
// What is computed, per document and tree, in slot order:
//   mask = all ones over the tree's leaves
//   for each internal node i: if (x[fid[i]] > thr[i]) mask &= ~excl[i]
//   exit = first set bit of mask;  d = leafval[t][exit]
// and w_t * d is folded into a Kahan-compensated float32 sum exactly as the
// plain scorer (trees/qs.py) and the compensated descent
// (ops/scoring.py::score_ensemble) do: y = fma(w, d, -c) rounded once,
// then s + y and (t - s) - y each rounded on its own.  The explicit _rn
// intrinsics keep nvcc from contracting any other step.  Every node is
// tested, dead slots (thr = FLT_MAX, weight 0) take their Kahan step.  The
// leaf sets of trees with more than 64 leaves take several words; the words
// are scanned left to right and the comparisons repeated per word, which
// keeps the mask in one register pair.
//
// The design.  The first kernel (one thread a doc, x[fid] read from global
// memory) ran at 62 G feature reads/s at every shape: a warp's 32 reads of
// x[fid] touched 32 different rows, 32 sectors for 128 useful bytes.  Now
//   - a block of kDocs = 128 docs stages its rows in shared memory,
//     feature-major (s_x[feature][doc], the pitch padded by one 32-bit
//     word): the block's rows are one contiguous range of global memory,
//     read in order as 16-byte vectors, so each feature byte leaves device
//     memory once; every thread of a warp tests the same node, so
//     s_x[fid * pitch + doc] is one conflict-free row of shared memory;
//   - the model streams through shared memory in tiles of whole trees, in
//     the packed form trees/qs.py::pack_tables builds once per table: a
//     16-byte record {fid, thr, excl word} a node and word (one LDS.128
//     broadcast in place of three loads from three arrays), then the
//     tree's leaf values and its weight;
//   - a doc is given to kLanes threads.  The exit leaf of tree t depends on
//     nothing before it, only the Kahan fold is ordered: thread j of a doc
//     finds the exit leaves of the tile's trees t = j, j + kLanes, ... and
//     leaves d_t in shared memory; after a barrier one thread a doc folds
//     the tile in slot order.  That buys kLanes times the warps for the
//     same staged rows.  scripts/profile_torch_kernels.py builds and times
//     kLanes = 1, 2, 4 and 8: on an NVIDIA H100 80GB HBM3 at 700 W, at 1000
//     trees of 16 leaves and 131,072 docs x 136 features, 1.68, 1.41, 1.32
//     and 1.46 ms (62 registers and no spill at 4; 8 halves the blocks an SM
//     holds), so 4 was taken;
//   - rows too wide to stage beside a model tile (more than about 370
//     float32 features) are read from global memory by the same kernel
//     (kStaged = false), chosen from the shape;
//   - a tree whose records do not fit a block's shared memory (about 950
//     leaves and more; the records grow as leaves^2 / 4 bytes) goes to
//     qs_score_wide_kernel, whose tiles are runs of one tree's records (see
//     there), so any width is scored, as the JAX package scores it.
// The same kernels score uint8 or uint16 bin ids against bin-space tables
// (thresholds hold bin ids as float32, exact up to 2^24): the warm-start
// rescore of the binned training matrix and DART's fold scores, on the
// training wire itself (u8 up to 256 bins, u16 up to 65,536), without a
// float32 copy of it.  A staged u16 row takes 16-byte reads of 8 ids.
//
// What bounds it on an H100: the least the card could take is the feature
// matrix once over HBM (71 MB, 0.02 ms at 131,072 x 136).  The kernel is
// bound by its instruction rate and shared-memory loads: per node and warp
// one LDS.128 broadcast, one LDS of the feature row, a compare and two
// mask words, T * I times a doc (15,000 at 1000 trees of 16 leaves: 1.30 ms
// on an NVIDIA H100 80GB HBM3 at 700 W, 1.5e12 node tests a second, where
// the first kernel took 31.5 ms).
//
// The partial entry (qs_partial, qs_partial_u8 and _u16) runs the same
// kernels with kPartial set: in place of the fold it writes out[doc, t] =
// d_t, the unweighted exit-leaf value of every tree (trees/qs.py::
// partial_scores_qs; the per-tree columns of Mart.partial_scores_dataset
// and of a warm-started DART run's contributions).  The parked values of
// a tile are written after its barrier by all threads of the block,
// consecutive threads on consecutive trees of one doc, so the [n, trees]
// rows leave in runs; the parking pitch is then kDocs + 1, which keeps
// those reads off one bank.
// A caller scores a range of slots by passing the range's first record and
// its length, so a large ensemble is taken in chunks of trees.
// Later work: 32-bit masks for trees of at most 32 leaves.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kDocs = 128;                // docs a block
constexpr int kLanes = 4;                 // threads a doc
constexpr int kThreads = kDocs * kLanes;
constexpr int kModelTile = 40 * 1024;     // model bytes staged at a time
constexpr int kWideRecords = 2048;        // records a tile of a tree that spans tiles
constexpr int kSmemMax = 232448;          // one block's dynamic maximum

static_assert(kLanes >= 1 && kThreads <= 1024, "kLanes must be 1..8");

// s, c <- Kahan step of w * d (see the note above; never contracted)
__device__ inline void kahan_step(float& s, float& c, float w, float d) {
  const float y = __fmaf_rn(w, d, -c);
  const float sum = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(sum, s), y);
  s = sum;
}

// packed: per tree `stride4` 16-byte words: nodes * words records
// {fid, thr bits, excl low, excl high} (word-major: record w * nodes + i),
// then `leaves` float32 leaf values and the float32 weight.
// With kPartial the exit-leaf values are written to out [n, trees] in
// place of the fold (see the note above).
template <typename X, bool kStaged, bool kPartial>
__global__ void __launch_bounds__(kThreads, kThreads <= 512 ? 2 : 1)
qs_score_kernel(const X* __restrict__ x, int64_t n, int f,
                const int4* __restrict__ packed, int trees, int nodes,
                int leaves, int words, int stride4, int tile_trees, int pitch,
                float* __restrict__ out) {
  static_assert(!kPartial || kLanes > 1, "the partial entry parks every value");
  constexpr int kDPitch = kDocs + (kPartial ? 1 : 0);  // parked values a tree
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_model = reinterpret_cast<int4*>(smem);
  float* s_d = reinterpret_cast<float*>(s_model + tile_trees * stride4);
  X* s_x = reinterpret_cast<X*>(s_d + (kLanes > 1 ? tile_trees * kDPitch : 0));

  const int tid = threadIdx.x;
  const int dloc = tid % kDocs;   // a warp holds 32 neighbouring docs
  const int lane = tid / kDocs;   // and one tree lane
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * kDocs;
  const int64_t doc = doc0 + dloc;
  const bool live = doc < n;  // every thread stays for the barriers
  const X* row = x + (live ? doc : 0) * f;

  if (kStaged) qr::stage_rows<X, kDocs, kThreads>(x, n, f, doc0, pitch, s_x);

  float s = 0.f;
  float c = 0.f;
  for (int t0 = 0; t0 < trees; t0 += tile_trees) {
    const int tile = min(tile_trees, trees - t0);
    __syncthreads();  // the previous tile has been read and folded
    const int4* src = packed + static_cast<int64_t>(t0) * stride4;
    for (int i = tid; i < tile * stride4; i += kThreads) s_model[i] = __ldg(src + i);
    __syncthreads();
    if (live) {
      for (int t = lane; t < tile; t += kLanes) {
        const int4* rec = s_model + t * stride4;
        int exit_leaf = 0;
        for (int w = 0; w < words; ++w) {
          unsigned int lo = ~0u, hi = ~0u;
#pragma unroll 5
          for (int i = 0; i < nodes; ++i) {
            const int4 r = rec[i];
            const float v = static_cast<float>(
                kStaged ? s_x[r.x * pitch + dloc] : __ldg(row + r.x));
            if (v > __int_as_float(r.y)) {
              lo &= ~static_cast<unsigned int>(r.z);
              hi &= ~static_cast<unsigned int>(r.w);
            }
          }
          rec += nodes;
          if (lo != 0u) {
            exit_leaf = w * 64 + __ffs(static_cast<int>(lo)) - 1;
            break;
          }
          if (hi != 0u) {
            exit_leaf = w * 64 + 32 + __ffs(static_cast<int>(hi)) - 1;
            break;
          }
        }
        const float* tail =
            reinterpret_cast<const float*>(s_model + t * stride4 + nodes * words);
        const float d = tail[exit_leaf];
        if (kLanes == 1) {
          kahan_step(s, c, tail[leaves], d);
        } else {
          s_d[t * kDPitch + dloc] = d;
        }
      }
    }
    if (kPartial) {
      __syncthreads();
      const int docs = n - doc0 < kDocs ? static_cast<int>(n - doc0) : kDocs;
      for (int i = tid; i < docs * tile; i += kThreads) {
        const int dd = i / tile;
        const int t = i - dd * tile;
        out[(doc0 + dd) * trees + t0 + t] = s_d[t * kDPitch + dd];
      }
    } else if (kLanes > 1) {
      __syncthreads();
      if (live && lane == 0) {
        for (int t = 0; t < tile; ++t) {
          const float* tail =
              reinterpret_cast<const float*>(s_model + t * stride4 + nodes * words);
          kahan_step(s, c, tail[leaves], s_d[t * kDocs + dloc]);
        }
      }
    }
  }
  if (!kPartial && live && lane == 0) out[doc] = s;
}

// A tree whose packed records do not fit one block's shared memory (from
// about 950 leaves): the trees one at a time, each tree's records streamed
// in tiles of kWideRecords.  The records are word-major, so a tile is a run
// of whole words and at most one word begun and one left unfinished.  The
// kLanes threads of a doc split every word's nodes (node i to thread
// i % kLanes) and carry their part of the word's AND across tiles in
// registers; where the word ends, each ANDs its part into the doc's slot of
// that word in shared memory.  After the tile's barrier one thread a doc
// takes the words that ended in the tile in order and keeps the first whose
// mask is not zero: its first set bit is the exit leaf, as in the narrow
// kernel.  The tree's remaining tiles are skipped once every doc of the
// block has its exit leaf.  Then that thread takes the Kahan step with the
// leaf value and the weight read from global memory, so the trees are folded
// in slot order with the same steps; with kPartial it writes the leaf value
// to out [n, trees] instead.
template <typename X, bool kStaged, bool kPartial>
__global__ void __launch_bounds__(kThreads, kThreads <= 512 ? 2 : 1)
qs_score_wide_kernel(const X* __restrict__ x, int64_t n, int f,
                     const int4* __restrict__ packed, int trees, int nodes,
                     int leaves, int words, int stride4, int ends, int pitch,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_model = reinterpret_cast<int4*>(smem);
  // per word ending in the tile: the doc's AND, low halves then high halves
  unsigned int* s_and = reinterpret_cast<unsigned int*>(s_model + kWideRecords);
  int* s_exit = reinterpret_cast<int*>(s_and + ends * 2 * kDocs);  // -1: not found yet
  X* s_x = reinterpret_cast<X*>(s_exit + kDocs);

  const int tid = threadIdx.x;
  const int dloc = tid % kDocs;
  const int lane = tid / kDocs;
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * kDocs;
  const int64_t doc = doc0 + dloc;
  const bool live = doc < n;  // every thread stays for the barriers
  const X* row = x + (live ? doc : 0) * f;

  if (kStaged) qr::stage_rows<X, kDocs, kThreads>(x, n, f, doc0, pitch, s_x);

  const int records = nodes * words;
  float s = 0.f;
  float c = 0.f;
  for (int t = 0; t < trees; ++t) {
    const int4* tree = packed + static_cast<int64_t>(t) * stride4;
    unsigned int lo = ~0u, hi = ~0u;  // this thread's part of the current word
    for (int r0 = 0; r0 < records; r0 += kWideRecords) {
      const int r1 = min(records, r0 + kWideRecords);
      const int w0 = r0 / nodes;
      __syncthreads();  // the previous tile and its slots have been read
      for (int i = tid; i < r1 - r0; i += kThreads) s_model[i] = __ldg(tree + r0 + i);
      for (int i = tid; i < ends * 2 * kDocs; i += kThreads) s_and[i] = ~0u;
      if (r0 == 0 && tid < kDocs) s_exit[tid] = -1;
      __syncthreads();
      if (live && s_exit[dloc] < 0) {
        for (int w = w0; w * nodes < r1; ++w) {
          const int base = w * nodes;
          const int end = min(r1, base + nodes);
          int r = max(r0, base);
          r += (lane - (r - base) % kLanes + kLanes) % kLanes;  // this thread's first node
          for (; r < end; r += kLanes) {
            const int4 q = s_model[r - r0];
            const float v = static_cast<float>(
                kStaged ? s_x[q.x * pitch + dloc] : __ldg(row + q.x));
            if (v > __int_as_float(q.y)) {
              lo &= ~static_cast<unsigned int>(q.z);
              hi &= ~static_cast<unsigned int>(q.w);
            }
          }
          if (end == base + nodes) {  // the word ends in this tile
            unsigned int* slot = s_and + (w - w0) * 2 * kDocs;
            atomicAnd(slot + dloc, lo);
            atomicAnd(slot + kDocs + dloc, hi);
            lo = hi = ~0u;
          }
        }
      }
      __syncthreads();
      if (live && lane == 0 && s_exit[dloc] < 0) {
        for (int w = w0; (w + 1) * nodes <= r1; ++w) {
          const unsigned int* slot = s_and + (w - w0) * 2 * kDocs;
          if (slot[dloc] != 0u) {
            s_exit[dloc] = w * 64 + __ffs(static_cast<int>(slot[dloc])) - 1;
            break;
          }
          if (slot[kDocs + dloc] != 0u) {
            s_exit[dloc] = w * 64 + 32 + __ffs(static_cast<int>(slot[kDocs + dloc])) - 1;
            break;
          }
        }
      }
      if (__syncthreads_and(lane != 0 || !live || s_exit[dloc] >= 0)) break;
    }
    if (live && lane == 0) {
      const float* tail = reinterpret_cast<const float*>(tree + records);
      if (kPartial) {
        out[doc * trees + t] = __ldg(tail + s_exit[dloc]);
      } else {
        kahan_step(s, c, __ldg(tail + leaves), __ldg(tail + s_exit[dloc]));
      }
    }
  }
  if (!kPartial && live && lane == 0) out[doc] = s;
}

template <typename... P, typename... A>
int launch_kernel(void (*kernel)(P...), int64_t n, size_t smem, cudaStream_t stream,
                  A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int64_t blocks = (n + kDocs - 1) / kDocs;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, bool kPartial>
int launch(const X* x, int64_t n, int64_t f, const void* packed, int trees,
           int nodes, int leaves, int words, int stride_words, float* out,
           void* stream) {
  if (trees < 0 || nodes < 1 || leaves < 1 || words < 1 || f < 1 || f > INT32_MAX ||
      stride_words % 4 != 0 || stride_words < nodes * words * 4 + leaves + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int stride4 = stride_words / 4;
  // rows padded by one 32-bit word: the transposing writes of neighbouring
  // features then fall into neighbouring banks
  const int pitch = qr::stage_pitch<X>(kDocs);
  const size_t rows = static_cast<size_t>(f) * pitch * sizeof(X);
  const int4* p4 = static_cast<const int4*>(packed);
  const int fi = static_cast<int>(f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a tile holds whole trees: their records, and with several threads a
  // doc one exit-leaf value a tree and doc (kDocs + 1 of them, partial)
  const size_t parked = kLanes > 1 ? (kDocs + (kPartial ? 1 : 0)) * sizeof(float) : 0;
  const size_t per_tree = static_cast<size_t>(stride4) * 16 + parked;
  if (per_tree > static_cast<size_t>(kSmemMax)) {
    // a tree spans tiles: the words that end in a tile, at most this many
    const int ends = kWideRecords / nodes + 1;
    const size_t model = static_cast<size_t>(kWideRecords) * 16 +
                         (static_cast<size_t>(ends) * 2 + 1) * kDocs * 4;
    if (model + rows <= static_cast<size_t>(kSmemMax)) {
      return launch_kernel(qs_score_wide_kernel<X, true, kPartial>, n, model + rows, s, x, n, fi,
                           p4, trees, nodes, leaves, words, stride4, ends, pitch, out);
    }
    return launch_kernel(qs_score_wide_kernel<X, false, kPartial>, n, model, s, x, n, fi, p4,
                         trees, nodes, leaves, words, stride4, ends, pitch, out);
  }
  const int tile_trees = static_cast<int>(std::max<size_t>(
      1, std::min<size_t>(std::max(trees, 1), kModelTile / per_tree)));
  const size_t model = tile_trees * per_tree;
  if (model + rows <= static_cast<size_t>(kSmemMax)) {
    return launch_kernel(qs_score_kernel<X, true, kPartial>, n, model + rows, s, x, n, fi, p4,
                         trees, nodes, leaves, words, stride4, tile_trees, pitch, out);
  }
  return launch_kernel(qs_score_kernel<X, false, kPartial>, n, model, s, x, n, fi, p4, trees,
                       nodes, leaves, words, stride4, tile_trees, pitch, out);
}

}  // namespace

// x [n, f] float32 against the packed tables of trees/qs.py::pack_tables
// (int32 [trees, stride_words], 16-byte aligned).  Launches on `stream`;
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// table whose stride does not hold its records.
extern "C" int qs_score(const float* x, int64_t n, int64_t f, const void* packed,
                        int trees, int nodes, int leaves, int words,
                        int stride_words, float* out, void* stream) {
  return launch<float, false>(x, n, f, packed, trees, nodes, leaves, words,
                              stride_words, out, stream);
}

// The same scorer on uint8 bin ids, for bin-space tables.
extern "C" int qs_score_u8(const uint8_t* x, int64_t n, int64_t f,
                           const void* packed, int trees, int nodes, int leaves,
                           int words, int stride_words, float* out, void* stream) {
  return launch<uint8_t, false>(x, n, f, packed, trees, nodes, leaves, words,
                                stride_words, out, stream);
}

// The same scorer on uint16 bin ids (more than 256 bins).
extern "C" int qs_score_u16(const uint16_t* x, int64_t n, int64_t f,
                            const void* packed, int trees, int nodes, int leaves,
                            int words, int stride_words, float* out, void* stream) {
  return launch<uint16_t, false>(x, n, f, packed, trees, nodes, leaves, words,
                                 stride_words, out, stream);
}

// The partial entry: out [n, trees] float32, row-major, out[doc, t] the
// unweighted exit-leaf value of tree t (no weights, no sum).  `packed`
// points at the first record of the slots to score, `trees` is their count.
extern "C" int qs_partial(const float* x, int64_t n, int64_t f, const void* packed,
                          int trees, int nodes, int leaves, int words,
                          int stride_words, float* out, void* stream) {
  return launch<float, true>(x, n, f, packed, trees, nodes, leaves, words,
                             stride_words, out, stream);
}

extern "C" int qs_partial_u8(const uint8_t* x, int64_t n, int64_t f,
                             const void* packed, int trees, int nodes, int leaves,
                             int words, int stride_words, float* out, void* stream) {
  return launch<uint8_t, true>(x, n, f, packed, trees, nodes, leaves, words,
                               stride_words, out, stream);
}

extern "C" int qs_partial_u16(const uint16_t* x, int64_t n, int64_t f,
                              const void* packed, int trees, int nodes, int leaves,
                              int words, int stride_words, float* out, void* stream) {
  return launch<uint16_t, true>(x, n, f, packed, trees, nodes, leaves, words,
                                stride_words, out, stream);
}

extern "C" const char* qr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
