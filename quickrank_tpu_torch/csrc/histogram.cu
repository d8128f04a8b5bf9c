// Split-statistics histograms for sm_90a: the per-node packed histogram
// (K4) and the plain histogram (K5), one kernel template for both.
//
// Replaces quickrank_tpu/ops/pallas_histogram.py::node_histogram_pallas
// (K4: hist[f, b, i*C + c] = sum over docs with pos == n0 + i of
// values[c, n] * [binned[n, f] == b]) and ::histogram_pallas (K5: the same
// with every doc in node 0 and doc-major values, used by
// trees/grow.py::segment_sums with one column of node ids).  The Pallas
// kernels contract a [C, tile] block of bf16 hi/lo value planes against a
// one-hot [tile, G*B] block on the TPU's matrix unit; the card needs no
// one-hot: each doc adds its values straight into its bin.
//
// Determinism.  Float atomics would add in a different order from launch
// to launch, and a near-tie gain could then flip a split between two runs.
// So every value is rounded once to a 64-bit fixed-point integer with a
// per-channel power-of-two scale, and all sums are integer adds, which
// give the same bits in any order:
//   scale_c = 2^(62 - e_c - nb), where max_n |v[c, n]| < 2^e_c and the doc
//   count n < 2^nb, so no partial sum of any bin reaches 2^62;
//   q = round(v * scale_c) (exact scaling, one rounding, in double);
//   out = float(double(sum q) / scale_c).
// The rounding error per value is at most 2^(e_c + nb - 63), about 2^-40
// of the channel's largest |value| at 2.56M docs.  It is absolute: a bin
// whose few values are all tiny next to that largest one keeps fewer
// significant bits than a float32 sum would
// (ops/kernel_histogram.py::rounding_error states the bound).  A
// non-finite value makes its channel NaN.
//
// Layout of the work.  The first kernel gave a block a group of features
// and walked its docs one a thread: all 32 lanes of a warp were on the same
// feature, so lanes whose docs shared a bin hit the same cell and their
// atomics serialized; a doc outside the node idled its lane through the
// feature loop; and the bins were read a byte at a time at a 160-byte
// stride.  scripts/profile_torch_kernels.py splits that kernel's time on
// the card (PERF.md holds the split).  Now block (g, i, s) holds the
// histograms of features [32 g, 32 g + 32) for ONE node slot i, and takes
// every s-th round of 4 * blockDim docs (rounds are dealt to the blocks in
// turn, so any order of the docs spreads evenly), in two steps:
//   compact: a thread reads the node ids of its four docs of the next round
//     while it works on this one's, drops a doc of another node (or one
//     whose values all round to 0), rounds the doc's C values to fixed
//     point, and a ballot + popcount pass (the block's count comes with the
//     barrier, __syncthreads_count; the warps' counts are scanned with
//     shuffles) packs the docs that are left into a dense list in shared
//     memory: doc index and C integers, once a doc and block.  Docs join
//     the list until it is full, so a stretch with no doc of the node costs
//     its node ids and one barrier a blockDim docs;
//   add: when the list is full (and at the end) a warp takes one doc of it
//     and its 32 lanes take the 32 features: the doc's integers are a
//     broadcast read, the bins are 32 neighbouring bytes of one row (one
//     sector), four docs' reads in flight, and the 32 atomics of an
//     instruction go to 32 different histograms, so they can never share an
//     address.  Every lane is live whatever the order of the docs.
// Node slots are a grid dimension, so a pass over k nodes (level-wise,
// best-k and oblivious growth) keeps the same mapping with k times the
// blocks; each block reads the node ids of its rounds again, which stay in
// L2.  Where 32 features' cells do not fit shared memory (C * B * 8 bytes a
// feature: more than 7 KB), a block takes 16, 8, ... features and a warp 2,
// 4, ... docs at a time; with one feature (K5: one column of slot ids) that
// is the old doc-a-lane mapping over the dense list.  The kernel is
// compiled for each channel count, so a doc's values stay in registers.
//
// The scale is an input.  A launch takes the channels' max-bits words and
// the doc count n of the scale, writes the int64 accumulator, and
// histogram_to_float converts it with the same bits and n: one entry for a
// single device (the launch's own max |value| and row count, which
// ops/kernel_histogram.py computes) and for query sharding, where every rank
// holds a shard of the docs and the ranks must sum each bin as one launch
// over all the docs would.  There the bits are the ranks' all-reduced max
// and n the real docs over all ranks (pad rows carry zeros, so that count
// bounds every sum); the ranks add their accumulators as integers before
// the conversion.  Integer adds are exact and order-free, so the reduced
// histogram is bit for bit that of one rank over all the docs, and no
// partial sum of real values reaches 2^62 (no wrap).
//
// A cell is two 32-bit words kept in two arrays (low words, high words)
// with a feature's words padded to 1 mod 32, so lanes on different
// features with equal bins fall into different banks, and all 32 banks
// serve either word.  Shared-memory 64-bit sums accumulate through 32-bit
// atomics with a carry (add_doc), the low adds of a doc's channels started
// before the high ones; then each block adds its non-zero cells into a
// global int64 accumulator with global atomics, and a last pass converts to
// float32.  A bin id >= num_bins is dropped per element.
//
// What bounds it on an H100: per pass it reads the u8 bins of the docs in
// range (N x W bytes, 410 MB at 2.56M docs x 160 columns, when all are in
// range: 0.13 ms) and does one or two shared-memory atomics per (doc,
// feature, channel): 1.2e9 adds, about 2e9 atomics, at 2.56M docs x 160 x
// 3.  The histograms of 32 features fill an SM's shared memory, so one
// block of 32 warps is all an SM holds: the kernel is bound by the latency
// of its bin reads and of its atomics (scripts/profile_torch_kernels.py on
// an NVIDIA H100 80GB HBM3 at 700 W, at the root pass, 1.64 ms where the
// first kernel took 5.9: half the threads take 1.6x the time, one doc in
// flight 1.4x, the pass without the low words' adds 0.7x, a pass with no
// doc in range 0.13 ms), not by the 3.35 TB/s of HBM.  Later
// work: a count channel kept as a 32-bit counter (one atomic less a doc
// and feature where the values are 0/1), 16-byte bin reads shared by
// shuffles.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// scripts/profile_torch_kernels.py times other values of the next three
constexpr int kMaxThreads = 1024;         // threads a block, and docs its list holds
constexpr int kMaxWaves = 8;              // waves of resident blocks a launch, at most
constexpr int kMinThreads = 32;
constexpr int kMaxChannels = 8;
constexpr int kDocsInFlight = 4;          // docs a warp reads bins of at a time
constexpr int kDocsPerThread = 4;         // docs a thread scans a round
constexpr int kSmemMax = 232448;          // one block's dynamic maximum
constexpr int kSmemPerSm = 233472;        // shared memory of one SM

__device__ inline int channel_shift(unsigned int maxbits, int64_t n) {
  const float m = __uint_as_float(maxbits);
  if (!(m > 0.f) || maxbits >= 0x7f800000u) return 0;  // all zero, or non-finite
  int e;
  frexpf(m, &e);                                      // m < 2^e
  const int nb = 64 - __clzll(static_cast<unsigned long long>(n));  // n < 2^nb
  return 62 - e - nb;
}

// cell += v (mod 2^64) for each of one doc's C channels, in shared memory
// with 32-bit atomics: a 64-bit shared atomicAdd compiles to a
// compare-and-swap loop on sm_90, the 32-bit one to a native add.  The low
// word's add returns the old word, so the thread whose add wraps it knows,
// and carries one into the high word; the two words then hold the exact
// 64-bit sum.  The low adds of all channels are started before the high
// ones, so their round trips overlap.
template <int C>
__device__ __forceinline__ void add_doc(unsigned int* lo_cells, unsigned int* hi_cells,
                                        const unsigned long long* q, int q_stride) {
  unsigned int high[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned long long v = q[c * q_stride];
    const unsigned int lo = static_cast<unsigned int>(v);
    high[c] = static_cast<unsigned int>(v >> 32);
    if (lo != 0u) {
      const unsigned int old = atomicAdd(lo_cells + c, lo);
      high[c] += (old + lo < lo) ? 1u : 0u;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (high[c] != 0u) atomicAdd(hi_cells + c, high[c]);
}

// The dense list: docs of the block's node, with their values in fixed
// point, channel-major so neighbouring ranks write neighbouring words.
struct DocList {
  unsigned int* doc;        // [cap] doc index
  unsigned long long* q;    // [C][cap]
  int cap;
};

// The add step: the first `count` docs of the list into the block's cells.
// Lane -> (feature fl of the block, doc dl of the warp's turn); kInFlight docs
// a lane and turn, their bin reads started together before the first atomic.
template <typename BinT, int C, int kInFlight>
__device__ __forceinline__ void add_list(const DocList& list, int count,
                                         const BinT* __restrict__ binned, int64_t width,
                                         int column, bool has_feature, int num_bins,
                                         unsigned int* my_lo, unsigned int* my_hi,
                                         int warp, int nwarps, int dl, int docs_per_warp) {
  const int turn = docs_per_warp * kInFlight;
  for (int e0 = warp * turn + dl; e0 < count; e0 += nwarps * turn) {
    int64_t b[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * docs_per_warp;
      b[u] = -1;
      if (e < count && has_feature) {
        const int64_t d = list.doc[e];
        b[u] = static_cast<int64_t>(binned[d * width + column]);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (b[u] < 0 || b[u] >= num_bins) continue;
      const int cell = static_cast<int>(b[u]) * C;
      add_doc<C>(my_lo + cell, my_hi + cell, list.q + e0 + u * docs_per_warp, list.cap);
    }
  }
}

template <typename BinT, int C>
__global__ void __launch_bounds__(kMaxThreads)
histogram_kernel(const BinT* __restrict__ binned, int64_t n, int64_t width,
                 int features, int log2_fpb, int cell_stride,
                 const float* __restrict__ values, int64_t stride_c, int64_t stride_n,
                 const int32_t* __restrict__ pos, int n0, int k, int num_bins,
                 const unsigned int* __restrict__ maxbits, int64_t n_scale,
                 unsigned long long* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int fpb = 1 << log2_fpb;           // features a block
  const int cap = blockDim.x;              // docs the list holds
  const int ncells = fpb * cell_stride;    // 32-bit words of either half
  DocList list;
  list.cap = cap;
  list.q = reinterpret_cast<unsigned long long*>(smem);
  double* s_scale = reinterpret_cast<double*>(list.q + C * cap);
  unsigned int* s_lo = reinterpret_cast<unsigned int*>(s_scale + kMaxChannels);
  unsigned int* s_hi = s_lo + ncells;
  list.doc = s_hi + ncells;
  int* s_wcount = reinterpret_cast<int*>(list.doc + cap);  // [2][32] docs a warp adds

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int f0 = blockIdx.x << log2_fpb;
  const int node = blockIdx.y;
  for (int i = tid; i < 2 * ncells; i += blockDim.x) s_lo[i] = 0u;
  if (tid < C) s_scale[tid] = ldexp(1.0, channel_shift(maxbits[tid], n_scale));
  __syncthreads();
  double scale[C];
#pragma unroll
  for (int c = 0; c < C; ++c) scale[c] = s_scale[c];

  // the add step's mapping: lane -> (feature of the block, doc of the warp)
  const int fl = lane & (fpb - 1);
  const int dl = lane >> log2_fpb;
  const int docs_per_warp = 32 >> log2_fpb;
  const bool has_feature = f0 + fl < features;
  unsigned int* my_lo = s_lo + fl * cell_stride;
  unsigned int* my_hi = s_hi + fl * cell_stride;

  // Rounds of kDocsPerThread * blockDim docs, dealt to the blocks of a
  // (feature group, node) in turn so that any order of the docs spreads
  // evenly.  A thread reads the node ids of the next round's docs while it
  // works on this round's.
  const int64_t round_docs = static_cast<int64_t>(cap) * kDocsPerThread;
  const int64_t rounds = (n + round_docs - 1) / round_docs;
  // with a warp a doc, four docs' bin reads in flight hide their latency;
  // with several docs a warp (few features a block) a turn is wide already
  auto add = [&](int count) {
    if (log2_fpb == 5)
      add_list<BinT, C, kDocsInFlight>(list, count, binned, width, f0 + fl, has_feature,
                                       num_bins, my_lo, my_hi, warp, nwarps, dl,
                                       docs_per_warp);
    else
      add_list<BinT, C, 1>(list, count, binned, width, f0 + fl, has_feature, num_bins,
                           my_lo, my_hi, warp, nwarps, dl, docs_per_warp);
  };
  auto in_node = [&](int64_t d) {
    return d < n && (pos == nullptr || pos[d] - n0 == node);
  };
  bool in_next[kDocsPerThread];
#pragma unroll
  for (int r = 0; r < kDocsPerThread; ++r)
    in_next[r] = in_node(blockIdx.z * round_docs + r * cap + tid);
  int total = 0;   // docs in the list
  int parity = 0;
  for (int64_t round = blockIdx.z; round < rounds; round += gridDim.z) {
    const int64_t base = round * round_docs;
    bool in[kDocsPerThread];
    float v[kDocsPerThread][C];
#pragma unroll
    for (int r = 0; r < kDocsPerThread; ++r) {
      in[r] = in_next[r];
      const int64_t d = base + r * cap + tid;
#pragma unroll
      for (int c = 0; c < C; ++c) v[r][c] = in[r] ? values[c * stride_c + d * stride_n] : 0.f;
    }
    const int64_t next = (round + gridDim.z) * round_docs;
#pragma unroll
    for (int r = 0; r < kDocsPerThread; ++r) in_next[r] = in_node(next + r * cap + tid);

#pragma unroll
    for (int r = 0; r < kDocsPerThread; ++r) {
      // -- compact: this thread's doc joins the list unless it is of
      // another node or all its values round to 0
      unsigned long long q[C];
      bool any = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        q[c] = static_cast<unsigned long long>(
            __double2ll_rn(static_cast<double>(v[r][c]) * scale[c]));
        any |= q[c] != 0ull;
      }
      const bool joins = in[r] && any;
      const unsigned int ballot = __ballot_sync(0xffffffffu, joins);
      if (lane == 0) s_wcount[parity * 32 + warp] = __popc(ballot);
      const int count = __syncthreads_count(joins);
      if (total + count > cap) {  // no room: add what the list holds first
        add(total);
        __syncthreads();
        total = 0;
      }
      // ranks: the docs of the warps before this one, then of the lanes
      int before = (lane < warp) ? s_wcount[parity * 32 + lane] : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(0xffffffffu, before, off);
      const int slot = total + before + __popc(ballot & ((1u << lane) - 1u));
      if (joins) {
        list.doc[slot] = static_cast<unsigned int>(base + r * cap + tid);
#pragma unroll
        for (int c = 0; c < C; ++c) list.q[c * cap + slot] = q[c];
      }
      total += count;
      parity ^= 1;
    }
  }
  __syncthreads();
  add(total);
  __syncthreads();

  // this block's cells into the accumulator [features, num_bins, k, C]
  const int per_feature = num_bins * C;
  const int fb = min(fpb, features - f0);
  for (int i = tid; i < fb * per_feature; i += blockDim.x) {
    const int f = i / per_feature;
    const int j = i - f * per_feature;
    const unsigned long long v =
        (static_cast<unsigned long long>(s_hi[f * cell_stride + j]) << 32) |
        s_lo[f * cell_stride + j];
    if (v != 0ull) {
      const int b = j / C;
      const int c = j - b * C;
      atomicAdd(acc + ((static_cast<int64_t>(f0 + f) * num_bins + b) * k + node) * C + c, v);
    }
  }
}

__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                int64_t ncells, int channels, int64_t n,
                                const unsigned int* __restrict__ maxbits,
                                float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= ncells) return;
  const int c = static_cast<int>(i % channels);
  const unsigned int bits = maxbits[c];
  if (bits >= 0x7f800000u) {
    out[i] = __int_as_float(0x7fc00000);
    return;
  }
  const double sum = static_cast<double>(static_cast<long long>(acc[i]));
  out[i] = static_cast<float>(ldexp(sum, -channel_shift(bits, n)));
}

// 32-bit words a feature's cells take in either half: num_bins * channels,
// rounded up to 1 mod 32
inline int cell_stride_of(int num_bins, int channels) {
  return (num_bins * channels + 30) / 32 * 32 + 1;
}

// shared memory of a block of `threads` threads that holds 2^log2_fpb
// features: the doc list, the scales, both halves of the cells, the warps'
// counts
inline size_t smem_bytes(int threads, int log2_fpb, int num_bins, int channels) {
  return static_cast<size_t>(threads) * (8 * channels + 4) + 8 * kMaxChannels +
         (static_cast<size_t>(8) << log2_fpb) * cell_stride_of(num_bins, channels) + 256;
}

// n_scale: the doc count of the fixed-point scale; acc is left unconverted
template <typename BinT, int C>
cudaError_t launch(const BinT* binned, int64_t n, int64_t width, int features,
                   const float* values, int64_t stride_c, int64_t stride_n,
                   const int32_t* pos, int n0, int k, int num_bins,
                   const unsigned int* maxbits, int64_t n_scale,
                   unsigned long long* acc, cudaStream_t stream) {
  if (n > 0xffffffffll) return cudaErrorInvalidValue;  // the list's doc indices
  // features a block: the most, up to a warp's 32, whose cells fit beside
  // the doc list of at least 256 threads
  int log2_fpb = 5;
  while (log2_fpb > 0 && (1 << (log2_fpb - 1)) >= features) --log2_fpb;
  int threads = kMaxThreads;
  while (smem_bytes(threads, log2_fpb, num_bins, C) > kSmemMax) {
    if (threads > 256) threads /= 2;
    else if (log2_fpb > 0) --log2_fpb, threads = kMaxThreads;
    else if (threads > kMinThreads) threads /= 2;
    else return cudaErrorInvalidValue;
  }
  // several blocks an SM where they fit: 512 threads each
  if (smem_bytes(512, log2_fpb, num_bins, C) + 1024 <= kSmemPerSm / 2) threads = 512;
  const size_t smem = smem_bytes(threads, log2_fpb, num_bins, C);

  cudaError_t err = cudaSuccess;  // the caller has cleared acc
  if (n > 0) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;

    auto kernel = histogram_kernel<BinT, C>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // blocks a (feature group, node): the count, of one to kMaxWaves waves
    // of resident blocks, that leaves the fewest SMs idle in its last
    // wave; with several node slots the blocks' work differs with the
    // nodes' sizes, and the most waves even it out best
    const int64_t resident = static_cast<int64_t>(sms) * std::max<int64_t>(
        1, std::min<int64_t>(2048 / threads, kSmemPerSm / (smem + 1024)));
    const int64_t items = static_cast<int64_t>((features + (1 << log2_fpb) - 1) >> log2_fpb) * k;
    const int64_t round_docs = static_cast<int64_t>(threads) * kDocsPerThread;
    const int64_t rounds = (n + round_docs - 1) / round_docs;
    int64_t splits = 1;
    double best = 0.0;
    for (int waves = k > 1 ? kMaxWaves : 1; waves <= kMaxWaves; ++waves) {
      const int64_t s = std::max<int64_t>(
          1, std::min<int64_t>(rounds, waves * resident / items));
      const int64_t blocks = items * s;
      const double use = static_cast<double>(blocks) /
                         (static_cast<double>((blocks + resident - 1) / resident) * resident);
      if (use > best + 0.02) best = use, splits = s;
    }
    splits = std::min<int64_t>(splits, 65535);
    const dim3 grid(static_cast<unsigned int>(items / k), static_cast<unsigned int>(k),
                    static_cast<unsigned int>(splits));
    kernel<<<grid, threads, smem, stream>>>(
        binned, n, width, features, log2_fpb, cell_stride_of(num_bins, C), values, stride_c,
        stride_n, pos, n0, k, num_bins, maxbits, n_scale, acc);
    err = cudaGetLastError();
  }
  return err;
}

// the kernel is compiled for each channel count, so a doc's values stay in
// registers
template <typename BinT>
cudaError_t launch_channels(int channels, const BinT* binned, int64_t n, int64_t width,
                            int features, const float* values, int64_t stride_c,
                            int64_t stride_n, const int32_t* pos, int n0, int k,
                            int num_bins, const unsigned int* maxbits, int64_t n_scale,
                            unsigned long long* acc, cudaStream_t stream) {
#define QR_CASE(C)                                                                       \
  case C:                                                                                \
    return launch<BinT, C>(binned, n, width, features, values, stride_c, stride_n, pos,  \
                           n0, k, num_bins, maxbits, n_scale, acc, stream)
  switch (channels) {
    QR_CASE(1);
    QR_CASE(2);
    QR_CASE(3);
    QR_CASE(4);
    QR_CASE(5);
    QR_CASE(6);
    QR_CASE(7);
    QR_CASE(8);
    default:
      return cudaErrorInvalidValue;
  }
#undef QR_CASE
}

bool bad_shape(int channels, int k, int num_bins, int features, int64_t width) {
  return channels < 1 || channels > kMaxChannels || k < 1 || num_bins < 1 ||
         features < 1 || features > width;
}

}  // namespace

// acc[f, b, i*C + c] = the fixed-point sum over docs d with pos[d] == n0 + i
// (every doc, i = 0, when pos is null) of values[c * stride_c + d * stride_n]
// where binned[d * width + f] == b, for f < features, b < num_bins, i < k,
// each value scaled by its channel's power of two from maxbits[c] (the
// largest |value| bits of channel c) and n_scale (the doc count of the
// scale).  binned holds bin_bytes-wide ids (1: uint8, 4: int32).  acc is
// int64 [features * num_bins * k * C], cleared first; histogram_to_float
// converts it.  Launches on `stream`; returns the first CUDA error.
extern "C" int histogram_launch(const void* binned, int bin_bytes, int64_t n,
                                int64_t width, int features, const float* values,
                                int channels, int64_t stride_c, int64_t stride_n,
                                const int32_t* pos, int n0, int k, int num_bins,
                                const unsigned int* maxbits, int64_t n_scale,
                                unsigned long long* acc, void* stream) {
  if (bad_shape(channels, k, num_bins, features, width) || n_scale < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ncells = static_cast<int64_t>(features) * num_bins * k * channels;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * ncells, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bin_bytes == 1)
    err = launch_channels(channels, static_cast<const uint8_t*>(binned), n, width, features,
                          values, stride_c, stride_n, pos, n0, k, num_bins, maxbits,
                          n_scale, acc, s);
  else if (bin_bytes == 4)
    err = launch_channels(channels, static_cast<const int32_t*>(binned), n, width, features,
                          values, stride_c, stride_n, pos, n0, k, num_bins, maxbits,
                          n_scale, acc, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// out[i] = float(double(acc[i]) / scale of channel i % channels), the scale
// from maxbits and n_scale as histogram_launch took it; NaN where the
// channel's max bits are non-finite.
extern "C" int histogram_to_float(const unsigned long long* acc, int64_t ncells,
                                  int channels, const unsigned int* maxbits,
                                  int64_t n_scale, float* out, void* stream) {
  if (channels < 1 || channels > kMaxChannels || ncells < 0 || n_scale < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncells == 0) return 0;
  to_float_kernel<<<static_cast<unsigned int>((ncells + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(acc, ncells, channels, n_scale,
                                                         maxbits, out);
  return static_cast<int>(cudaGetLastError());
}
