// The wide-bin path of K4 and K5 (histogram.cu): histograms whose bin axes
// are too long for the block path, for sm_90a.
//
// It computes what histogram.cu's kernel computes, with the same fixed-point
// arithmetic (channel_shift, one __double2ll_rn rounding a value, integer
// sums, histogram_to_float), so its int64 sums are the same bits, and
// ops/kernel_histogram.py::node_histogram_fixed_int is their plain version.
//
// Why a path of its own.  The block path holds whole bin axes of up to 32
// features in one block's shared memory, and a warp's lanes add one doc's
// bins of 32 features.  Past about 9,600 bins at C = 3 a block cannot hold
// one feature, and histogram_launch takes this path.  The tiled pass it
// replaced (a block of 256 threads a tile of one
// feature's bins, the block path's compaction into a doc list, one doc in
// flight a lane) took 42.1 ms for K4's root pass at 16,384 bins on 2.56M
// docs x 160 columns, 2.2x one index_add_, on an H100: every block waited on
// the latency of its bin reads between barriers, one block an SM.
//
// Layout.  A CTA of 1,024 threads holds the cells of one feature's bins
// [j * tile_bins, (j + 1) * tile_bins) for one node slot, two 32-bit words
// a cell and channel (tile j of the fewest even tiles whose cells fit 227
// KB: 9,682 bins at C = 3, so 16,384 bins take 2 tiles), and a share of
// the docs (grid z).  Each thread takes its own docs, kBatch at a time: the
// node ids two batches ahead, the values and the bin id one batch ahead,
// loaded into registers (values and id only for docs of the node) while
// this batch's are added, so the loop has no barrier and its loads are
// always in flight.  A doc of the node whose id falls in the tile adds its C
// values straight into the tile's cells: the low word's 32-bit atomic add
// returns the old word, the thread whose add wraps it carries one into the
// high word (add_doc in histogram.cu).  No doc list, no ballot: a CTA adds
// at most one id a doc.  At the end the CTA adds its non-zero cells into
// the int64 accumulator with global atomics.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W beside the tiled pass, the
// block path and index_add_ (scripts/profile_torch_wide_bins.py; PERF.md
// has the numbers).  Where both paths fit (up to ~9,600 bins at C = 3) the
// block path stays: at 4,096 bins this path's root pass is faster, but a
// node of a sixteenth of the docs, as best-first growth asks for, is
// slower, since every CTA still reads every doc's node id.  Two other
// designs gave the same bits and lost at 16,384 bins: thread-block clusters
// (8 CTAs holding 4 features' whole bin axes, the CTAs splitting the docs
// and adding into the owning CTA's cells through distributed shared
// memory), whose remote shared-memory atomics ran at about the rate of L2
// atomics, and 64-bit atomics straight into the accumulator in L2.
//
// What bounds it on an H100: each doc's row sector (32 bytes, for a 2-byte
// id), node id and values are read once a tile and node slot: 39 GB from L2
// for K4's root pass at 16,384 bins, so L2 bandwidth, not the 0.25 ms of
// reading the u16 ids once from HBM.  Every further tile reads every doc
// again, so the time grows with the tiles (7 at 65,536 bins and C = 3).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "histogram.cuh"

namespace {

constexpr int kThreads = 1024;   // threads a CTA
constexpr int kBatch = 2;        // docs a thread adds a batch
constexpr int kMaxWaves = 8;     // waves of resident CTAs a launch, at most
constexpr int kMaxChannels = qr::kHistMaxChannels;

template <typename BinT, int C>
__global__ void __launch_bounds__(kThreads, 1)
histogram_wide_kernel(const BinT* __restrict__ binned, int64_t n, int64_t width, int tiles,
                      int tile_bins, const float* __restrict__ values,
                      int64_t stride_c, int64_t stride_n, const int32_t* __restrict__ pos,
                      int n0, int k, int num_bins, const unsigned int* __restrict__ maxbits,
                      int64_t n_scale, unsigned long long* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_scale = reinterpret_cast<double*>(smem);
  unsigned int* s_lo = reinterpret_cast<unsigned int*>(s_scale + kMaxChannels);
  const int words = tile_bins * C;  // 32-bit words of either half of the cells
  unsigned int* s_hi = s_lo + words;
  const int tid = threadIdx.x;
  const int f = static_cast<int>(blockIdx.x) / tiles;
  const int bin0 = (static_cast<int>(blockIdx.x) % tiles) * tile_bins;
  const int nbins = min(tile_bins, num_bins - bin0);
  const int node = blockIdx.y;
  for (int i = tid; i < 2 * words; i += kThreads) s_lo[i] = 0u;
  if (tid < C) s_scale[tid] = ldexp(1.0, qr::channel_shift(maxbits[tid], n_scale));
  __syncthreads();
  double scale[C];
#pragma unroll
  for (int c = 0; c < C; ++c) scale[c] = s_scale[c];

  const BinT* column = binned + f;
  const int kc = k * C;
  unsigned long long* out = acc + (static_cast<int64_t>(f) * num_bins * k + node) * C;
  const int mine = n0 + node;  // the node id of the slot (never -1)
  const int64_t step = static_cast<int64_t>(gridDim.z) * kThreads;  // a thread's next doc
  const int64_t batch = kBatch * step;
  auto node_of = [&](int64_t d) { return d >= n ? -1 : (pos == nullptr ? mine : pos[d]); };
  // a doc of the node: its values and its bin id; else zeros and id -1
  auto load = [&](int64_t d, int p, float (&vv)[C], int& bb) {
    const bool in = p == mine;
#pragma unroll
    for (int c = 0; c < C; ++c) vv[c] = in ? values[c * stride_c + d * stride_n] : 0.f;
    bb = in ? static_cast<int>(column[d * width]) : -1;
  };
  int p1[kBatch], p2[kBatch];  // node ids of the next two batches
  float v[kBatch][C], v1[kBatch][C];
  int b[kBatch], b1[kBatch];
  const int64_t first = static_cast<int64_t>(blockIdx.z) * kThreads + tid;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    p1[u] = node_of(first + batch + u * step);
    p2[u] = node_of(first + 2 * batch + u * step);
    load(first + u * step, node_of(first + u * step), v[u], b[u]);
  }
  for (int64_t d0 = first; d0 < n; d0 += batch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      load(d0 + batch + u * step, p1[u], v1[u], b1[u]);
      p1[u] = p2[u];
      p2[u] = node_of(d0 + 3 * batch + u * step);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t bin = static_cast<int64_t>(b[u]) - bin0;
      if (bin < 0 || bin >= nbins) continue;  // another node's doc (id -1), or not this tile's
      const int cell = static_cast<int>(bin) * C;
      unsigned int high[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const unsigned long long q = static_cast<unsigned long long>(
            __double2ll_rn(static_cast<double>(v[u][c]) * scale[c]));
        const unsigned int low = static_cast<unsigned int>(q);
        high[c] = static_cast<unsigned int>(q >> 32);
        if (low != 0u) {
          const unsigned int old = atomicAdd(s_lo + cell + c, low);
          high[c] += (old + low < low) ? 1u : 0u;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (high[c] != 0u) atomicAdd(s_hi + cell + c, high[c]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      b[u] = b1[u];
#pragma unroll
      for (int c = 0; c < C; ++c) v[u][c] = v1[u][c];
    }
  }
  __syncthreads();
  // the tile's cells into the accumulator [features, num_bins, k, C]
  for (int i = tid; i < nbins * C; i += kThreads) {
    const unsigned long long cell = (static_cast<unsigned long long>(s_hi[i]) << 32) | s_lo[i];
    if (cell != 0ull) {
      const int bin = i / C;
      const int c = i - bin * C;
      atomicAdd(out + static_cast<int64_t>(bin0 + bin) * kc + c, cell);
    }
  }
}

template <typename BinT, int C>
cudaError_t launch(const qr::WidePlan& plan, const BinT* binned, int64_t n, int64_t width,
                   int features, const float* values, int64_t stride_c, int64_t stride_n,
                   const int32_t* pos, int n0, int k, int num_bins,
                   const unsigned int* maxbits, int64_t n_scale, unsigned long long* acc,
                   cudaStream_t stream) {
  auto kernel = histogram_wide_kernel<BinT, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;  // one CTA an SM: 1,024 threads of up to 64 registers
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // CTAs a (feature, tile, node): the count, of one to kMaxWaves waves of
  // resident CTAs, that leaves the fewest SMs idle in its last wave; with
  // several node slots the CTAs' work differs with the nodes' sizes, and the
  // most waves even it out best
  const int64_t items = static_cast<int64_t>(features) * plan.tiles * k;
  const int64_t most = std::max<int64_t>(1, n / (static_cast<int64_t>(kThreads) * kBatch));
  int64_t splits = 1;
  double best = 0.0;
  for (int waves = k > 1 ? kMaxWaves : 1; waves <= kMaxWaves; ++waves) {
    const int64_t s = std::max<int64_t>(1, std::min<int64_t>(most, waves * sms / items));
    const int64_t blocks = items * s;
    const double use = static_cast<double>(blocks) /
                       (static_cast<double>((blocks + sms - 1) / sms) * sms);
    if (use > best + 0.02) best = use, splits = s;
  }
  splits = std::min<int64_t>(splits, 65535);
  const dim3 grid(static_cast<unsigned int>(features * plan.tiles), static_cast<unsigned int>(k),
                  static_cast<unsigned int>(splits));
  kernel<<<grid, kThreads, plan.smem, stream>>>(binned, n, width, plan.tiles, plan.tile_bins,
                                                values, stride_c, stride_n, pos, n0, k,
                                                num_bins, maxbits, n_scale, acc);
  return cudaGetLastError();
}

// the kernel is compiled for each channel count, so a doc's values stay in
// registers
template <typename BinT>
cudaError_t launch_channels(const qr::WidePlan& plan, int channels, const BinT* binned,
                            int64_t n, int64_t width, int features, const float* values,
                            int64_t stride_c, int64_t stride_n, const int32_t* pos, int n0,
                            int k, int num_bins, const unsigned int* maxbits, int64_t n_scale,
                            unsigned long long* acc, cudaStream_t stream) {
#define QR_CASE(C)                                                                       \
  case C:                                                                                \
    return launch<BinT, C>(plan, binned, n, width, features, values, stride_c, stride_n, \
                           pos, n0, k, num_bins, maxbits, n_scale, acc, stream)
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

}  // namespace

namespace qr {

WidePlan wide_plan(int channels, int num_bins) {
  WidePlan p;
  const int most = (kHistSmemMax - 8 * kMaxChannels) / (8 * channels);  // bins a tile
  p.tiles = (num_bins + most - 1) / most;
  p.tile_bins = (num_bins + p.tiles - 1) / p.tiles;
  p.smem = 8 * kMaxChannels + 8 * p.tile_bins * channels;
  return p;
}

cudaError_t histogram_wide_launch(const void* binned, int bin_bytes, int64_t n,
                                  int64_t width, int features, const float* values,
                                  int channels, int64_t stride_c, int64_t stride_n,
                                  const int32_t* pos, int n0, int k, int num_bins,
                                  const unsigned int* maxbits, int64_t n_scale,
                                  unsigned long long* acc, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (k > 65535) return cudaErrorInvalidValue;  // node slots: grid y
  const WidePlan plan = wide_plan(channels, num_bins);
  if (bin_bytes == 1)
    return launch_channels(plan, channels, static_cast<const uint8_t*>(binned), n, width,
                         features, values, stride_c, stride_n, pos, n0, k, num_bins, maxbits,
                         n_scale, acc, stream);
  if (bin_bytes == 2)
    return launch_channels(plan, channels, static_cast<const uint16_t*>(binned), n, width,
                         features, values, stride_c, stride_n, pos, n0, k, num_bins, maxbits,
                         n_scale, acc, stream);
  if (bin_bytes == 4)
    return launch_channels(plan, channels, static_cast<const int32_t*>(binned), n, width,
                         features, values, stride_c, stride_n, pos, n0, k, num_bins, maxbits,
                         n_scale, acc, stream);
  return cudaErrorInvalidValue;
}

}  // namespace qr
