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
// Layout of the work: block (g, s) holds the histograms of feature group g
// ([features_per_block, B, k*C] int64 in shared memory, sized from
// k*C*B*8 bytes a feature, about 110 KB so two blocks share an SM) and
// walks doc range s, one doc per thread: a doc outside [n0, n0 + k), or
// whose values all round to 0, is skipped before its bins are read; a bin
// id >= num_bins is dropped per element.  Shared-memory 64-bit sums
// accumulate through 32-bit atomics with a carry (add_u64), then each block
// adds its non-zero cells into a global int64 accumulator with global
// atomics, and a last pass converts to float32.
//
// What bounds it on an H100: per pass it reads the u8 bins of the docs in
// range (N x W bytes, 410 MB at 2.56M docs x 160 columns, when all are in
// range) and does one or two shared-memory atomics per (doc, feature,
// channel): 1.2e9 adds at 2.56M docs x 160 x 3.  The atomics, not the
// 3.35 TB/s of HBM, set the time; later work: warp-aggregate equal bins.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChannels = 8;
constexpr int kSmemTarget = 110 * 1024;   // two blocks per SM
constexpr int kSmemMax = 232448;          // one block's dynamic maximum

__device__ inline int channel_shift(unsigned int maxbits, int64_t n) {
  const float m = __uint_as_float(maxbits);
  if (!(m > 0.f) || maxbits >= 0x7f800000u) return 0;  // all zero, or non-finite
  int e;
  frexpf(m, &e);                                      // m < 2^e
  const int nb = 64 - __clzll(static_cast<unsigned long long>(n));  // n < 2^nb
  return 62 - e - nb;
}

// cell += v (mod 2^64) in shared memory with 32-bit atomics: a 64-bit
// shared atomicAdd compiles to a compare-and-swap loop on sm_90, the 32-bit
// one to a native add.  The low word's add returns the old word, so the
// thread whose add wraps it knows, and carries one into the high word; the
// two words then hold the exact 64-bit sum (little-endian: low word first).
__device__ inline void add_u64(unsigned long long* cell, unsigned long long v) {
  unsigned int* w = reinterpret_cast<unsigned int*>(cell);
  const unsigned int lo = static_cast<unsigned int>(v);
  unsigned int hi = static_cast<unsigned int>(v >> 32);
  if (lo != 0u) {
    const unsigned int old = atomicAdd(w, lo);
    hi += (old + lo < lo) ? 1u : 0u;
  }
  if (hi != 0u) atomicAdd(w + 1, hi);
}

// max |v| per channel, as IEEE bits (they order like the values for
// non-negative floats; NaN sorts above inf).  Max is order-free.
__global__ void absmax_kernel(const float* __restrict__ values, int64_t n,
                              int channels, int64_t stride_c, int64_t stride_n,
                              unsigned int* __restrict__ maxbits) {
  unsigned int local[kMaxChannels] = {0u};
  for (int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       d < n; d += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    for (int c = 0; c < channels; ++c) {
      const unsigned int b = __float_as_uint(fabsf(values[c * stride_c + d * stride_n]));
      local[c] = max(local[c], b);
    }
  }
  for (int c = 0; c < channels; ++c) {
    unsigned int v = local[c];
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0 && v) atomicMax(maxbits + c, v);
  }
}

template <typename BinT>
__global__ void histogram_kernel(const BinT* __restrict__ binned, int64_t n,
                                 int64_t width, int features,
                                 int features_per_block,
                                 const float* __restrict__ values, int channels,
                                 int64_t stride_c, int64_t stride_n,
                                 const int32_t* __restrict__ pos, int n0, int k,
                                 int num_bins, int64_t docs_per_block,
                                 const unsigned int* __restrict__ maxbits,
                                 unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long cells[];
  const int f0 = blockIdx.x * features_per_block;
  const int fb = min(features_per_block, features - f0);
  const int kc = k * channels;
  const int per_feature = num_bins * kc;
  const int ncells = fb * per_feature;
  for (int i = threadIdx.x; i < ncells; i += blockDim.x) cells[i] = 0ull;
  double scale[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    scale[c] = c < channels ? ldexp(1.0, channel_shift(maxbits[c], n)) : 0.0;
  __syncthreads();

  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * docs_per_block;
  const int64_t d1 = min(n, d0 + docs_per_block);
  for (int64_t d = d0 + threadIdx.x; d < d1; d += blockDim.x) {
    int node = 0;
    if (pos != nullptr) {
      node = pos[d] - n0;
      if (node < 0 || node >= k) continue;
    }
    unsigned long long q[kMaxChannels];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      q[c] = 0ull;
      if (c < channels) {
        const double v = static_cast<double>(values[c * stride_c + d * stride_n]);
        q[c] = static_cast<unsigned long long>(__double2ll_rn(v * scale[c]));
        any |= q[c] != 0ull;
      }
    }
    if (!any) continue;
    const BinT* row = binned + d * width + f0;
    for (int f = 0; f < fb; ++f) {
      const int64_t b = static_cast<int64_t>(row[f]);
      if (b < 0 || b >= num_bins) continue;
      unsigned long long* cell =
          cells + (static_cast<int64_t>(f) * num_bins + b) * kc + node * channels;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < channels && q[c] != 0ull) add_u64(cell + c, q[c]);
    }
  }
  __syncthreads();
  unsigned long long* out = acc + static_cast<int64_t>(f0) * per_feature;
  for (int i = threadIdx.x; i < ncells; i += blockDim.x) {
    const unsigned long long v = cells[i];
    if (v != 0ull) atomicAdd(out + i, v);
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

template <typename BinT>
cudaError_t launch(const BinT* binned, int64_t n, int64_t width, int features,
                   const float* values, int channels, int64_t stride_c,
                   int64_t stride_n, const int32_t* pos, int n0, int k,
                   int num_bins, unsigned int* maxbits,
                   unsigned long long* acc, float* out, cudaStream_t stream) {
  const int64_t per_feature_bytes =
      static_cast<int64_t>(num_bins) * k * channels * 8;
  if (per_feature_bytes > kSmemMax) return cudaErrorInvalidValue;
  const int fpb = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(features, kSmemTarget / per_feature_bytes)));
  const int smem = static_cast<int>(fpb * per_feature_bytes);
  const int64_t ncells = static_cast<int64_t>(features) * num_bins * k * channels;

  cudaError_t err = cudaMemsetAsync(maxbits, 0, sizeof(unsigned int) * channels, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * ncells, stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int64_t max_blocks = (n + kThreads - 1) / kThreads;
    absmax_kernel<<<static_cast<unsigned int>(std::min<int64_t>(max_blocks, 4 * sms)),
                    kThreads, 0, stream>>>(values, n, channels, stride_c,
                                           stride_n, maxbits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    err = cudaFuncSetAttribute(histogram_kernel<BinT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int groups = (features + fpb - 1) / fpb;
    // about four blocks per SM over the whole grid
    const int64_t splits = std::max<int64_t>(
        1, std::min<int64_t>(max_blocks, (4 * sms + groups - 1) / groups));
    const int64_t docs_per_block = (n + splits - 1) / splits;
    const dim3 grid(groups, static_cast<unsigned int>((n + docs_per_block - 1) / docs_per_block));
    histogram_kernel<BinT><<<grid, kThreads, smem, stream>>>(
        binned, n, width, features, fpb, values, channels, stride_c, stride_n,
        pos, n0, k, num_bins, docs_per_block, maxbits, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (ncells > 0) {
    to_float_kernel<<<static_cast<unsigned int>((ncells + 255) / 256), 256, 0,
                      stream>>>(acc, ncells, channels, n, maxbits, out);
  }
  return cudaGetLastError();
}

}  // namespace

// hist[f, b, i*C + c] = sum over docs d with pos[d] == n0 + i (every doc,
// i = 0, when pos is null) of values[c * stride_c + d * stride_n] where
// binned[d * width + f] == b, for f < features, b < num_bins, i < k.
// binned holds bin_bytes-wide ids (1: uint8, 4: int32).  maxbits [C] and
// acc [features * num_bins * k * C] are scratch; out is float32 of acc's
// size.  Launches on `stream`; returns the first CUDA error.
extern "C" int histogram_launch(const void* binned, int bin_bytes, int64_t n,
                                int64_t width, int features,
                                const float* values, int channels,
                                int64_t stride_c, int64_t stride_n,
                                const int32_t* pos, int n0, int k, int num_bins,
                                unsigned int* maxbits, unsigned long long* acc,
                                float* out, void* stream) {
  if (channels < 1 || channels > kMaxChannels || k < 1 || num_bins < 1 ||
      features < 1 || features > width)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bin_bytes == 1)
    err = launch(static_cast<const uint8_t*>(binned), n, width, features, values,
                 channels, stride_c, stride_n, pos, n0, k, num_bins, maxbits, acc,
                 out, s);
  else if (bin_bytes == 4)
    err = launch(static_cast<const int32_t*>(binned), n, width, features, values,
                 channels, stride_c, stride_n, pos, n0, k, num_bins, maxbits, acc,
                 out, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
