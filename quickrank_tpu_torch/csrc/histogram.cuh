// What histogram.cu (the block path of K4 and K5) and histogram_wide.cu
// (their wide-bin path) share: the fixed-point scale, and the wide-bin
// path's plan and launch, which histogram.cu's entry points call.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qr {

constexpr int kHistMaxChannels = 8;
constexpr int kHistSmemMax = 232448;   // one block's dynamic maximum

// the fixed-point exponent of a channel: 62 - e - nb, where max |v| < 2^e
// (the float of maxbits) and the doc count n < 2^nb; 0 for a channel that
// is all zero or holds a non-finite value
__device__ inline int channel_shift(unsigned int maxbits, int64_t n) {
  const float m = __uint_as_float(maxbits);
  if (!(m > 0.f) || maxbits >= 0x7f800000u) return 0;  // all zero, or non-finite
  int e;
  frexpf(m, &e);                                      // m < 2^e
  const int nb = 64 - __clzll(static_cast<unsigned long long>(n));  // n < 2^nb
  return 62 - e - nb;
}

// How the wide-bin path lays out a launch (histogram_wide.cu;
// ops/kernel_histogram.py::wide_plan repeats it): a CTA holds one feature's
// bins [j * tile_bins, (j + 1) * tile_bins), tile j of `tiles`, in `smem`
// bytes of shared memory.
struct WidePlan {
  int tiles;
  int tile_bins;
  int smem;
};

WidePlan wide_plan(int channels, int num_bins);

// The wide-bin path's launch, with histogram_launch's arguments; acc is
// cleared by the caller.
cudaError_t histogram_wide_launch(const void* binned, int bin_bytes, int64_t n, int64_t width,
                                  int features, const float* values, int channels,
                                  int64_t stride_c, int64_t stride_n, const int32_t* pos,
                                  int n0, int k, int num_bins, const unsigned int* maxbits,
                                  int64_t n_scale, unsigned long long* acc,
                                  cudaStream_t stream);

}  // namespace qr
