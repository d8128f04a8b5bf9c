// The training bin matrix written on the card from the float32 rows, for
// sm_90a.
//
// Not a port of a TPU kernel: the JAX package bins on the host with the
// native binner (native/binner.cc::bin_apply), widens the int32 ids to its
// kernels' feature width and casts them to the wire.  learning/mart.py::
// TrainData.build did the same on the card's host, ~2 s for an MSLR-sized
// valid fold in every learn.  Here a launch writes the wire itself from a
// piece of the block's rows, uploaded once as they lie in the dataset
// (ops/binning.py::device_bin_wire; the piece's rows of the wire, the last
// piece's with the block's pad rows):
//
//   out[r, w] = 0                                   col_map[w] < 0 (a pad column)
//             = bin(th[c], x[r, c]), c = col_map[w]  r < n
//             = bin(th[c], 0.0f)                     n <= r < n_loc (a pad row,
//                                                    zero in the host layout)
//
// bin(th, v) is the native binner's: B - 1 for NaN, else std::lower_bound's
// index (the first t with !(th[t] < v)), clamped to B - 1, by the same
// halving steps, so the ids are the host's bit for bit for any table.  The
// wire is u8 up to 256 bins, u16 up to 65,536, int32 beyond (ops/binning.py::
// bin_wire); no int32 intermediate is written.
//
// Bounds: bytes.  An MSLR valid fold reads 0.85M x 136 float32 and writes
// 0.85M x 160 u8: 0.18 ms at 3.35 TB/s; a search is at most 9 compares at 256
// bins.  A thread an output element, consecutive threads on consecutive
// columns of a row, so a warp's reads and writes are contiguous.  Where the
// table fits (136 features x 256 bins: 140 KB), each block holds it in
// shared memory with an odd row stride, so that a warp's first probes, one a
// feature at the same bin, fall in distinct banks; a block walks the rows
// grid-stride, so the table is loaded once a block.  A larger table (16,384
// bins: 8.9 MB) is read from global memory, where it stays in L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
// dynamic shared memory one block may use on an H100
constexpr int64_t kSmemMax = 232448;

__device__ __forceinline__ int bin_of(const float* th, int bins, float v) {
  if (v != v) return bins - 1;
  int first = 0, len = bins;
  while (len > 0) {
    const int half = len >> 1;
    if (th[first + half] < v) {
      first += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return first < bins ? first : bins - 1;
}

template <typename OutT, bool kShared>
__global__ void __launch_bounds__(kThreads)
bin_apply_kernel(const float* __restrict__ x, int64_t n, int64_t f,
                 const float* __restrict__ th, int bins,
                 const int32_t* __restrict__ col_map, int64_t width, int64_t total,
                 OutT* __restrict__ out) {
  extern __shared__ float s_th[];
  const float* table = th;
  int64_t stride = bins;
  if (kShared) {
    stride = bins | 1;
    for (int64_t i = threadIdx.x; i < f * bins; i += blockDim.x) {
      const int64_t row = i / bins;
      s_th[row * stride + (i - row * bins)] = th[i];
    }
    __syncthreads();
    table = s_th;
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t step_r = step / width, step_w = step % width;
  int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t r = e / width, w = e % width;
  for (; e < total; e += step) {
    const int c = __ldg(col_map + w);
    int id = 0;
    if (c >= 0) id = bin_of(table + c * stride, bins, r < n ? __ldg(x + r * f + c) : 0.0f);
    out[e] = static_cast<OutT>(id);
    r += step_r;
    w += step_w;
    if (w >= width) w -= width, ++r;
  }
}

template <typename OutT, bool kShared>
cudaError_t launch(const float* x, int64_t n, int64_t f, const float* th, int bins,
                   const int32_t* col_map, int64_t width, int64_t n_loc, void* out,
                   cudaStream_t stream) {
  const int64_t total = n_loc * width;
  const size_t smem = kShared ? static_cast<size_t>(f) * (bins | 1) * sizeof(float) : 0;
  auto kernel = bin_apply_kernel<OutT, kShared>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one wave of resident blocks, each loading the table once
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > static_cast<int64_t>(sms) * per_sm) blocks = static_cast<int64_t>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, n, f, th, bins, col_map, width, total, static_cast<OutT*>(out));
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_table(const float* x, int64_t n, int64_t f, const float* th, int bins,
                         const int32_t* col_map, int64_t width, int64_t n_loc, void* out,
                         cudaStream_t stream) {
  if (f * static_cast<int64_t>(bins | 1) * static_cast<int64_t>(sizeof(float)) <= kSmemMax)
    return launch<OutT, true>(x, n, f, th, bins, col_map, width, n_loc, out, stream);
  return launch<OutT, false>(x, n, f, th, bins, col_map, width, n_loc, out, stream);
}

}  // namespace

// x: float32 [n, f] contiguous (the block's real rows); th: float32 [f, bins]
// contiguous, each row ascending; col_map: int32 [width], a column of x or -1;
// out: [n_loc, width] of out_bytes a value (1: u8, 2: u16, 4: int32).
extern "C" int bin_apply_wire(const float* x, int64_t n, int64_t f, const float* th,
                              int64_t bins, const int32_t* col_map, int64_t width,
                              int64_t n_loc, int out_bytes, void* out, void* stream) {
  if (n < 0 || n > n_loc || f < 0 || width < 0 || bins < 1 || bins > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_loc == 0 || width == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(bins);
  switch (out_bytes) {
    case 1:
      return static_cast<int>(
          launch_table<uint8_t>(x, n, f, th, b, col_map, width, n_loc, out, s));
    case 2:
      return static_cast<int>(
          launch_table<uint16_t>(x, n, f, th, b, col_map, width, n_loc, out, s));
    case 4:
      return static_cast<int>(
          launch_table<int32_t>(x, n, f, th, b, col_map, width, n_loc, out, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
