// Stable row partition of a node-clustered work buffer (K6) for sm_90a.
//
// Replaces quickrank_tpu/ops/pallas_partition.py::_partition_rows_tpu (kernel
// body ::_kernel, wrapper ::partition_rows).  The buffer is u8 [N, W], N a
// multiple of 1024; every 1024-row tile t carries a directive:
//   COPY: the tile moves as it is to row dsta[t];
//   MOVE: its live rows (pos byte, column pos_col, > 0) are split in order:
//         a row with data[r, fstar[t]] <= tstar[t] goes to dsta[t] + its rank
//         among such rows of the tile, the others to dstb[t] + their rank,
//         and the pos byte becomes stamp_z[t] / stamp_o[t];
//   DEAD: nothing is written.
// Rows nobody writes are zero.  By the layout contract of the clustered
// grower (trees/grow_cluster.py) the destinations of different tiles are
// disjoint, so one block takes one tile, in any order, and writes exactly
// the rows it owns: none of the Pallas kernel's sequential grid, fixed-size
// copies that spill into the next tile's rows, or waits between them.
//
// The TPU kernel ranks rows with a triangular-matrix product and moves them
// with a one-hot permutation product on bf16-widened bytes.  Here a byte
// compare is an integer compare, a row's rank is a warp ballot and popcount
// plus an exclusive scan of the block's 32 warp totals, and a row moves as
// 16-byte vectors (so W must be a multiple of 16).
//
// What bounds it on an H100: bytes.  Each input byte is read once and each
// output byte written once (plus the memset of the output), no arithmetic
// to speak of; at 2,655,232 x 160 that is 2 x 425 MB.  The split and pos
// bytes of a MOVE tile are read once more (strided, one byte a row), and a
// moved row is a 160-byte write at a scattered row; staging the tile in
// shared memory for coalesced writes, or TMA, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;     // rows a tile; also threads a block
constexpr int kModeCopy = 0;
constexpr int kModeMove = 1;
constexpr unsigned int kFull = 0xffffffffu;

__device__ inline void set_byte(uint4& v, int byte, unsigned int value) {
  const int shift = (byte & 3) * 8;
  const unsigned int keep = ~(0xffu << shift);
  const unsigned int put = (value & 0xffu) << shift;
  switch (byte >> 2) {
    case 0: v.x = (v.x & keep) | put; break;
    case 1: v.y = (v.y & keep) | put; break;
    case 2: v.z = (v.z & keep) | put; break;
    default: v.w = (v.w & keep) | put; break;
  }
}

__global__ void __launch_bounds__(kTile)
partition_rows_kernel(const uint8_t* __restrict__ data, int64_t n, int width,
                      const int32_t* __restrict__ mode,
                      const int32_t* __restrict__ dsta,
                      const int32_t* __restrict__ dstb,
                      const int32_t* __restrict__ stamp_z,
                      const int32_t* __restrict__ stamp_o,
                      const int32_t* __restrict__ fstar,
                      const int32_t* __restrict__ tstar, int pos_col,
                      uint8_t* __restrict__ out) {
  const int t = blockIdx.x;
  const int m = mode[t];
  if (m != kModeCopy && m != kModeMove) return;
  const int vpr = width / 16;                 // vectors a row
  const int nvec = kTile * vpr;               // vectors a tile
  const uint8_t* tile = data + static_cast<int64_t>(t) * kTile * width;
  const uint4* src = reinterpret_cast<const uint4*>(tile);
  uint4* dst = reinterpret_cast<uint4*>(out);

  if (m == kModeCopy) {
    const int64_t d0 = dsta[t];
    for (int i = threadIdx.x; i < nvec; i += kTile) {
      const int r = i / vpr;
      const int64_t row = d0 + r;
      if (row >= 0 && row < n) dst[row * vpr + (i - r * vpr)] = src[i];
    }
    return;
  }

  __shared__ int s_dest[kTile];               // destination row, -1 = dropped
  __shared__ unsigned char s_stamp[kTile];
  __shared__ int s_zeros[32], s_ones[32];     // per warp: totals, then offsets
  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  const int f = fstar[t];
  if (f < 0 || f >= width) return;            // uniform over the block
  const uint8_t* row = tile + static_cast<int64_t>(r) * width;
  const bool live = row[pos_col] > 0;
  const bool left = static_cast<int>(row[f]) <= tstar[t];
  const bool z = live && left, o = live && !left;
  const unsigned int bz = __ballot_sync(kFull, z), bo = __ballot_sync(kFull, o);
  const unsigned int below = (1u << lane) - 1u;
  if (lane == 0) {
    s_zeros[warp] = __popc(bz);
    s_ones[warp] = __popc(bo);
  }
  __syncthreads();
  if (warp == 0) {
    const int vz = s_zeros[lane], vo = s_ones[lane];
    int iz = vz, io = vo;                     // inclusive scan over the warps
    for (int off = 1; off < 32; off <<= 1) {
      const int uz = __shfl_up_sync(kFull, iz, off);
      const int uo = __shfl_up_sync(kFull, io, off);
      if (lane >= off) {
        iz += uz;
        io += uo;
      }
    }
    s_zeros[lane] = iz - vz;
    s_ones[lane] = io - vo;
  }
  __syncthreads();
  int64_t dest = -1;
  if (z) dest = static_cast<int64_t>(dsta[t]) + s_zeros[warp] + __popc(bz & below);
  if (o) dest = static_cast<int64_t>(dstb[t]) + s_ones[warp] + __popc(bo & below);
  s_dest[r] = (dest >= 0 && dest < n) ? static_cast<int>(dest) : -1;
  s_stamp[r] = static_cast<unsigned char>(z ? stamp_z[t] : stamp_o[t]);
  __syncthreads();

  const int pos_vec = pos_col >> 4, pos_byte = pos_col & 15;
  for (int i = threadIdx.x; i < nvec; i += kTile) {
    const int rr = i / vpr;
    const int v = i - rr * vpr;
    const int d = s_dest[rr];
    if (d < 0) continue;
    uint4 x = src[i];
    if (v == pos_vec) set_byte(x, pos_byte, s_stamp[rr]);
    dst[static_cast<int64_t>(d) * vpr + v] = x;
  }
}

}  // namespace

// out = the repartition of data [n, width] (u8, n % 1024 == 0, width % 16 ==
// 0) by the directives mode, dsta, dstb, stamp_z, stamp_o, fstar, tstar
// (int32 [n / 1024] each); out must not overlap data.  Zeroes out, then
// launches one block a tile, both on `stream`; returns the first CUDA error.
extern "C" int partition_rows(const void* data, int64_t n, int64_t width,
                              const int32_t* mode, const int32_t* dsta,
                              const int32_t* dstb, const int32_t* stamp_z,
                              const int32_t* stamp_o, const int32_t* fstar,
                              const int32_t* tstar, int pos_col, void* out,
                              void* stream) {
  if (n < 0 || n % kTile != 0 || n >= (int64_t{1} << 31) || width < 16 ||
      width % 16 != 0 || width > (1 << 20) || pos_col < 0 || pos_col >= width)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * width, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_rows_kernel<<<static_cast<unsigned int>(n / kTile), kTile, 0, s>>>(
      static_cast<const uint8_t*>(data), n, static_cast<int>(width), mode, dsta,
      dstb, stamp_z, stamp_o, fstar, tstar, pos_col, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
