// Per-lane gather probes for NVIDIA Hopper (sm_90a).
//
// Replace the TPU probe kernels of tools/probe_gather.py (each a
// pl.pallas_call on one (8, 128) tile), which asked whether Mosaic can
// gather per lane from a small table: the construct behind the pointcloud
// branch's bitmap lookup (fkcc_device.cuh::pc_vmin_group reads one word of a
// (W * W)-word table per sphere and configuration).  Six probes:
//
//   0 lane      out[r, c] = t[r, idx[r, c]]             t (8, 128) float32
//   1 row       out[r, c] = t[0, idx[r, c]]             t (1, 128) float32
//   2 bits      out[r, c] = (t[0, idx >> 5] >> (idx & 31)) & 1
//                                                        t (1, 128) int32
//   3 two_level out[r, c] = t[ri[r, c], li[r, c]]        t (16, 128) float32
//   4 sublane   out[r, c] = t[idx[r, c], c]              t (8, 128) float32
//   5 timing    out[r, c] = sum_k t[0, (idx[r, c] + k) & 127], k < 64
//
// What bounds it.  Each element reads its indices (4 or 8 bytes) and writes
// 4 bytes; the table (at most 8 KB) is read once a block from L2.  So every
// probe is bound by device-memory bytes: 33.5 MB at 4096 tiles (two_level
// 50 MB), 10 us at 3.35 TB/s.
//
// Design: a stream.  A persistent grid (a few blocks an SM) loads the
// table into shared memory once a block, then every thread strides over
// 16-byte pieces of the index tiles: one int4 load of indices (two for
// two_level), four gathers from shared memory, one float4 / int4 store.  A
// piece's four elements share their tile row (128 lanes are 32 pieces).
// The timing probe's 64 gathers an element all read one 128-entry table,
// so the block first builds the window table
//   W[i] = t[i] + t[(i + 1) & 127] + ... + t[(i + 63) & 127],
// each W[i] summed from 0.0 in k order as the plain version sums it
// (probes/gather.py::plain), and every element is then the one lookup
// W[idx]: bit-identical to the 64-gather sum, and bound by bytes like the
// other probes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kPieces = 8 * kLanes / 4;  // 16-byte pieces of an (8, 128) tile
constexpr int kTwoLevelRows = 16;
constexpr int kWindow = 64;              // gathers an element of the timing probe

__device__ __forceinline__ unsigned bit(const unsigned* s, int k) {
  return (s[k >> 5] >> (k & 31)) & 1u;
}

// The four outputs of piece p (indices k, two_level's columns l) from the
// table s (w: timing's window sums).
__device__ __forceinline__ uint4 piece(int which, const unsigned* s, const float* w, int4 k,
                                       int4 l, long long p) {
  const int c = (int)(p % (kLanes / 4)) * 4;          // lane of the piece's first element
  const int r = (int)((p % kPieces) / (kLanes / 4));  // its tile row
  switch (which) {
    case 0: {
      const unsigned* t = s + r * kLanes;
      return make_uint4(t[k.x], t[k.y], t[k.z], t[k.w]);
    }
    case 1: return make_uint4(s[k.x], s[k.y], s[k.z], s[k.w]);
    case 2: return make_uint4(bit(s, k.x), bit(s, k.y), bit(s, k.z), bit(s, k.w));
    case 3:
      return make_uint4(s[k.x * kLanes + l.x], s[k.y * kLanes + l.y], s[k.z * kLanes + l.z],
                        s[k.w * kLanes + l.w]);
    case 4:
      return make_uint4(s[k.x * kLanes + c], s[k.y * kLanes + c + 1], s[k.z * kLanes + c + 2],
                        s[k.w * kLanes + c + 3]);
    default:
      return make_uint4(__float_as_uint(w[k.x]), __float_as_uint(w[k.y]), __float_as_uint(w[k.z]),
                        __float_as_uint(w[k.w]));
  }
}

__global__ void __launch_bounds__(kThreads) probe_kernel(
    int which, const unsigned* __restrict__ table, const int4* __restrict__ idx,
    const int4* __restrict__ idx2, uint4* __restrict__ out, long long pieces) {
  __shared__ __align__(16) unsigned s[kTwoLevelRows * kLanes];  // table bits
  __shared__ float w[kLanes];                                   // timing's window sums
  const int rows = which == 3 ? kTwoLevelRows : (which == 0 || which == 4) ? 8 : 1;
  for (int i = threadIdx.x; i < rows * kLanes / 4; i += kThreads)
    reinterpret_cast<uint4*>(s)[i] = __ldg(reinterpret_cast<const uint4*>(table) + i);
  __syncthreads();
  if (which == 5) {
    if (threadIdx.x < kLanes) {
      float acc = 0.0f;
#pragma unroll 16
      for (int k = 0; k < kWindow; ++k)
        acc = acc + __uint_as_float(s[(threadIdx.x + k) & (kLanes - 1)]);
      w[threadIdx.x] = acc;
    }
    __syncthreads();
  }
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < pieces;
       p += (long long)gridDim.x * kThreads) {
    const int4 l = which == 3 ? __ldg(idx2 + p) : make_int4(0, 0, 0, 0);
    out[p] = piece(which, s, w, __ldg(idx + p), l, p);
  }
}

// Blocks of kThreads that the current device holds at once, every SM full
// (the occupancy calculator's count, cached per device): the persistent grid.
cudaError_t full_grid(int* grid) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *grid = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *grid;
  return cudaSuccess;
}

}  // namespace

// Launch probe `which` over `tiles` (8, 128) tiles of indices on `stream`:
// a persistent grid (full_grid, or fewer blocks where the tiles need
// fewer) striding over the tiles' 16-byte pieces.  Returns the CUDA error
// code of the launch (0 = ok), or -1 for an unknown probe.  Indices must
// lie in range and every pointer must be 16-byte aligned (the wrapper sees
// to both).
extern "C" int probe_gather_launch(int which, const void* table, const int* idx,
                                   const int* idx2, void* out, int tiles, void* stream) {
  if (which < 0 || which > 5) return -1;
  int grid = 0;
  const cudaError_t err = full_grid(&grid);
  if (err != cudaSuccess) return (int)err;
  const long long pieces = (long long)tiles * kPieces;
  const long long blocks = (pieces + kThreads - 1) / kThreads;
  probe_kernel<<<(int)(blocks < grid ? blocks : grid), kThreads, 0, (cudaStream_t)stream>>>(
      which, static_cast<const unsigned*>(table), reinterpret_cast<const int4*>(idx),
      reinterpret_cast<const int4*>(idx2), static_cast<uint4*>(out), pieces);
  return (int)cudaGetLastError();
}
