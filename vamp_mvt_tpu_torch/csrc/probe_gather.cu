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
// Design.  One block of 1024 threads per (8, 128) tile of indices, one
// thread per element; the grid walks `tiles` tiles, all reading the same
// table, which each block first copies into shared memory (the TPU kernel's
// VMEM operand).  A gather is then one shared-memory load per thread, any
// lane from any address: Hopper has no (8, 128) layout to respect.
//
// What bounds it.  Each element reads its indices (4 or 8 bytes) and writes
// 4 bytes; the table is read once a block from L2.  So the probes are bound
// by device-memory bytes, and the timing probe, 64 shared-memory gathers and
// FP32 adds an element, by the shared-memory load rate.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kTile = kRows * kLanes;
constexpr int kTwoLevelRows = 16;

__global__ void probe_kernel(int which, const void* __restrict__ table,
                             const int* __restrict__ idx, const int* __restrict__ idx2,
                             void* __restrict__ out) {
  __shared__ unsigned s[kTwoLevelRows * kLanes];  // table bits (float32 or int32)
  const int e = threadIdx.x;  // r * 128 + c
  const int c = e % kLanes;
  const int r = e / kLanes;
  const long long o = (long long)blockIdx.x * kTile + e;
  const unsigned* tu = static_cast<const unsigned*>(table);
  const int rows = which == 3 ? kTwoLevelRows : (which == 0 || which == 4) ? kRows : 1;
  for (int i = e; i < rows * kLanes; i += blockDim.x) s[i] = tu[i];
  __syncthreads();
  const int k = idx[o];
  float* of = static_cast<float*>(out);
  switch (which) {
    case 0: of[o] = __uint_as_float(s[r * kLanes + k]); break;
    case 1: of[o] = __uint_as_float(s[k]); break;
    case 2: static_cast<int*>(out)[o] = (int)((s[k >> 5] >> (k & 31)) & 1u); break;
    case 3: of[o] = __uint_as_float(s[k * kLanes + idx2[o]]); break;
    case 4: of[o] = __uint_as_float(s[k * kLanes + c]); break;
    default: {
      float acc = 0.0f;
      for (int j = 0; j < 64; ++j) acc += __uint_as_float(s[(k + j) & (kLanes - 1)]);
      of[o] = acc;
    }
  }
}

}  // namespace

// Launch probe `which` over `tiles` (8, 128) tiles of indices on `stream`;
// returns the CUDA error code of the launch (0 = ok), or -1 for an unknown
// probe.  Indices must lie in range (the wrapper checks them).
extern "C" int probe_gather_launch(int which, const void* table, const int* idx,
                                   const int* idx2, void* out, int tiles, void* stream) {
  if (which < 0 || which > 5) return -1;
  probe_kernel<<<tiles, kTile, 0, (cudaStream_t)stream>>>(which, table, idx, idx2, out);
  return (int)cudaGetLastError();
}
