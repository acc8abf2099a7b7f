// Megakernel-construct probes for NVIDIA Hopper (sm_90a).
//
// Replace the TPU probe kernels of tools/probe_mosaic.py (eight
// pl.pallas_call sites) and tools/probe_mosaic2.py (seven), which asked
// which constructs Mosaic compiles for the planner megakernel: loop carries,
// rows written at a runtime index, scalar scratch, in-kernel dots and
// argmins, a grid whose steps share scratch, cross-lane reductions, integer
// division, a lane cumsum.  Each probe here computes the TPU probe's
// function on a leading axis of tiles, one block per tile (the probes and
// their layouts are listed in vamp_mvt_tpu_torch/probes/mosaic.py):
//
//    0 while_carry     8 reduce_while
//    1 dyn_sublane     9 halton_digits
//    2 smem_writes    10 cumsum_first
//    3 dot_argmin     11 transpose
//    4 nested_loops   12 static_reads
//    5 grid_carry     13 dyn_rows_while
//    6 group32_sum    14 smem_int_out
//    7 scratch_diag
//
// Design.  A block of 256 threads takes one tile; the TPU's VMEM and SMEM
// scratch become shared memory (one static buffer of 20 KB, reinterpreted
// per probe), a scalar carried by the TPU's scalar core becomes a scalar of
// thread 0 in shared memory, and a row update becomes one thread a lane.
// Two TPU constructs have no Hopper counterpart and are translated:
//   - grid_carry: the TPU grid runs its steps in order and lets them share
//     scratch; CUDA blocks run in no order and share nothing, so one block
//     loops over the steps and carries the accumulator in shared memory
//     (a persistent block), never blocks racing on a global counter;
//   - the cross-lane group-of-32 sum, a (128, 4) matmul on the TPU, is one
//     warp per group reduced with __shfl_xor_sync; the lane cumsum (roll and
//     mask on the TPU) is a __ballot_sync + __popc scan.
// dot_argmin sums its 8-term dots in index order (--fmad=false, no cuBLAS),
// as the plain version does; ties go to the lowest row.
//
// What bounds it.  Every probe but dot_argmin reads and writes a few KB a
// tile and does a few operations an element: bound by device-memory bytes
// (and, at a few KB a tile, by launch and block scheduling).  dot_argmin
// does 512 x 64 dots of 8 terms a tile on 18 KB: bound by FP32 operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kTile = 8 * kLanes;          // (8, 128)
constexpr int kTallTile = 16 * kLanes;     // (16, 128)
constexpr int kArgRows = 512, kArgK = 8, kArgCols = 64;
constexpr int kGroups = kThreads / kArgCols;  // row groups of dot_argmin
constexpr int kGridSteps = 4, kGridCols = 8;
constexpr int kScalarWrites = 512;
constexpr int kHaltonRows = 64, kHaltonDigits = 8;
constexpr int kTransposed = 64;
constexpr int kNone = 1000000000;          // "no such lane"
constexpr int kSmemFloats = kArgRows * kArgK + kArgK * kArgCols + 2 * kGroups * kArgCols;
// 1 / 3^8, rounded once to float32 (the TPU probe's constant)
constexpr float kInvHalton = (float)(1.0 / 6561.0);

struct Args {
  const void* in0;
  const void* in1;
  void* out0;
  void* out1;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// 0: while i < 10 and acc < 100: o[0] += x[0], acc += x[0, 0]; s = acc.
__device__ void while_carry(const Args& a, int b, int tid, int* s_int) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTile;
  float* o = static_cast<float*>(a.out0) + (long long)b * kTile;
  float row = 0.0f;        // o[0, tid], thread tid < 128
  float acc = 0.0f;        // thread 0's carry
  int i = 0;
  for (;;) {
    if (tid == 0) s_int[0] = (i < 10) && (acc < 100.0f);
    __syncthreads();
    const bool go = s_int[0] != 0;
    __syncthreads();  // every thread has read the flag before it changes
    if (!go) break;
    if (tid < kLanes) row = row + x[tid];
    if (tid == 0) {
      acc = acc + x[0];
      ++i;
    }
  }
  for (int e = tid; e < kTile; e += kThreads) o[e] = e < kLanes ? row : 0.0f;
  if (tid == 0) static_cast<float*>(a.out1)[b] = acc;
}

// 1: idx = int(x[0, 0]); o = 0; o[idx] = 2 x[0]; s = o[idx, 5].
__device__ void dyn_sublane(const Args& a, int b, int tid, float* s) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTallTile;
  float* o = static_cast<float*>(a.out0) + (long long)b * kTallTile;
  for (int e = tid; e < kTallTile; e += kThreads) s[e] = 0.0f;
  __syncthreads();
  const int idx = __float2int_rz(x[0]);
  if (tid < kLanes) s[idx * kLanes + tid] = 2.0f * x[tid];
  __syncthreads();
  for (int e = tid; e < kTallTile; e += kThreads) o[e] = s[e];
  if (tid == 0) static_cast<float*>(a.out1)[b] = s[idx * kLanes + 5];
}

// 2: smem[i] = 2i + off for i < 512; out = smem[511] + smem[3].
__device__ void smem_writes(const Args& a, int b, int tid, int* s_int) {
  const int off = static_cast<const int*>(a.in0)[b];
  for (int i = tid; i < kScalarWrites; i += kThreads) s_int[i] = 2 * i + off;
  __syncthreads();
  if (tid == 0) static_cast<int*>(a.out0)[b] = s_int[kScalarWrites - 1] + s_int[3];
}

// 3: d2 = a (512, 8) @ b (8, 64), summed in index order; the lowest row of
// each column's minimum.
__device__ void dot_argmin(const Args& a, int b, int tid, float* s) {
  const float* A = static_cast<const float*>(a.in0) + (long long)b * kArgRows * kArgK;
  const float* Bm = static_cast<const float*>(a.in1) + (long long)b * kArgK * kArgCols;
  float* sa = s;
  float* sb = sa + kArgRows * kArgK;
  float* sv = sb + kArgK * kArgCols;
  int* si = reinterpret_cast<int*>(sv + kGroups * kArgCols);
  for (int e = tid; e < kArgRows * kArgK; e += kThreads) sa[e] = A[e];
  for (int e = tid; e < kArgK * kArgCols; e += kThreads) sb[e] = Bm[e];
  __syncthreads();
  const int c = tid % kArgCols, g = tid / kArgCols;
  const int rows = kArgRows / kGroups;
  float best = __int_as_float(0x7f800000);  // +inf
  int arg = kNone;
  for (int r = g * rows; r < (g + 1) * rows; ++r) {
    const float* ar = sa + r * kArgK;
    float d = ar[0] * sb[c];
    for (int k = 1; k < kArgK; ++k) d = d + ar[k] * sb[k * kArgCols + c];
    if (d < best) {  // strict: the first (lowest) row of a tie stays
      best = d;
      arg = r;
    }
  }
  sv[g * kArgCols + c] = best;
  si[g * kArgCols + c] = arg;
  __syncthreads();
  if (tid < kArgCols) {
    best = sv[tid];
    arg = si[tid];
    for (int h = 1; h < kGroups; ++h) {  // groups in row order: ties keep the lower
      if (sv[h * kArgCols + tid] < best) {
        best = sv[h * kArgCols + tid];
        arg = si[h * kArgCols + tid];
      }
    }
    static_cast<int*>(a.out0)[(long long)b * kArgCols + tid] = arg;
  }
}

// 4: while c < L: (m times: counter += 1); o[c] = c; c += 1. s = counter.
__device__ void nested_loops(const Args& a, int b, int tid, float* s, int* s_int) {
  const int L = static_cast<const int*>(a.in0)[2 * b];
  const int m = static_cast<const int*>(a.in0)[2 * b + 1];
  float* o = static_cast<float*>(a.out0) + (long long)b * kTile;
  for (int e = tid; e < kTile; e += kThreads) s[e] = 0.0f;
  if (tid == 0) s_int[0] = 0;
  __syncthreads();
  for (int c = 0; c < L; ++c) {
    if (tid == 0) {
      volatile int* counter = s_int;
      for (int i = 0; i < m; ++i) *counter = *counter + 1;
    }
    if (tid < kLanes) s[c * kLanes + tid] = (float)c;
  }
  __syncthreads();
  for (int e = tid; e < kTile; e += kThreads) o[e] = s[e];
  if (tid == 0) static_cast<int*>(a.out1)[b] = s_int[0];
}

// 5: out[g] = sum over steps h <= g of x[h, 0]: one block walks the steps in
// order, the accumulator in shared memory.
__device__ void grid_carry(const Args& a, int b, int tid, int* s_int) {
  const int* x = static_cast<const int*>(a.in0) + (long long)b * kGridSteps * kGridCols;
  int* out = static_cast<int*>(a.out0) + (long long)b * kGridSteps;
  for (int g = 0; g < kGridSteps; ++g) {
    if (tid == 0) s_int[0] = (g == 0 ? 0 : s_int[0]) + x[g * kGridCols];
    __syncthreads();
    if (tid == 0) out[g] = s_int[0];
    __syncthreads();
  }
}

// 6: (8, 128) -> (8, 4) sums of 32-lane groups, one warp a group.
__device__ void group32_sum(const Args& a, int b, int tid) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTile;
  float* out = static_cast<float*>(a.out0) + (long long)b * 32;
  const int warp = tid >> 5, lane = tid & 31;
  for (int grp = warp; grp < 32; grp += kThreads / 32) {  // row grp / 4, group grp % 4
    const float v = warp_sum(x[grp * 32 + lane]);
    if (lane == 0) out[grp] = v;
  }
}

// 7: scratch = 3 x; out = sum over i < 8 of int(scratch[i, i]).
__device__ void scratch_diag(const Args& a, int b, int tid, float* s) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTile;
  for (int e = tid; e < kTile; e += kThreads) s[e] = x[e] * 3.0f;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int i = 0; i < 8; ++i) total += __float2int_rz(s[i * kLanes + i]);
    static_cast<int*>(a.out0)[b] = total;
  }
}

// 8: n = int(sum x) + 2 int(max x[0]); c = 0; while c < 10 n: c += n.
__device__ void reduce_while(const Args& a, int b, int tid, float* s) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTile;
  const int warp = tid >> 5, lane = tid & 31;
  float v = 0.0f;
  for (int e = tid; e < kTile; e += kThreads) v += x[e];
  v = warp_sum(v);
  float m = warp < kLanes / 32 ? warp_max(x[tid]) : 0.0f;
  if (lane == 0) {
    s[warp] = v;
    s[8 + warp] = m;
  }
  __syncthreads();
  if (tid == 0) {
    float total = s[0];
    for (int w = 1; w < kThreads / 32; ++w) total += s[w];
    float mx = s[8];
    for (int w = 1; w < kLanes / 32; ++w) mx = fmaxf(mx, s[8 + w]);
    const int n = __float2int_rz(total) + __float2int_rz(mx) * 2;
    // For n <= 0 the loop takes no step (0 < 10 n is false), so the guard
    // changes no result.  Without it a launch on 4096 seeded tiles, about
    // half of them with n <= 0, took 14.6 s on an H100 (results exact).
    int c = 0;
    if (n > 0) {
      while (c < 10 * n) c += n;
    }
    static_cast<int*>(a.out0)[b] = c;
  }
}

// 9: row r: 8 base-3 digits of base + r, reversed, times 1 / 3^8, on every lane.
__device__ void halton_digits(const Args& a, int b, int tid) {
  const int base = static_cast<const int*>(a.in0)[b];
  float* out = static_cast<float*>(a.out0) + (long long)b * kHaltonRows * kLanes;
  for (int e = tid; e < kHaltonRows * kLanes; e += kThreads) {
    int i = base + e / kLanes;
    int n = 0;
    for (int k = 0; k < kHaltonDigits; ++k) {
      n = n * 3 + i % 3;
      i = i / 3;
    }
    out[e] = (float)n * kInvHalton;
  }
}

// 10: inclusive cumsum of the 0/1 row x[0]; s = the lane of its third 1, or 1e9.
__device__ void cumsum_first(const Args& a, int b, int tid, int* s_int) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTile;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) s_int[4] = kNone;
  bool on = false;
  int count = 0;
  if (warp < kLanes / 32) {
    on = x[tid] > 0.0f;
    const unsigned bits = __ballot_sync(0xffffffffu, on);
    count = __popc(bits & (0xffffffffu >> (31 - lane)));  // lanes <= this one
    if (lane == 31) s_int[warp] = count;
  }
  __syncthreads();
  if (warp < kLanes / 32) {
    for (int w = 0; w < warp; ++w) count += s_int[w];
    static_cast<float*>(a.out1)[(long long)b * kLanes + tid] = (float)count;
    if (on && count == 3) atomicMin(&s_int[4], tid);
  }
  __syncthreads();
  if (tid == 0) static_cast<int*>(a.out0)[b] = s_int[4];
}

// 11: the row x[0, :64] written as a column (64, 1), through shared memory.
__device__ void transpose(const Args& a, int b, int tid, float* s) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTile;
  if (tid < kTransposed) s[tid] = x[tid];
  __syncthreads();
  if (tid < kTransposed)  // thread t writes row t of the column from the shared row
    static_cast<float*>(a.out0)[(long long)b * kTransposed + tid] = s[tid];
}

// 12: scratch = 2 x; s = (int(scratch[3, 5]), int(scratch[7, 127])).
__device__ void static_reads(const Args& a, int b, int tid, float* s) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTile;
  for (int e = tid; e < kTile; e += kThreads) s[e] = x[e] * 2.0f;
  __syncthreads();
  if (tid == 0) {
    int* out = static_cast<int*>(a.out0) + 2 * (long long)b;
    out[0] = __float2int_rz(s[3 * kLanes + 5]);
    out[1] = __float2int_rz(s[7 * kLanes + 127]);
  }
}

// 13: o = 0; o[0] = x[0]; o[n] = o[n - 1] + 1 for n = 1..L; s = L + 1.
__device__ void dyn_rows_while(const Args& a, int b, int tid, float* s) {
  const float* x = static_cast<const float*>(a.in0) + (long long)b * kTallTile;
  const int L = static_cast<const int*>(a.in1)[b];
  float* o = static_cast<float*>(a.out0) + (long long)b * kTallTile;
  for (int e = tid; e < kTallTile; e += kThreads) s[e] = e < kLanes ? x[e] : 0.0f;
  __syncthreads();
  int i = 0, n = 1;
  while (i < L) {
    if (tid < kLanes) s[n * kLanes + tid] = s[(n - 1) * kLanes + tid] + 1.0f;
    __syncthreads();
    ++i;
    ++n;
  }
  for (int e = tid; e < kTallTile; e += kThreads) o[e] = s[e];
  if (tid == 0) static_cast<int*>(a.out1)[b] = n;
}

// 14: out[0, i] = 3i + off for i < 512, written by one thread in a loop.
__device__ void smem_int_out(const Args& a, int b, int tid) {
  if (tid != 0) return;
  const int off = static_cast<const int*>(a.in0)[b];
  int* out = static_cast<int*>(a.out0) + (long long)b * kScalarWrites;
  for (int i = 0; i < kScalarWrites; ++i) out[i] = i * 3 + off;
}

__global__ void __launch_bounds__(kThreads) probe_kernel(int which, Args a) {
  __shared__ float s[kSmemFloats];
  __shared__ int s_int[kScalarWrites];
  const int b = blockIdx.x, tid = threadIdx.x;
  switch (which) {
    case 0: while_carry(a, b, tid, s_int); break;
    case 1: dyn_sublane(a, b, tid, s); break;
    case 2: smem_writes(a, b, tid, s_int); break;
    case 3: dot_argmin(a, b, tid, s); break;
    case 4: nested_loops(a, b, tid, s, s_int); break;
    case 5: grid_carry(a, b, tid, s_int); break;
    case 6: group32_sum(a, b, tid); break;
    case 7: scratch_diag(a, b, tid, s); break;
    case 8: reduce_while(a, b, tid, s); break;
    case 9: halton_digits(a, b, tid); break;
    case 10: cumsum_first(a, b, tid, s_int); break;
    case 11: transpose(a, b, tid, s); break;
    case 12: static_reads(a, b, tid, s); break;
    case 13: dyn_rows_while(a, b, tid, s); break;
    default: smem_int_out(a, b, tid);
  }
}

}  // namespace

// Launch probe `which` over `tiles` tiles, one block of 256 threads each, on
// `stream`; returns the CUDA error code of the launch (0 = ok), or -1 for an
// unknown probe.  Inputs must lie in the ranges the wrapper checks.
extern "C" int probe_mosaic_launch(int which, const void* in0, const void* in1, void* out0,
                                   void* out1, int tiles, void* stream) {
  if (which < 0 || which > 14) return -1;
  probe_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(which, Args{in0, in1, out0, out1});
  return (int)cudaGetLastError();
}
