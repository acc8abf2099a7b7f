// Megakernel-construct probes for NVIDIA Hopper (sm_90a).
//
// Replace the TPU probe kernels of tools/probe_mosaic.py (eight
// pl.pallas_call sites) and tools/probe_mosaic2.py (seven), which asked
// which constructs Mosaic compiles for the planner megakernel: loop carries,
// rows written at a runtime index, scalar scratch, in-kernel dots and
// argmins, a grid whose steps share scratch, cross-lane reductions, integer
// division, a lane cumsum.  Each probe here computes the TPU probe's
// function on a leading axis of tiles (the probes and their layouts are
// listed in vamp_mvt_tpu_torch/probes/mosaic.py):
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
// The port holds each probe's function, not its TPU construct: the TPU's
// VMEM and SMEM scratch, its scalar core and its sequential grid have no
// counterpart to keep.  Three kernels, each striding over its units of
// independent work (probe_kernel and probe_tiles_kernel in persistent
// grids, dot_argmin_kernel a block a tile in a capped grid), reading only
// the input words the outputs depend on, with 128-bit loads and stores and
// no barrier where the lanes are independent:
//   - probe_kernel, a thread a unit: a tile for the probes with one or two
//     scalar outputs (smem_writes, grid_carry, static_reads; scratch_diag
//     a lane a diagonal word, summed with shuffles);
//     a float4 of row 0 for the row chains (while_carry, dyn_sublane,
//     dyn_rows_while), which write the tile's other rows as zeros; a float4
//     or int4 column of the output for nested_loops and smem_int_out; a row
//     for halton_digits, whose warp writes its 32 rows with coalesced
//     stores.  Where the units are too few to fill every SM with blocks of
//     256 threads (the scalar probes: a thread a tile), the launch spreads
//     them over every SM in blocks of fewer whole warps;
//   - dot_argmin_kernel, a block a tile with shared memory of its own, in
//     a grid of at most kArgWaves times the blocks the card holds at once;
//   - probe_tiles_kernel (group32_sum, reduce_while, cumsum_first,
//     transpose): a warp a tile, or a thread a 16-byte piece.
// Where the output has an exact integer closed form the kernel computes that
// form (smem_writes, smem_int_out, nested_loops' counter; int32 arithmetic
// wraps as the plain version's does).  Float chains keep the plain
// version's adds in its order, and dot_argmin its index-order dots without
// FMA (--fmad=false), so every probe is bit-equal to probes/mosaic.py::plain.
//
// What bounds it.  Every probe but dot_argmin moves bytes: at 4096 tiles
// from 0.3 MB (static_reads) to 134 MB (halton_digits' output), and the
// smallest stay under what any launch takes.  dot_argmin does 512 x 64
// dots of 8 terms a tile: bound by FP32 issue (15 FP32 instructions and a
// compare a dot without FMA).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBlocksPerSm = 4;        // probe_tiles_kernel's grid, per SM
constexpr int kLanes = 128;
constexpr int kTile = 8 * kLanes;          // (8, 128)
constexpr int kTallTile = 16 * kLanes;     // (16, 128)
constexpr int kRow4 = kLanes / 4;          // float4 pieces of a row
constexpr int kArgRows = 512, kArgK = 8, kArgCols = 64;
constexpr int kArgColsPerLane = kArgCols / 32;      // dot_argmin: columns a lane keeps
constexpr int kArgRowsPerWarp = kArgRows / kWarps;  // 64
constexpr int kArgWaves = 4;  // dot_argmin's grid: at most this many times the resident blocks
constexpr int kGridSteps = 4, kGridCols = 8;
constexpr int kScalarWrites = 512;
constexpr int kHaltonRows = 64, kHaltonDigits = 8;
constexpr int kTransposed = 64;
constexpr int kNone = 1000000000;          // "no such lane"
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

__device__ __forceinline__ float4 add4(float4 v, float s) {
  return make_float4(v.x + s, v.y + s, v.z + s, v.w + s);
}

__device__ __forceinline__ const float4* tile_in4(const void* base, long long b, int tile) {
  return reinterpret_cast<const float4*>(static_cast<const float*>(base) + b * tile);
}

__device__ __forceinline__ float4* tile_out4(void* base, long long b, int tile) {
  return reinterpret_cast<float4*>(static_cast<float*>(base) + b * tile);
}

// ---------------------------------------------------------------------------
// The probes of probe_kernel: unit u is a thread's work.

// 0: while i < 10 and acc < 100: o[0] += x[0], acc += x[0, 0]; s = acc.
// Unit: float4 j of tile b's row 0.  The trip count depends on x[0, 0]
// alone, so the thread runs the loop on its four lanes in registers, the
// same adds in the same order, then writes zeros below them (rows 1..7).
__device__ void while_carry(const Args& a, long long u) {
  const long long b = u / kRow4;
  const int j = (int)(u % kRow4);
  const float4 v = __ldg(tile_in4(a.in0, b, kTile) + j);
  const float x00 = __ldg(static_cast<const float*>(a.in0) + b * kTile);
  float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float acc = 0.0f;
  for (int i = 0; i < 10 && acc < 100.0f; ++i) {
    row = make_float4(row.x + v.x, row.y + v.y, row.z + v.z, row.w + v.w);
    acc = acc + x00;
  }
  float4* o = tile_out4(a.out0, b, kTile) + j;
  o[0] = row;
  for (int r = 1; r < 8; ++r) o[r * kRow4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j == 0) static_cast<float*>(a.out1)[b] = acc;
}

// 1: idx = int(x[0, 0]); o = 0; o[idx] = 2 x[0]; s = o[idx, 5].
// Unit: float4 j of tile b's row 0, doubled into row idx of its column and
// zeros into the other 15; the piece holding lane 5 writes s.
__device__ void dyn_sublane(const Args& a, long long u) {
  const long long b = u / kRow4;
  const int j = (int)(u % kRow4);
  const float4 x = __ldg(tile_in4(a.in0, b, kTallTile) + j);
  const int idx = __float2int_rz(__ldg(static_cast<const float*>(a.in0) + b * kTallTile));
  const float4 v = make_float4(x.x * 2.0f, x.y * 2.0f, x.z * 2.0f, x.w * 2.0f);
  float4* o = tile_out4(a.out0, b, kTallTile) + j;
  for (int r = 0; r < 16; ++r) o[r * kRow4] = r == idx ? v : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j == 1) static_cast<float*>(a.out1)[b] = v.y;
}

// 13: o = 0; o[0] = x[0]; o[n] = o[n - 1] + 1 for n = 1..L; s = L + 1.
// Unit: float4 j of tile b's row 0, carried down its column one add a row.
__device__ void dyn_rows_while(const Args& a, long long u) {
  const long long b = u / kRow4;
  const int j = (int)(u % kRow4);
  const int L = __ldg(static_cast<const int*>(a.in1) + b);
  float4 v = __ldg(tile_in4(a.in0, b, kTallTile) + j);
  float4* o = tile_out4(a.out0, b, kTallTile) + j;
  o[0] = v;
  for (int r = 1; r < 16; ++r) {
    if (r <= L) v = add4(v, 1.0f);
    o[r * kRow4] = r <= L ? v : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (j == 0) static_cast<int*>(a.out1)[b] = L + 1;
}

// 2: smem[i] = 2i + off for i < 512; out = smem[511] + smem[3], in closed
// form: (2 * 511 + off) + (2 * 3 + off).  Unit: a tile.
__device__ void smem_writes(const Args& a, long long b) {
  const unsigned off = (unsigned)__ldg(static_cast<const int*>(a.in0) + b);
  static_cast<int*>(a.out0)[b] = (int)((2u * (kScalarWrites - 1) + off) + (2u * 3u + off));
}

// 14: out[0, i] = 3i + off for i < 512, in closed form.  Unit: int4 column
// j of tile b (int4 pieces j, j + 32, j + 64, j + 96), one read of off.
__device__ void smem_int_out(const Args& a, long long u) {
  const long long b = u / 32;
  const int j = (int)(u % 32);
  const unsigned off = (unsigned)__ldg(static_cast<const int*>(a.in0) + b);
  int4* o = reinterpret_cast<int4*>(a.out0) + b * (kScalarWrites / 4) + j;
#pragma unroll
  for (int m = 0; m < kScalarWrites / 128; ++m) {
    const unsigned i = 4u * (unsigned)(j + 32 * m);
    o[32 * m] = make_int4((int)(3u * i + off), (int)(3u * (i + 1u) + off),
                          (int)(3u * (i + 2u) + off), (int)(3u * (i + 3u) + off));
  }
}

// 4: while c < L: (m times: counter += 1); o[c] = c; c += 1.  s = counter.
// In closed form: o[c] = c for c < L, 0 below; the counter is L m.  Unit:
// float4 column j of tile b (its 8 rows), one read of (L, m); column 0
// writes s.
__device__ void nested_loops(const Args& a, long long u) {
  const long long b = u / kRow4;
  const int j = (int)(u % kRow4);
  const int2 lm = __ldg(static_cast<const int2*>(a.in0) + b);
  float4* o = tile_out4(a.out0, b, kTile) + j;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float v = r < lm.x ? (float)r : 0.0f;
    o[r * kRow4] = make_float4(v, v, v, v);
  }
  if (j == 0) static_cast<int*>(a.out1)[b] = (int)((unsigned)lm.x * (unsigned)lm.y);
}

// 5: out[g] = x[0, 0] + ... + x[g, 0], g < 4: the TPU grid's steps in
// order, the carry in a register.  Unit: a tile, one int4 store.
__device__ void grid_carry(const Args& a, long long b) {
  const int* x = static_cast<const int*>(a.in0) + b * kGridSteps * kGridCols;
  const unsigned c0 = (unsigned)__ldg(x), c1 = c0 + (unsigned)__ldg(x + kGridCols);
  const unsigned c2 = c1 + (unsigned)__ldg(x + 2 * kGridCols);
  const unsigned c3 = c2 + (unsigned)__ldg(x + 3 * kGridCols);
  reinterpret_cast<int4*>(a.out0)[b] = make_int4((int)c0, (int)c1, (int)c2, (int)c3);
}

// 7: scratch = 3 x; out = sum over i < 8 of int(scratch[i, i]) (int
// truncates): the eight diagonal words.  Unit: word u % 8 of tile u / 8; the
// tile's eight lanes add their words with shuffles (int32 wrapping, so any
// order gives the sum) and the first writes it.  The words lie on eight
// rows, so a lane each reads them with a quarter of the warp's load
// instructions a thread a tile would issue.  `live` is false on the units
// that pad the last warp.
__device__ void scratch_diag(const Args& a, long long u, bool live) {
  const float* x = static_cast<const float*>(a.in0) + (u / 8) * kTile;
  unsigned v = live ? (unsigned)__float2int_rz(__ldg(x + (u % 8) * (kLanes + 1)) * 3.0f) : 0u;
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  if (live && u % 8 == 0) static_cast<int*>(a.out0)[u / 8] = (int)v;
}

// 12: scratch = 2 x; s = (int(scratch[3, 5]), int(scratch[7, 127])): the two
// words.  Unit: a tile, one int2 store.
__device__ void static_reads(const Args& a, long long b) {
  const float* x = static_cast<const float*>(a.in0) + b * kTile;
  reinterpret_cast<int2*>(a.out0)[b] =
      make_int2(__float2int_rz(__ldg(x + 3 * kLanes + 5) * 2.0f),
                __float2int_rz(__ldg(x + 7 * kLanes + 127) * 2.0f));
}

// 9: row r: 8 base-3 digits of base + r, reversed, times 1 / 3^8, on every
// lane.  Unit: a row (a tile's 64 rows are units 64 b ..); a warp's 32
// units are 32 rows of one tile.  Each lane takes its row's digits once,
// then the warp writes the 32 rows in turn, each as one coalesced 512-byte
// store of 32 float4, the value shuffled from the row's lane.
__device__ void halton_digits(const Args& a, long long u) {
  const int lane = threadIdx.x & 31;
  unsigned i = (unsigned)__ldg(static_cast<const int*>(a.in0) + u / kHaltonRows) +
               (unsigned)(u % kHaltonRows);
  unsigned n = 0;
#pragma unroll
  for (int k = 0; k < kHaltonDigits; ++k) {
    n = n * 3u + i % 3u;
    i /= 3u;
  }
  const float val = (float)n * kInvHalton;
  float4* rows = reinterpret_cast<float4*>(a.out0) + (u - lane) * kRow4;
  for (int k = 0; k < 32; ++k) {
    const float v = __shfl_sync(0xffffffffu, val, k);
    rows[k * kRow4 + lane] = make_float4(v, v, v, v);
  }
}

// Units of probe `which` over `tiles` tiles.
__host__ __device__ long long probe_units(int which, long long tiles) {
  switch (which) {
    case 0: case 1: case 4: case 13: case 14: return tiles * kRow4;  // columns
    case 7: return tiles * 8;                                        // diagonal words
    case 9: return tiles * kHaltonRows;                              // rows
    default: return tiles;                                           // 2, 5, 12
  }
}

// Every thread strides over the units, padded to whole warps (blocks are
// whole warps), so that a warp's lanes run the same iterations: the
// shuffles of halton_digits (whose units are whole warps) and scratch_diag
// need the whole warp.
__global__ void __launch_bounds__(kThreads) probe_kernel(int which, Args a, long long units) {
  const long long span = (units + 31) / 32 * 32;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < span;
       u += (long long)gridDim.x * blockDim.x) {
    if (which == 7) {
      scratch_diag(a, u, u < units);
      continue;
    }
    if (u >= units) continue;
    switch (which) {
      case 0: while_carry(a, u); break;
      case 1: dyn_sublane(a, u); break;
      case 2: smem_writes(a, u); break;
      case 4: nested_loops(a, u); break;
      case 5: grid_carry(a, u); break;
      case 9: halton_digits(a, u); break;
      case 12: static_reads(a, u); break;
      case 13: dyn_rows_while(a, u); break;
      default: smem_int_out(a, u);
    }
  }
}

// ---------------------------------------------------------------------------
// 3: d = a (512, 8) @ b (8, 64), each dot summed in index order; out[c] =
// the lowest row of column c's minimum.
//
// A block takes a tile at a time, striding over the tiles.  The launch caps
// the grid at kArgWaves times the blocks the card holds at once (four an
// SM), so at 4096 tiles a block takes two: with four blocks an SM, one
// block's copy of its rows overlaps the others' dots, and the hardware
// hands the last blocks to whichever SM is free.  On an H100 this read
// faster than a block for every tile and than one wave of blocks (PERF.md
// section 6).  The block copies the tile's a (16 KB) into shared memory
// with float4 loads.  Warp w takes rows 64 w .. 64 w + 63; lane l the b
// columns l and l + 32, kept in registers (16 floats).  A row is read as
// two float4 that every lane of the warp reads at once (a broadcast) and
// serves both dots.  A dot is 8 multiplies
// and 7 adds in index order (no FMA: --fmad=false), as plain sums it.  Each
// lane keeps its columns' least value and its row, started at the warp's
// first row and replaced only by a strictly smaller value, so ties keep the
// lower row; the 64-row loop is unrolled, each row's offset an immediate.
// The eight warps' results meet in shared memory, where warp 0 takes them
// in row order, again strictly.  Each dot costs 15 FP32 instructions and
// three for the compare: the kernel is bound by instruction issue.
__device__ __forceinline__ float dot8(float4 lo, float4 hi, const float* b) {
  float d = lo.x * b[0];
  d = d + lo.y * b[1];
  d = d + lo.z * b[2];
  d = d + lo.w * b[3];
  d = d + hi.x * b[4];
  d = d + hi.y * b[5];
  d = d + hi.z * b[6];
  d = d + hi.w * b[7];
  return d;
}

__global__ void __launch_bounds__(kThreads) dot_argmin_kernel(Args a, int tiles) {
  __shared__ __align__(16) float sa[kArgRows * kArgK];
  __shared__ float sv[kWarps * kArgCols];
  __shared__ int si[kWarps * kArgCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const float4* A = static_cast<const float4*>(a.in0) + (long long)t * (kArgRows * kArgK / 4);
    for (int e = threadIdx.x; e < kArgRows * kArgK / 4; e += kThreads)
      reinterpret_cast<float4*>(sa)[e] = __ldg(A + e);
    const float* B = static_cast<const float*>(a.in1) + (long long)t * kArgK * kArgCols;
    float bc[kArgColsPerLane][kArgK];
#pragma unroll
    for (int m = 0; m < kArgColsPerLane; ++m)
#pragma unroll
      for (int k = 0; k < kArgK; ++k) bc[m][k] = __ldg(B + k * kArgCols + lane + 32 * m);
    __syncthreads();
    const float4* rows = reinterpret_cast<const float4*>(sa) + 2 * kArgRowsPerWarp * warp;
    float best[kArgColsPerLane];
    int arg[kArgColsPerLane];
#pragma unroll
    for (int m = 0; m < kArgColsPerLane; ++m) {
      best[m] = dot8(rows[0], rows[1], bc[m]);
      arg[m] = 0;
    }
#pragma unroll
    for (int r = 1; r < kArgRowsPerWarp; ++r) {
      const float4 lo = rows[2 * r], hi = rows[2 * r + 1];
#pragma unroll
      for (int m = 0; m < kArgColsPerLane; ++m) {
        const float d = dot8(lo, hi, bc[m]);
        if (d < best[m]) {
          best[m] = d;
          arg[m] = r;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kArgColsPerLane; ++m) {
      sv[warp * kArgCols + lane + 32 * m] = best[m];
      si[warp * kArgCols + lane + 32 * m] = kArgRowsPerWarp * warp + arg[m];
    }
    __syncthreads();
    if (warp == 0) {
      for (int c = lane; c < kArgCols; c += 32) {
        float v = sv[c];
        int r = si[c];
        for (int w = 1; w < kWarps; ++w) {
          if (sv[w * kArgCols + c] < v) {
            v = sv[w * kArgCols + c];
            r = si[w * kArgCols + c];
          }
        }
        static_cast<int*>(a.out0)[(long long)t * kArgCols + c] = r;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The probes of probe_tiles_kernel: one warp a tile (lane `lane` of the warp
// on tile b), or for transpose one thread a 16-byte piece.

__device__ __forceinline__ const float4* tile4(const void* base, long long b) {
  return reinterpret_cast<const float4*>(static_cast<const float*>(base) + b * kTile);
}

// 6: (8, 128) -> (8, 4) sums of 32-lane groups: lane l sums group l (row
// l / 4, lanes 32 (l % 4) ..), its 32 floats read as 8 float4, in index
// order.
__device__ void group32_sum(const Args& a, long long b, int lane) {
  const float4* x = tile4(a.in0, b) + lane * 8;
  float4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(x + k);
  float acc = v[0].x;
  acc = acc + v[0].y;
  acc = acc + v[0].z;
  acc = acc + v[0].w;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    acc = acc + v[k].x;
    acc = acc + v[k].y;
    acc = acc + v[k].z;
    acc = acc + v[k].w;
  }
  static_cast<float*>(a.out0)[b * 32 + lane] = acc;
}

// 8: n = int(sum x) + 2 int(max x[0]); c = 0; while c < 10 n: c += n.  The
// warp reads the tile as 8 coalesced rows of float4 (the first is row 0).
__device__ void reduce_while(const Args& a, long long b, int lane) {
  const float4* x = tile4(a.in0, b);
  float4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(x + k * 32 + lane);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  sum = warp_sum(sum);
  const float mx = warp_max(fmaxf(fmaxf(v[0].x, v[0].y), fmaxf(v[0].z, v[0].w)));
  if (lane == 0) {
    const int n = __float2int_rz(sum) + __float2int_rz(mx) * 2;
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

// 10: inclusive cumsum of the 0/1 row x[0]; s = the lane of its third 1, or
// 1e9.  Lane l takes x[0, 4 l .. 4 l + 3] as one float4 and counts its 1s;
// a warp scan of the counts gives each lane its offset.
__device__ void cumsum_first(const Args& a, long long b, int lane) {
  const float4 v = __ldg(tile4(a.in0, b) + lane);
  const int c0 = v.x > 0.0f, c1 = c0 + (v.y > 0.0f), c2 = c1 + (v.z > 0.0f);
  const int c3 = c2 + (v.w > 0.0f);
  int incl = c3;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int base = incl - c3;
  reinterpret_cast<float4*>(a.out1)[b * 32 + lane] =
      make_float4((float)(base + c0), (float)(base + c1), (float)(base + c2),
                  (float)(base + c3));
  int third = kNone;  // at most one lane of the tile holds the third 1
  if (v.x > 0.0f && base + c0 == 3) third = 4 * lane;
  else if (v.y > 0.0f && base + c1 == 3) third = 4 * lane + 1;
  else if (v.z > 0.0f && base + c2 == 3) third = 4 * lane + 2;
  else if (v.w > 0.0f && base + c3 == 3) third = 4 * lane + 3;
  third = __reduce_min_sync(0xffffffffu, third);
  if (lane == 0) static_cast<int*>(a.out0)[b] = third;
}

// 11: the row x[0, :64] written as a column (64, 1): piece i copies float4
// i % 16 of tile i / 16's row (a tile's column is 64 contiguous floats).
__device__ void transpose(const Args& a, long long i) {
  reinterpret_cast<float4*>(a.out0)[i] = __ldg(tile4(a.in0, i / 16) + i % 16);
}

// The probes above over `tiles` tiles: every warp strides over the tiles
// (transpose: every thread over the pieces).
__global__ void __launch_bounds__(kThreads) probe_tiles_kernel(int which, Args a, int tiles) {
  if (which == 11) {
    const long long pieces = (long long)tiles * (kTransposed / 4);
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < pieces;
         i += (long long)gridDim.x * kThreads)
      transpose(a, i);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); b < tiles;
       b += (long long)gridDim.x * kWarps) {
    if (which == 6) group32_sum(a, b, lane);
    else if (which == 8) reduce_while(a, b, lane);
    else cumsum_first(a, b, lane);
  }
}

// The floor of a launch: chip_smoke.py and bench/time_probes.py time it.
__global__ void empty_kernel() {}

// SMs of the current device and blocks of kThreads an SM holds at once of
// probe_kernel (per_sm) and of dot_argmin_kernel (dot_per_sm), the
// occupancy calculator's counts, cached per device.
cudaError_t device_fill(int* sms, int* per_sm, int* dot_per_sm) {
  static int cached[64][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev][0] > 0) {
    *sms = cached[dev][0];
    *per_sm = cached[dev][1];
    *dot_per_sm = cached[dev][2];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, probe_kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dot_per_sm, dot_argmin_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) *per_sm = 1;
  if (*dot_per_sm < 1) *dot_per_sm = 1;
  if (dev < 64) {
    cached[dev][0] = *sms;
    cached[dev][1] = *per_sm;
    cached[dev][2] = *dot_per_sm;
  }
  return cudaSuccess;
}

}  // namespace

// Launch probe `which` over `tiles` tiles on `stream`: group32_sum,
// reduce_while, cumsum_first and transpose as probe_tiles_kernel (at most
// kTileBlocksPerSm blocks of 256 threads an SM), dot_argmin as
// dot_argmin_kernel (at most kArgWaves times its resident blocks) and the
// others as probe_kernel, in a persistent grid of the blocks the card holds
// at once (device_fill), or fewer where the units need fewer.  Returns the
// CUDA error code of the launch (0 = ok), or -1 for an unknown probe.
// Inputs must lie in the ranges the wrapper checks, and every pointer must
// be 16-byte aligned.
extern "C" int probe_mosaic_launch(int which, const void* in0, const void* in1, void* out0,
                                   void* out1, int tiles, void* stream) {
  if (which < 0 || which > 14) return -1;
  const Args args{in0, in1, out0, out1};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (which == 6 || which == 8 || which == 10 || which == 11) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long threads = (long long)tiles * (which == 11 ? kTransposed / 4 : 32);
    const long long blocks = (threads + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * kTileBlocksPerSm;
    probe_tiles_kernel<<<(int)(blocks < cap ? blocks : cap), kThreads, 0, s>>>(which, args,
                                                                               tiles);
  } else {
    int sms = 0, per_sm = 0, dot_per_sm = 0;
    err = device_fill(&sms, &per_sm, &dot_per_sm);
    if (err != cudaSuccess) return (int)err;
    if (which == 3) {
      const long long cap = (long long)sms * dot_per_sm * kArgWaves;
      dot_argmin_kernel<<<(int)(tiles < cap ? tiles : cap), kThreads, 0, s>>>(args, tiles);
      return (int)cudaGetLastError();
    }
    // a persistent grid of kThreads blocks where the units fill the card;
    // fewer units spread over every SM in blocks of fewer whole warps
    const long long units = probe_units(which, tiles);
    const long long per = (units + sms - 1) / sms;
    const int threads = per >= kThreads ? kThreads : per <= 32 ? 32 : (int)((per + 31) / 32 * 32);
    const long long blocks = (units + threads - 1) / threads;
    const long long grid = (long long)sms * per_sm;
    probe_kernel<<<(int)(blocks < grid ? blocks : grid), threads, 0, s>>>(which, args, units);
  }
  return (int)cudaGetLastError();
}

// Launch the empty kernel (one block of 32 threads) on `stream`; returns
// the CUDA error code of the launch.
extern "C" int probe_mosaic_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
