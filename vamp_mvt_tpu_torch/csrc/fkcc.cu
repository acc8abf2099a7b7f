// Fused forward kinematics + collision check for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::_run
// (its body _make_kernel -> tile_vmin, primitive and self-collision
// branches).  For every configuration q of every problem it computes
//
//   vmin = min( min over robot spheres x live shape rows of the signed value,
//               min over the self-collision pair table of d^2 - (ri + rj)^2 )
//
// and writes valid = (vmin >= 0) as int8, plus vmin itself when asked.
//
// Design.  One thread per configuration; the grid is (blocks of
// configurations) x (problems).  Each block copies its problem's shape rows
// into shared memory and counts the live prefix of every table (rows with
// |x0| < 1e7, the _live_counts rule), then loops over that prefix only.
// The robot arrives as small device tables built from its RobotSpec (frame
// chain, sphere placement, pair table), so one compiled library serves every
// robot.  FK walks the frames in order, keeping the previous frame's pose in
// registers; only frames that are the parent of a non-adjacent frame are
// kept in shared memory.  As soon as a sphere centre is known it is checked
// against the environment from registers and stored in shared memory (SoA,
// one float per thread per coordinate, conflict-free) for the pair loop.
//
// What bounds it.  A Panda configuration reads 7 floats (28 bytes) and
// writes 1 byte, but costs some 30k FP32 operations (59 spheres x the live
// shapes, plus 690 pairs), so the kernel is bound by FP32 arithmetic on the
// CUDA cores, not by memory.  The design keeps every operand of the inner
// loops on chip: shape rows are warp-uniform shared-memory broadcasts and
// sphere centres stay in registers or shared memory.
//
// Numerics.  Built with --fmad=false and without --use_fast_math, using
// cosf/sinf, with every sum taken in the index order of ops/smat.dot_terms
// and collision/primitives.py, so its rounding follows the plain PyTorch
// version and validity can differ only inside the contact band.

#include <cuda_runtime.h>

namespace {

constexpr int kRevolute = 1;
constexpr int kPrismatic = 2;
constexpr float kLiveLimit = 1.0e7f;
// frame_f row: origin_rot(9) origin_xyz(3) axis(3) A(9) I-A(9) K(9)
constexpr int kFrameFloats = 42;
// frame_i row: parent, joint_type, q_index, slot, sphere_begin, sphere_end
constexpr int kFrameInts = 6;

__device__ __forceinline__ float sq(float x) { return x * x; }

__device__ __forceinline__ void load_rows(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Number of rows with |x0| < 1e7.  Every thread of the block must call it.
__device__ __forceinline__ int live_count(const float* rows, int n, int f) {
  int c = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int r = base + threadIdx.x;
    c += __syncthreads_count(r < n && fabsf(rows[r * f]) < kLiveLimit);
  }
  return c;
}

__global__ void fkcc_kernel(
    const float* __restrict__ sph, const float* __restrict__ cap,
    const float* __restrict__ zcap, const float* __restrict__ cub,
    const float* __restrict__ zcub, int ns, int nc, int nzc, int nb, int nzb,
    int env_batched, const float* __restrict__ q, long long q_sb,
    long long q_sd, long long q_sn, int N, const int* __restrict__ frame_i,
    const float* __restrict__ frame_f, int F, int n_slots,
    const int* __restrict__ sphere_order, const float* __restrict__ sphere_f,
    int S, const int* __restrict__ pairs, const float* __restrict__ pair_thr,
    int P, signed char* __restrict__ out_valid, float* __restrict__ out_vmin) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const long long be = env_batched ? b : 0;

  float* s_sph = smem;
  float* s_cap = s_sph + ns * 4;
  float* s_zcap = s_cap + nc * 8;
  float* s_cub = s_zcap + nzc * 8;
  float* s_zcub = s_cub + nb * 15;
  float* s_pose = s_zcub + nzb * 15;    // n_slots x 12 x T
  float* s_ctr = s_pose + n_slots * 12 * T;  // S x 3 x T

  load_rows(s_sph, sph + be * ns * 4, ns * 4);
  load_rows(s_cap, cap + be * nc * 8, nc * 8);
  load_rows(s_zcap, zcap + be * nzc * 8, nzc * 8);
  load_rows(s_cub, cub + be * nb * 15, nb * 15);
  load_rows(s_zcub, zcub + be * nzb * 15, nzb * 15);
  __syncthreads();
  const int ls = live_count(s_sph, ns, 4);
  const int lc = live_count(s_cap, nc, 8);
  const int lzc = live_count(s_zcap, nzc, 8);
  const int lb = live_count(s_cub, nb, 15);
  const int lzb = live_count(s_zcub, nzb, 15);

  const long long n = (long long)blockIdx.x * T + tid;
  if (n >= N) return;  // no barrier below this point
  const float* qp = q + b * q_sb + n * q_sn;

  float vmin = __int_as_float(0x7f800000);  // +inf
  float R[9], t[3];
  for (int f = 0; f < F; ++f) {
    const int* fi = frame_i + f * kFrameInts;
    const float* ff = frame_f + f * kFrameFloats;
    const int parent = fi[0];
    if (parent < 0) {
      for (int e = 0; e < 9; ++e) R[e] = ff[e];
      for (int e = 0; e < 3; ++e) t[e] = ff[9 + e];
    } else {
      float Rp[9], tp[3];
      if (parent == f - 1) {
        for (int e = 0; e < 9; ++e) Rp[e] = R[e];
        for (int e = 0; e < 3; ++e) tp[e] = t[e];
      } else {
        const float* src = s_pose + frame_i[parent * kFrameInts + 3] * 12 * T + tid;
        for (int e = 0; e < 9; ++e) Rp[e] = src[e * T];
        for (int e = 0; e < 3; ++e) tp[e] = src[(9 + e) * T];
      }
      // R = Rp @ origin_rot;  t = Rp @ origin_xyz + tp
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          float acc = Rp[i * 3 + 0] * ff[0 * 3 + j];
          acc = acc + Rp[i * 3 + 1] * ff[1 * 3 + j];
          acc = acc + Rp[i * 3 + 2] * ff[2 * 3 + j];
          R[i * 3 + j] = acc;
        }
        float acc = Rp[i * 3 + 0] * ff[9];
        acc = acc + Rp[i * 3 + 1] * ff[10];
        acc = acc + Rp[i * 3 + 2] * ff[11];
        t[i] = acc + tp[i];
      }
    }
    const int jt = fi[1];
    if (jt == kRevolute) {
      const float x = qp[fi[2] * q_sd];
      const float c = cosf(x);
      const float s = sinf(x);
      float Q[9];
      for (int e = 0; e < 9; ++e) Q[e] = (ff[15 + e] + ff[24 + e] * c) + ff[33 + e] * s;
      float Rn[9];
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          float acc = R[i * 3 + 0] * Q[0 * 3 + j];
          acc = acc + R[i * 3 + 1] * Q[1 * 3 + j];
          acc = acc + R[i * 3 + 2] * Q[2 * 3 + j];
          Rn[i * 3 + j] = acc;
        }
      }
      for (int e = 0; e < 9; ++e) R[e] = Rn[e];
    } else if (jt == kPrismatic) {
      const float x = qp[fi[2] * q_sd];
      for (int i = 0; i < 3; ++i) {
        float acc = R[i * 3 + 0] * ff[12];
        acc = acc + R[i * 3 + 1] * ff[13];
        acc = acc + R[i * 3 + 2] * ff[14];
        t[i] = t[i] + x * acc;
      }
    }
    if (fi[3] >= 0) {
      float* dst = s_pose + fi[3] * 12 * T + tid;
      for (int e = 0; e < 9; ++e) dst[e * T] = R[e];
      for (int e = 0; e < 3; ++e) dst[(9 + e) * T] = t[e];
    }

    // Spheres carried by this frame: centre, environment checks, store.
    for (int idx = fi[4]; idx < fi[5]; ++idx) {
      const int k = sphere_order[idx];
      const float* sf = sphere_f + k * 4;
      float p[3];
      for (int i = 0; i < 3; ++i) {
        float acc = R[i * 3 + 0] * sf[0];
        acc = acc + R[i * 3 + 1] * sf[1];
        acc = acc + R[i * 3 + 2] * sf[2];
        p[i] = acc + t[i];
      }
      const float px = p[0], py = p[1], pz = p[2], r = sf[3];
      s_ctr[(k * 3 + 0) * T + tid] = px;
      s_ctr[(k * 3 + 1) * T + tid] = py;
      s_ctr[(k * 3 + 2) * T + tid] = pz;

      for (int m = 0; m < ls; ++m) {
        const float* o = s_sph + m * 4;
        const float d2 = sq(px - o[0]) + sq(py - o[1]) + sq(pz - o[2]);
        const float rs = r + o[3];
        vmin = fminf(vmin, d2 - rs * rs);
      }
      for (int m = 0; m < lc; ++m) {
        const float* o = s_cap + m * 8;
        const float dot = (px - o[0]) * o[3] + (py - o[1]) * o[4] + (pz - o[2]) * o[5];
        const float u = fminf(fmaxf(dot * o[7], 0.0f), 1.0f);
        const float d2 = sq(px - (o[0] + o[3] * u)) + sq(py - (o[1] + o[4] * u)) +
                         sq(pz - (o[2] + o[5] * u));
        const float rs = r + o[6];
        vmin = fminf(vmin, d2 - rs * rs);
      }
      for (int m = 0; m < lzc; ++m) {
        const float* o = s_zcap + m * 8;
        const float u = fminf(fmaxf((pz - o[2]) * o[5] * o[7], 0.0f), 1.0f);
        const float d2 = sq(px - o[0]) + sq(py - o[1]) + sq(pz - (o[2] + o[5] * u));
        const float rs = r + o[6];
        vmin = fminf(vmin, d2 - rs * rs);
      }
      for (int m = 0; m < lb; ++m) {
        const float* o = s_cub + m * 15;
        const float xs = px - o[0], ys = py - o[1], zs = pz - o[2];
        const float a1 = fmaxf(fabsf(o[3] * xs + o[4] * ys + o[5] * zs) - o[12], 0.0f);
        const float a2 = fmaxf(fabsf(o[6] * xs + o[7] * ys + o[8] * zs) - o[13], 0.0f);
        const float a3 = fmaxf(fabsf(o[9] * xs + o[10] * ys + o[11] * zs) - o[14], 0.0f);
        vmin = fminf(vmin, a1 * a1 + a2 * a2 + a3 * a3 - r * r);
      }
      for (int m = 0; m < lzb; ++m) {
        const float* o = s_zcub + m * 15;
        const float xs = px - o[0], ys = py - o[1], zs = pz - o[2];
        const float a1 = fmaxf(fabsf(o[3] * xs + o[4] * ys) - o[12], 0.0f);
        const float a2 = fmaxf(fabsf(o[6] * xs + o[7] * ys) - o[13], 0.0f);
        const float a3 = fmaxf(fabsf(zs) - o[14], 0.0f);
        vmin = fminf(vmin, a1 * a1 + a2 * a2 + a3 * a3 - r * r);
      }
    }
  }

  // Self-collision pair table.
  for (int m = 0; m < P; ++m) {
    const int i = pairs[2 * m], j = pairs[2 * m + 1];
    const float dx = s_ctr[(i * 3 + 0) * T + tid] - s_ctr[(j * 3 + 0) * T + tid];
    const float dy = s_ctr[(i * 3 + 1) * T + tid] - s_ctr[(j * 3 + 1) * T + tid];
    const float dz = s_ctr[(i * 3 + 2) * T + tid] - s_ctr[(j * 3 + 2) * T + tid];
    vmin = fminf(vmin, dx * dx + dy * dy + dz * dz - pair_thr[m]);
  }

  const long long o = (long long)b * N + n;
  out_valid[o] = vmin >= 0.0f ? 1 : 0;
  if (out_vmin != nullptr) out_vmin[o] = vmin;
}

}  // namespace

// Launch on `stream`; returns the CUDA error code of the launch (0 = ok).
extern "C" int fkcc_launch(
    const float* sph, const float* cap, const float* zcap, const float* cub,
    const float* zcub, int ns, int nc, int nzc, int nb, int nzb, int env_batched,
    const float* q, long long q_sb, long long q_sd, long long q_sn, int B, int N,
    const int* frame_i, const float* frame_f, int F, int n_slots,
    const int* sphere_order, const float* sphere_f, int S, const int* pairs,
    const float* pair_thr, int P, signed char* out_valid, float* out_vmin,
    int threads, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fkcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + threads - 1) / threads), (unsigned)B);
  fkcc_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      sph, cap, zcap, cub, zcub, ns, nc, nzc, nb, nzb, env_batched, q, q_sb,
      q_sd, q_sn, N, frame_i, frame_f, F, n_slots, sphere_order, sphere_f, S,
      pairs, pair_thr, P, out_valid, out_vmin);
  return (int)cudaGetLastError();
}
