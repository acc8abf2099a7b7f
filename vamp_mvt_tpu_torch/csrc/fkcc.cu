// Fused forward kinematics + collision check for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::_run
// (its body _make_kernel -> tile_vmin: the primitive, self-collision,
// attachment, pointcloud and heightfield branches).  For every configuration
// q of every problem it computes
//
//   vmin = min( min over robot spheres x live shape rows of the signed value,
//               min over the self-collision pair table of d^2 - (ri + rj)^2,
//               the attachment, heightfield and pointcloud branches, where
//               the problem has them )
//
// and writes valid = (vmin >= 0) as int8, plus vmin itself when asked, and
// the pointcloud work per problem (spheres gated, chunk bounds tested,
// points evaluated) when asked.
//
// Design.  One thread per configuration; the grid is (blocks of
// configurations) x (problems).  Each block copies its problem's shape rows
// into shared memory and counts the live prefix of every table (rows with
// |x0| < 1e7, the _live_counts rule), then loops over that prefix only.
// The robot arrives as small device tables built from its RobotSpec (frame
// chain, sphere placement, pair table, per-sphere pointcloud class), so one
// compiled library serves every robot.  FK walks the frames in order,
// keeping the previous frame's pose in registers; only frames that are the
// parent of a non-adjacent frame are kept in shared memory.  As soon as a
// sphere centre is known it is checked against the environment from
// registers and stored in shared memory (SoA, one float per thread per
// coordinate, conflict-free) for the pair loop and the pointcloud branch.
// The pointcloud (about 86 KB of bitmap and 100 KB of chunks and points a
// Panda problem) and a heightfield's heights (250 KB for a 250 x 250 grid)
// stay in global memory, read through the read-only path: a configuration
// reads one height per sphere and field.
//
// What bounds it.  A Panda configuration reads 7 floats (28 bytes) and
// writes 1 byte, but costs some 30k FP32 operations (59 spheres x the live
// shapes, plus 690 pairs), and with a pointcloud 15 more a sphere for the
// gate and 12 a chunk bound and 10 a point for the spheres the gate cannot
// decide; a payload sphere costs what a robot sphere does plus 12 a checked
// robot sphere, and a heightfield 20 a sphere and a gathered height.  So the
// kernel is bound by FP32 arithmetic on the CUDA cores, not by memory (a
// terrain's heights are read once per problem from device memory, the
// gathers of one problem's blocks hit L2).  The design keeps every operand of the inner loops on chip or
// in L1/L2: shape rows are warp-uniform shared-memory broadcasts, sphere
// centres stay in registers or shared memory, and a problem's chunks are
// read by all of its blocks.
//
// Numerics: see fkcc_device.cuh, which holds the FK + collision code that
// this kernel and both megakernels share.

#include <cuda_runtime.h>

#include "fkcc_device.cuh"

namespace {

__global__ void fkcc_kernel(fkcc::EnvTables et, const float* __restrict__ q,
                            long long q_sb, long long q_sd, long long q_sn, int N,
                            fkcc::Robot robot, signed char* __restrict__ out_valid,
                            float* __restrict__ out_vmin, long long* __restrict__ out_work) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const fkcc::Env env = fkcc::load_env(et, b, smem);
  float* s_pose = smem + fkcc::env_floats(et);

  const long long n = (long long)blockIdx.x * T + tid;
  if (n >= N) return;  // no barrier below this point
  fkcc::Work w{0, 0, 0};
  const float vmin = fkcc::config_vmin(env, robot, s_pose, T, tid,
                                       q + b * q_sb + n * q_sn, q_sd, w);
  const long long o = (long long)b * N + n;
  out_valid[o] = vmin >= 0.0f ? 1 : 0;
  if (out_vmin != nullptr) out_vmin[o] = vmin;
  if (out_work != nullptr && w.gates > 0) {
    unsigned long long* ow = reinterpret_cast<unsigned long long*>(out_work + (long long)b * 3);
    atomicAdd(ow + 0, (unsigned long long)w.gates);
    atomicAdd(ow + 1, (unsigned long long)w.chunks);
    atomicAdd(ow + 2, (unsigned long long)w.points);
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code of the launch (0 = ok), or
// -1 when no block of 128, 64 or 32 threads fits in max_smem bytes of shared
// memory (the largest that fits runs).  out_vmin and out_work (B x 3, zeroed
// by the caller) may be null.
extern "C" int fkcc_launch(
    const float* sph, const float* cap, const float* zcap, const float* cub,
    const float* zcub, int ns, int nc, int nzc, int nb, int nzb, int env_batched,
    const int* bitmap, const float* chunks, const float* points, const float* pc_meta,
    int rrows, int nch, int pc_batched, const float* att, const float* att_pc, int A,
    int att_batched, const float* hf_meta, const float* hf_data, int nh, int hf_cells,
    int hf_batched,
    const float* q, long long q_sb, long long q_sd, long long q_sn, int B, int N,
    const int* frame_i, const float* frame_f, int F, int n_slots,
    const int* sphere_order, const float* sphere_f, int S, const int* pairs,
    const float* pair_thr, int P, const float* sphere_pc, int ee_frame, const int* att_check,
    int n_att_check, signed char* out_valid,
    float* out_vmin, long long* out_work, int max_smem, void* stream) {
  const fkcc::EnvTables et{sph, cap, zcap, cub, zcub, ns, nc, nzc, nb, nzb, env_batched,
                           bitmap, chunks, points, pc_meta, rrows, nch, pc_batched,
                           att, att_pc, A, att_batched, hf_meta, hf_data, nh, hf_cells,
                           hf_batched};
  const fkcc::Robot robot{frame_i, frame_f, F, n_slots, sphere_order, sphere_f, S,
                          pairs, pair_thr, P, sphere_pc, ee_frame, att_check, n_att_check};
  int threads = 0, smem_bytes = 0;
  const int cands[] = {128, 64, 32};
  for (int cand : cands) {
    const int need = (fkcc::env_floats(et) + fkcc::scratch_floats(robot, et, cand)) * 4;
    if (need <= max_smem) {
      threads = cand;
      smem_bytes = need;
      break;
    }
  }
  if (threads == 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      fkcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch's check does not see it
    return (int)err;
  }
  const dim3 grid((unsigned)((N + threads - 1) / threads), (unsigned)B);
  fkcc_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      et, q, q_sb, q_sd, q_sn, N, robot, out_valid, out_vmin, out_work);
  return (int)cudaGetLastError();
}
