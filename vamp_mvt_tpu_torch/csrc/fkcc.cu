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
// Design.  G lanes of a warp check one configuration together
// (fkcc_device.cuh::config_vmin_group<G>, one template instance for each G
// in 1, 2, 4, 8, 16, 32), so the FK scratch (the configuration, every
// frame's pose, every sphere centre) is paid once a group, not once a
// thread.  The grid is (blocks of T / G configurations) x (problems); each
// block copies its problem's shape rows into shared memory and counts their
// live prefixes (load_env), and copies the robot tables there (load_robot),
// once for all its groups.  The launch shape (T threads, G lanes) comes from
// the wrapper (ops/kernels/fkcc_cuda.py::fkcc_shape), sized to the launch's
// B x N: a launch of a few configurations spreads each over up to 32 lanes
// (the FK chain, the spheres and the pairs split across them), a launch of
// 700 x 1024 keeps more configurations resident.  The pointcloud (about 86
// KB of bitmap and 100 KB of chunks and points a Panda problem) and a
// heightfield's heights (250 KB for a 250 x 250 grid) stay in global memory,
// read through the read-only path.
//
// What bounds it.  A Panda configuration reads 7 floats (28 bytes) and
// writes 1 byte, but costs some 30k FP32 operations (59 spheres x the live
// shapes, plus 690 pairs), and with a pointcloud 15 more a sphere for the
// gate and 12 a chunk bound and 10 a point for the spheres the gate cannot
// decide; a payload sphere costs what a robot sphere does plus 12 a checked
// robot sphere, and a heightfield 20 a sphere and a gathered height.  So the
// kernel is bound by FP32 arithmetic on the CUDA cores and the shared-memory
// loads that feed it, not by device memory.  On a large launch the design
// answers that with occupancy (one scratch a group lets an SM hold 16 warps
// and more, where one scratch a thread held 4 to 8) and by reading each
// shape row once for 4 spheres; on a small one (the API's and the roadmap
// planners' one-problem steps, the bench path's 700 x 2 validity) with
// latency: a configuration's spheres and pairs split over G lanes, and
// every block busy.
//
// Numerics: see fkcc_device.cuh, which holds the FK + collision code that
// this kernel and both megakernels share.

#include <cuda_runtime.h>

#include <cstdint>

#include "fkcc_device.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <int G>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fkcc_kernel(fkcc::EnvTables et, const float* __restrict__ q, long long q_sb,
                long long q_sd, long long q_sn, int N, int d, fkcc::Robot robot,
                signed char* __restrict__ out_valid, float* __restrict__ out_vmin,
                long long* __restrict__ out_work) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int env_f = fkcc::env_floats(et);
  const fkcc::Env env = fkcc::load_env(et, b, smem);
  const fkcc::GroupRobot gr = fkcc::load_robot(robot, smem + env_f);
  const int grp = threadIdx.x / G, gl = threadIdx.x & (G - 1);
  float* gs = smem + env_f + fkcc::robot_floats(robot) +
              grp * fkcc::group_floats(robot, et, d, G);
  const long long n = (long long)blockIdx.x * (blockDim.x / G) + grp;
  if (n >= N) return;  // a whole group; no barrier below this point
  fkcc::Work w{0, 0, 0};
  const float* qp = q + b * q_sb + n * q_sn;
  for (int j = gl; j < d; j += G) gs[j] = qp[j * q_sd];
  const float vmin = fkcc::config_vmin_group<G>(env, gr, gs, d, gl, fkcc::group_mask<G>(), w);
  const long long o = (long long)b * N + n;
  if (gl == 0) {
    out_valid[o] = vmin >= 0.0f ? 1 : 0;
    if (out_vmin != nullptr) out_vmin[o] = vmin;
  }
  if (out_work != nullptr && w.gates > 0) {
    unsigned long long* ow = reinterpret_cast<unsigned long long*>(out_work + (long long)b * 3);
    atomicAdd(ow + 0, (unsigned long long)w.gates);
    atomicAdd(ow + 1, (unsigned long long)w.chunks);
    atomicAdd(ow + 2, (unsigned long long)w.points);
  }
}

using Kernel = void (*)(fkcc::EnvTables, const float*, long long, long long, long long, int,
                        int, fkcc::Robot, signed char*, float*, long long*);

Kernel kernel_for(int G) {
  switch (G) {
    case 1: return fkcc_kernel<1>;
    case 2: return fkcc_kernel<2>;
    case 4: return fkcc_kernel<4>;
    case 8: return fkcc_kernel<8>;
    case 16: return fkcc_kernel<16>;
    case 32: return fkcc_kernel<32>;
    default: return nullptr;
  }
}

int g_index(int G) { return __builtin_ctz((unsigned)G); }

// per G: the dynamic shared memory the kernel was last allowed, its registers
int g_smem_set[6] = {0, 0, 0, 0, 0, 0};
int g_regs[6] = {-1, -1, -1, -1, -1, -1};

template <typename T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}

}  // namespace

// Launch B x N configurations in blocks of T threads, G lanes a
// configuration, on a stream.  `tab` holds the table arguments as 64-bit
// integers (pointers, counts and flags, 0 for a null pointer) in the order
// of fkcc_cuda.ENV_ARGTYPES then ROBOT_ARGTYPES; `call` holds q, its
// strides (problem, joint, configuration), B, N, d, the outputs (validity;
// vmin and the pointcloud work, B x 3 zeroed by the caller, may be null), T,
// G, the shared memory a block may take and the stream.  Returns the CUDA
// error code of the launch (0 = ok), or -1 when the shape is not one the
// kernel runs (T a multiple of 32 up to kMaxThreads, G a power of two up to
// 32 and at most T) or its shared memory does not fit.  launch_info
// receives the dynamic shared memory in bytes, the blocks the card keeps
// resident on one SM and the kernel's registers a thread.
extern "C" int fkcc_launch(const long long* tab, const long long* call, int* launch_info) {
  const fkcc::EnvTables et{
      ptr<const float>(tab[0]), ptr<const float>(tab[1]), ptr<const float>(tab[2]),
      ptr<const float>(tab[3]), ptr<const float>(tab[4]), (int)tab[5], (int)tab[6],
      (int)tab[7], (int)tab[8], (int)tab[9], (int)tab[10],
      ptr<const int>(tab[11]), ptr<const float>(tab[12]), ptr<const float>(tab[13]),
      ptr<const float>(tab[14]), (int)tab[15], (int)tab[16], (int)tab[17],
      ptr<const float>(tab[18]), ptr<const float>(tab[19]), (int)tab[20], (int)tab[21],
      ptr<const float>(tab[22]), ptr<const float>(tab[23]), (int)tab[24], (int)tab[25],
      (int)tab[26]};
  const long long* rt = tab + 27;
  const fkcc::Robot robot{
      ptr<const int>(rt[0]), ptr<const float>(rt[1]), (int)rt[2], (int)rt[3],
      ptr<const int>(rt[4]), ptr<const float>(rt[5]), (int)rt[6],
      ptr<const int>(rt[7]), ptr<const float>(rt[8]), (int)rt[9], ptr<const float>(rt[10]),
      (int)rt[11], ptr<const int>(rt[12]), (int)rt[13]};
  const float* q = ptr<const float>(call[0]);
  const long long q_sb = call[1], q_sd = call[2], q_sn = call[3];
  const int B = (int)call[4], N = (int)call[5], d = (int)call[6];
  signed char* out_valid = ptr<signed char>(call[7]);
  float* out_vmin = ptr<float>(call[8]);
  long long* out_work = ptr<long long>(call[9]);
  const int T = (int)call[10], G = (int)call[11], max_smem = (int)call[12];
  const cudaStream_t stream = ptr<CUstream_st>(call[13]);
  const Kernel kernel = kernel_for(G);
  if (kernel == nullptr || T % 32 != 0 || T < 32 || T > kMaxThreads || G > T) return -1;
  const int per_block = T / G;
  const int bytes = (fkcc::env_floats(et) + fkcc::robot_floats(robot) +
                     per_block * fkcc::group_floats(robot, et, d, G)) * 4;
  if (bytes > max_smem) return -1;
  const int gi = g_index(G);
  cudaError_t err = cudaSuccess;
  if (bytes > g_smem_set[gi]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) g_smem_set[gi] = bytes;
  }
  if (err == cudaSuccess && g_regs[gi] < 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) g_regs[gi] = attr.numRegs;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&launch_info[1], kernel, T, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch's check does not see it
    return (int)err;
  }
  launch_info[0] = bytes;
  launch_info[2] = g_regs[gi];
  const dim3 grid((unsigned)((N + per_block - 1) / per_block), (unsigned)B);
  kernel<<<grid, T, bytes, stream>>>(et, q, q_sb, q_sd, q_sn, N, d, robot, out_valid, out_vmin,
                                     out_work);
  return (int)cudaGetLastError();
}
