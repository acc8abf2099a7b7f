// Fused forward kinematics + collision check of one configuration, as device
// functions shared by every kernel of the port (fkcc.cu, rrtc_mega.cu,
// simplify_mega.cu).  Counterpart of the TPU function
// vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::tile_vmin: its primitive,
// self-collision, end-effector attachment, pointcloud (pc_phase 2) and
// heightfield branches.
//
// A block first copies its problem's shape rows, heightfield meta rows and
// payload rows into shared memory and counts the live prefix of every shape
// table (rows with |x0| < 1e7, the _live_counts rule): load_env(), and the
// robot tables: load_robot().  Then G lanes of a warp (a group) evaluate
// one configuration at a time with config_vmin_group<G>(), which returns
//
//   vmin = min( min over robot spheres x live shape rows of the signed value,
//               min over the self-collision pair table of d^2 - (ri + rj)^2,
//               the attachment, heightfield and pointcloud branches below,
//               where the problem has them )
//
// and the configuration is valid iff vmin >= 0.  The robot arrives as small
// device tables built from its RobotSpec (frame chain, sphere placement, pair
// table).  FK walks the frames in order and stores every frame's pose and
// every sphere centre in the group's scratch (group_floats) for the pair
// loop and the branches below.
//
// Numerics.  Built with --fmad=false and without --use_fast_math, using
// cosf/sinf, with every sum taken in the index order of ops/smat.dot_terms
// and collision/primitives.py, so its rounding follows the plain PyTorch
// version and validity can differ only inside the contact band.
//
// Attachment (ops/fkcc.py::attachment_vmin), when the problem carries A
// payload spheres: as FK reaches the robot's EE frame, each payload row (its
// centre in the EE frame, tf_rot @ xyz + tf_pos, composed on the host) is
// posed as R_ee @ c + t_ee, checked against the live shape rows like a
// robot sphere, and stored after the S robot spheres' centres; after the
// pair table each payload sphere is checked against the robot's
// attachment-check spheres.  The heightfield and pointcloud branches then
// run over all S + A spheres.
//
// Heightfield (collision/primitives.py::sphere_heightfield), for every
// sphere and field: the cell under the centre, floor(clip(xs * (x0 - x) +
// xd2, 0, xd)) and likewise in y, gives the flat index cy * xd + cx, clipped
// to [0, C - 1] with C the table's padded width (the JAX package's XLA rule,
// not its Pallas kernel's 128-wide rows), and vmin takes z - r - (zs * h +
// z0).  The heights stay in global memory, one read through the read-only
// path per sphere and field.
//
// Pointcloud (collision/pc_kernel.py), after the heightfields, for each
// sphere of a configuration whose vmin is still >= 0: the voxel of its centre
// selects one word of its radius class in the certain-hit and the
// certain-free halves of the bitmap; a certain-hit bit (where the sphere
// table allows it, chit_ok) decides the configuration at once (vmin = -1);
// a centre outside the grid, a set certain-free bit or a sphere without a
// sound gate (gate_ok = 0, an oversized payload) takes the exact scan: every
// live chunk whose bounding sphere lies within thr + chunk radius (+ 1e-4
// against rounding) of the centre has its 32 points checked as d^2 - thr^2,
// thr = r + r_point.  A payload sphere's table row comes with the problem
// (pc_kernel.attachment_table).  The branch is sign-exact, not value-exact
// (every consumer thresholds vmin at 0), and stops the moment vmin < 0.
// The bitmap, chunks and points stay in global memory, read through the
// read-only path.
//
// Why a group: every kernel (fkcc.cu and both megakernels) checks a
// configuration with G lanes and one FK scratch a group, because a scratch
// a thread, (n_slots * 12 + (S + A) * 3) floats, takes 90,624 bytes of
// sphere centres alone for the Panda at 128 threads and leaves an SM one or
// two blocks of 4 warps.
//
// What bounds it.  FP32 arithmetic (some 18k-30k operations a Panda
// configuration) and the shared-memory loads that feed it (rows, poses,
// centres).  The group reads each environment row once for 4 spheres, pads
// each group's scratch so that the lanes of a warp meet 32 distinct banks
// on the pair table's centre reads, and runs FK by rows (3 lanes of a
// group).

#pragma once

#include <cuda_runtime.h>

namespace fkcc {

constexpr int kRevolute = 1;
constexpr int kPrismatic = 2;
constexpr float kLiveLimit = 1.0e7f;
// frame_f row: origin_rot(9) origin_xyz(3) axis(3) A(9) I-A(9) K(9)
constexpr int kFrameFloats = 42;
// frame_i row: parent, joint_type, q_index, slot, sphere_begin, sphere_end
constexpr int kFrameInts = 6;
// pointcloud layout (collision/pc_kernel.py): radius classes per bitmap
// half, points per chunk; a chunk row is x[32] y[32] z[32]
constexpr int kMaxClasses = 12;
constexpr int kChunkPoints = 32;
constexpr float kChunkMargin = 1.0e-4f;

// The robot's device tables (ops/kernels/fkcc_cuda.py::robot_tables).
struct Robot {
  const int* frame_i;
  const float* frame_f;
  int F;
  int n_slots;
  const int* sphere_order;
  const float* sphere_f;
  int S;
  const int* pairs;
  const float* pair_thr;
  int P;
  const float* sphere_pc;  // S x (radius, class, chit_ok, gate_ok)
  int ee_frame;            // the frame that carries an attachment
  const int* att_check;    // robot spheres a payload is checked against
  int n_att_check;
};

// One problem's shape tables: global pointers of the whole batch and their
// row counts (env_batched = 0: one environment shared by every problem),
// its pointcloud tables (bitmap == nullptr: no pointcloud; pc_batched
// = 0: one cloud shared by every problem), its payload spheres (A = 0: no
// attachment) and its heightfields (nh = 0: none), each with its own
// batched flag.
struct EnvTables {
  const float* sph;
  const float* cap;
  const float* zcap;
  const float* cub;
  const float* zcub;
  int ns, nc, nzc, nb, nzb;
  int env_batched;
  const int* bitmap;    // (2 * kMaxClasses * rrows, 128) int32 a problem
  const float* chunks;  // (nch, 8): bound centre xyz, radius, pad
  const float* points;  // (nch, 3 * kChunkPoints)
  const float* pc_meta; // (8,): ws xyz, 1 / cell, W, r_point, live chunks, pad
  int rrows, nch, pc_batched;
  const float* att;     // (A, 4) a problem: payload centre in the EE frame, radius
  const float* att_pc;  // (A, 4) a problem: radius, class, chit_ok, gate_ok
  int A, att_batched;
  const float* hf_meta; // (nh, 10) a problem: x, y, z, 1/sx, 1/sy, 1/sz, xd, yd, xd2, yd2
  const float* hf_data; // (nh, hf_cells) a problem: heights, row-major
  int nh, hf_cells, hf_batched;
};

// The block's copy of its problem's shape rows, and their live counts; its
// pointcloud's global pointers and meta; its payload rows and heightfield
// meta rows (shared memory) and heights (global).
struct Env {
  const float* sph;
  const float* cap;
  const float* zcap;
  const float* cub;
  const float* zcub;
  int ls, lc, lzc, lb, lzb;
  const int* bm;
  const float4* ch;
  const float* pt;
  float wsx, wsy, wsz, inv, Wf, pr;
  int W, nlive, plane;
  const float* att;
  const float* att_pc;
  int A;
  const float* hfm;
  const float* hfd;
  int nh, C;
};

// Pointcloud work of one thread: spheres gated, chunk bounds tested, points
// evaluated.
struct Work {
  long long gates, chunks, points;
};

__device__ __forceinline__ float sq(float x) { return x * x; }

// Floats of shared memory the shape rows, heightfield meta rows and payload
// rows take.
__host__ __device__ inline int env_floats(const EnvTables& e) {
  return e.ns * 4 + (e.nc + e.nzc) * 8 + (e.nb + e.nzb) * 15 + e.nh * 10 + e.A * 8;
}

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

// Copy problem b's shape rows to `smem` (env_floats(e) floats) and count
// their live prefixes.  Every thread of the block must call it.
__device__ inline Env load_env(const EnvTables& e, int b, float* smem) {
  const long long be = e.env_batched ? b : 0;
  Env env;
  float* s_sph = smem;
  float* s_cap = s_sph + e.ns * 4;
  float* s_zcap = s_cap + e.nc * 8;
  float* s_cub = s_zcap + e.nzc * 8;
  float* s_zcub = s_cub + e.nb * 15;
  float* s_hfm = s_zcub + e.nzb * 15;
  float* s_att = s_hfm + e.nh * 10;
  float* s_attpc = s_att + e.A * 4;
  const long long bh = e.hf_batched ? b : 0;
  const long long ba = e.att_batched ? b : 0;
  load_rows(s_hfm, e.hf_meta + bh * e.nh * 10, e.nh * 10);
  load_rows(s_att, e.att + ba * e.A * 4, e.A * 4);
  load_rows(s_attpc, e.att_pc + ba * e.A * 4, e.A * 4);
  load_rows(s_sph, e.sph + be * e.ns * 4, e.ns * 4);
  load_rows(s_cap, e.cap + be * e.nc * 8, e.nc * 8);
  load_rows(s_zcap, e.zcap + be * e.nzc * 8, e.nzc * 8);
  load_rows(s_cub, e.cub + be * e.nb * 15, e.nb * 15);
  load_rows(s_zcub, e.zcub + be * e.nzb * 15, e.nzb * 15);
  __syncthreads();
  env.sph = s_sph;
  env.cap = s_cap;
  env.zcap = s_zcap;
  env.cub = s_cub;
  env.zcub = s_zcub;
  env.ls = live_count(s_sph, e.ns, 4);
  env.lc = live_count(s_cap, e.nc, 8);
  env.lzc = live_count(s_zcap, e.nzc, 8);
  env.lb = live_count(s_cub, e.nb, 15);
  env.lzb = live_count(s_zcub, e.nzb, 15);
  env.att = s_att;
  env.att_pc = s_attpc;
  env.A = e.A;
  env.hfm = s_hfm;
  env.hfd = e.hf_data + bh * e.nh * e.hf_cells;
  env.nh = e.nh;
  env.C = e.hf_cells;
  env.bm = nullptr;
  if (e.bitmap != nullptr) {
    const long long bp = e.pc_batched ? b : 0;
    const float* m = e.pc_meta + bp * 8;
    env.bm = e.bitmap + bp * 2 * kMaxClasses * e.rrows * 128;
    env.ch = reinterpret_cast<const float4*>(e.chunks + bp * e.nch * 8);
    env.pt = e.points + bp * e.nch * 3 * kChunkPoints;
    env.wsx = __ldg(m + 0);
    env.wsy = __ldg(m + 1);
    env.wsz = __ldg(m + 2);
    env.inv = __ldg(m + 3);
    env.Wf = __ldg(m + 4);
    env.pr = __ldg(m + 5);
    env.W = (int)env.Wf;
    env.nlive = min((int)__ldg(m + 6), e.nch);
    env.plane = e.rrows * 128;
  }
  return env;
}

// ---------------------------------------------------------------------------
// The lane-group check (fkcc.cu, rrtc_mega.cu, simplify_mega.cu).
//
// G lanes of one warp (a group; G a power of two, 1..32, fixed at compile
// time) check one configuration together, so the FK scratch is paid per
// group, not per thread: the group's configuration, the cosine and sine of
// each joint, every frame's pose and every sphere centre, group_floats()
// floats.  The robot tables sit in shared memory too (load_robot).  Within a
// group:
//   - each lane takes the cos/sin of joints j = gl, gl + G, ...;
//   - FK runs by rows: row i of a frame's rotation and translation depends
//     only on row i of its parent's, so lane gl walks the whole chain for
//     rows i = gl, gl + G, ... < 3 (at G >= 4 lanes 3.. idle through FK) and
//     stores them in the group's pose table;
//   - sphere poses with their environment rows, the self-collision pairs,
//     the payload checks and the heightfield loop are split by index across
//     the lanes, and vmin is the min over the group (__shfl_xor_sync);
//   - the pointcloud branch gates the spheres G at a time, then scans each
//     undecided sphere's live chunks split across the lanes, and stops for
//     the whole group as soon as one lane holds vmin < 0 (sign-exact).
// Every value is computed by the same expression, in the same order, as in
// the plain version (ops/fkcc.py, collision/primitives.py), and a min is
// exact in any order, so vmin does not depend on G (on a pointcloud, its
// sign does not).
// ---------------------------------------------------------------------------

// vmin over the live shape rows of U spheres (centres px, py, pz, radii
// rad), from `vmin`: collision/primitives.py's expressions, each row read
// once for all U (U independent chains of mins).
template <int U>
__device__ __forceinline__ float prim_vmin_n(const Env& env, const float* px, const float* py,
                                             const float* pz, const float* rad, float vmin) {
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = vmin;
  for (int m = 0; m < env.ls; ++m) {
    const float* o = env.sph + m * 4;
    const float o0 = o[0], o1 = o[1], o2 = o[2], o3 = o[3];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float d2 = sq(px[u] - o0) + sq(py[u] - o1) + sq(pz[u] - o2);
      const float rs = rad[u] + o3;
      v[u] = fminf(v[u], d2 - rs * rs);
    }
  }
  for (int m = 0; m < env.lc; ++m) {
    const float* o = env.cap + m * 8;
    const float o0 = o[0], o1 = o[1], o2 = o[2], o3 = o[3], o4 = o[4], o5 = o[5];
    const float o6 = o[6], o7 = o[7];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dot = (px[u] - o0) * o3 + (py[u] - o1) * o4 + (pz[u] - o2) * o5;
      const float t = fminf(fmaxf(dot * o7, 0.0f), 1.0f);
      const float d2 = sq(px[u] - (o0 + o3 * t)) + sq(py[u] - (o1 + o4 * t)) +
                       sq(pz[u] - (o2 + o5 * t));
      const float rs = rad[u] + o6;
      v[u] = fminf(v[u], d2 - rs * rs);
    }
  }
  for (int m = 0; m < env.lzc; ++m) {
    const float* o = env.zcap + m * 8;
    const float o0 = o[0], o1 = o[1], o2 = o[2], o5 = o[5], o6 = o[6], o7 = o[7];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float t = fminf(fmaxf((pz[u] - o2) * o5 * o7, 0.0f), 1.0f);
      const float d2 = sq(px[u] - o0) + sq(py[u] - o1) + sq(pz[u] - (o2 + o5 * t));
      const float rs = rad[u] + o6;
      v[u] = fminf(v[u], d2 - rs * rs);
    }
  }
  for (int m = 0; m < env.lb; ++m) {
    const float* o = env.cub + m * 15;
    float c[15];
#pragma unroll
    for (int e = 0; e < 15; ++e) c[e] = o[e];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float xs = px[u] - c[0], ys = py[u] - c[1], zs = pz[u] - c[2];
      const float a1 = fmaxf(fabsf(c[3] * xs + c[4] * ys + c[5] * zs) - c[12], 0.0f);
      const float a2 = fmaxf(fabsf(c[6] * xs + c[7] * ys + c[8] * zs) - c[13], 0.0f);
      const float a3 = fmaxf(fabsf(c[9] * xs + c[10] * ys + c[11] * zs) - c[14], 0.0f);
      v[u] = fminf(v[u], a1 * a1 + a2 * a2 + a3 * a3 - rad[u] * rad[u]);
    }
  }
  for (int m = 0; m < env.lzb; ++m) {
    const float* o = env.zcub + m * 15;
    const float o0 = o[0], o1 = o[1], o2 = o[2], o3 = o[3], o4 = o[4], o6 = o[6], o7 = o[7];
    const float o12 = o[12], o13 = o[13], o14 = o[14];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float xs = px[u] - o0, ys = py[u] - o1, zs = pz[u] - o2;
      const float a1 = fmaxf(fabsf(o3 * xs + o4 * ys) - o12, 0.0f);
      const float a2 = fmaxf(fabsf(o6 * xs + o7 * ys) - o13, 0.0f);
      const float a3 = fmaxf(fabsf(zs) - o14, 0.0f);
      v[u] = fminf(v[u], a1 * a1 + a2 * a2 + a3 * a3 - rad[u] * rad[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) vmin = fminf(vmin, v[u]);
  return vmin;
}

// The robot tables in shared memory, plus each sphere's frame.
struct GroupRobot {
  Robot r;
  const int* kframe;  // S: the frame that carries sphere k
};

// Floats of shared memory the robot tables take (load_robot).
__host__ __device__ inline int robot_floats(const Robot& r) {
  return r.F * (kFrameInts + kFrameFloats) + r.S * 9 + r.P * 3 + r.n_att_check;
}

// Floats of one group's scratch: its configuration, the cos and sin of each
// joint (3 d), every frame's pose (12 F: rotation row-major, translation)
// and every robot and payload sphere centre (3 (S + A)), padded to 3 G
// modulo 32.  Group g then starts 3 G g banks after group 0, so when the
// lanes of a group read consecutive centres of their own copies (the pair
// table runs through consecutive j for one i), lane l of the warp meets
// bank 3 l: no two lanes of a warp collide.
__host__ __device__ inline int group_floats(const Robot& r, const EnvTables& e, int d, int G) {
  const int n = 3 * d + 12 * r.F + 3 * (r.S + e.A);
  return n + ((3 * G - n) % 32 + 32) % 32;
}

template <typename V>
__device__ __forceinline__ void load_vals(V* dst, const V* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Copy the robot tables to `smem` (robot_floats(r) floats) and build each
// sphere's frame.  Every thread of the block must call it.
__device__ inline GroupRobot load_robot(const Robot& r, float* smem) {
  int* s_fi = reinterpret_cast<int*>(smem);
  float* s_ff = smem + r.F * kFrameInts;
  float* s_sf = s_ff + r.F * kFrameFloats;
  float* s_spc = s_sf + r.S * 4;
  int* s_kf = reinterpret_cast<int*>(s_spc + r.S * 4);
  int* s_pairs = s_kf + r.S;
  float* s_thr = reinterpret_cast<float*>(s_pairs + 2 * r.P);
  int* s_att = reinterpret_cast<int*>(s_thr + r.P);
  load_vals(s_fi, r.frame_i, r.F * kFrameInts);
  load_vals(s_ff, r.frame_f, r.F * kFrameFloats);
  load_vals(s_sf, r.sphere_f, r.S * 4);
  load_vals(s_spc, r.sphere_pc, r.S * 4);
  load_vals(s_pairs, r.pairs, 2 * r.P);
  load_vals(s_thr, r.pair_thr, r.P);
  load_vals(s_att, r.att_check, r.n_att_check);
  for (int f = threadIdx.x; f < r.F; f += blockDim.x) {
    const int* fi = r.frame_i + f * kFrameInts;
    for (int idx = fi[4]; idx < fi[5]; ++idx) s_kf[r.sphere_order[idx]] = f;
  }
  __syncthreads();
  GroupRobot g;
  g.r = r;
  g.r.frame_i = s_fi;
  g.r.frame_f = s_ff;
  g.r.sphere_f = s_sf;
  g.r.sphere_pc = s_spc;
  g.r.pairs = s_pairs;
  g.r.pair_thr = s_thr;
  g.r.att_check = s_att;
  g.kframe = s_kf;
  return g;
}

// Spheres and pairs a lane takes at a time in config_vmin_group.
constexpr int kUnroll = 4;

// The lanes of the calling thread's group.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

template <int G>
__device__ __forceinline__ float group_min(float v, unsigned gmask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(gmask, v, o));
  return v;
}

// The pointcloud branch for the group's S + A centres `ctr` (3 floats a
// sphere), from the group's vmin >= 0; returns the group's new vmin.
template <int G>
__device__ inline float pc_vmin_group(const Env& env, const GroupRobot& gr, const float* ctr,
                                      int gl, unsigned gmask, float vmin, Work& w) {
  const Robot& r = gr.r;
  const int SA = r.S + env.A;
  const unsigned low = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  for (int k0 = 0; k0 < SA; k0 += G) {
    // the gate of sphere k0 + gl
    const int k = k0 + gl;
    bool maybe = false, hit = false;
    if (k < SA) {
      const float cx = ctr[k * 3 + 0], cy = ctr[k * 3 + 1], cz = ctr[k * 3 + 2];
      const float* sp = k < r.S ? r.sphere_pc + 4 * k : env.att_pc + 4 * (k - r.S);
      const int cls = (int)sp[1];
      const bool chit_ok = sp[2] > 0.0f;
      const bool gate_ok = sp[3] > 0.0f;
      ++w.gates;
      const float fx = floorf((cx - env.wsx) * env.inv);
      const float fy = floorf((cy - env.wsy) * env.inv);
      const float fz = floorf((cz - env.wsz) * env.inv);
      const bool ing = fx >= 0.0f && fx < env.Wf && fy >= 0.0f && fy < env.Wf &&
                       fz >= 0.0f && fz < env.Wf;
      maybe = !ing || !gate_ok;
      if (ing) {
        const int widx = (int)fx * env.W + (int)fy;
        const unsigned zs = (unsigned)(int)fz;
        const unsigned hw = (unsigned)__ldg(env.bm + (kMaxClasses + cls) * env.plane + widx);
        hit = chit_ok && ((hw >> zs) & 1u);
        const unsigned free_word = (unsigned)__ldg(env.bm + cls * env.plane + widx);
        maybe = maybe || ((free_word >> zs) & 1u);
      }
    }
    if (__any_sync(gmask, hit)) return fminf(vmin, -1.0f);
    // the exact scan of each undecided sphere, its chunks split across lanes
    unsigned want = (__ballot_sync(gmask, maybe && !hit) >> gbase) & low;
    while (want) {
      const int kk = k0 + __ffs(want) - 1;
      want &= want - 1;
      const float cx = ctr[kk * 3 + 0], cy = ctr[kk * 3 + 1], cz = ctr[kk * 3 + 2];
      const float rk = kk < r.S ? r.sphere_pc[4 * kk] : env.att_pc[4 * (kk - r.S)];
      const float thr = rk + env.pr;
      const float thr2 = thr * thr;
      for (int c0 = 0; c0 < env.nlive; c0 += G) {
        const int c = c0 + gl;
        if (c < env.nlive) {
          const float4 bnd = __ldg(env.ch + 2 * c);
          ++w.chunks;
          const float m = thr + bnd.w + kChunkMargin;
          if (!(sq(cx - bnd.x) + sq(cy - bnd.y) + sq(cz - bnd.z) > m * m)) {
            const float* p = env.pt + (long long)c * 3 * kChunkPoints;
            w.points += kChunkPoints;
            for (int s = 0; s < kChunkPoints; ++s) {
              const float d2 = sq(cx - __ldg(p + s)) + sq(cy - __ldg(p + kChunkPoints + s)) +
                               sq(cz - __ldg(p + 2 * kChunkPoints + s));
              vmin = fminf(vmin, d2 - thr2);
            }
          }
        }
        if (__any_sync(gmask, vmin < 0.0f)) return group_min<G>(vmin, gmask);
      }
    }
  }
  return group_min<G>(vmin, gmask);
}

// vmin of the configuration in the group's scratch `gs` (group_floats(r,
// e, d, G) floats, the configuration first), checked by the G lanes of the
// calling thread's group (gl its lane in the group, gmask the group's lanes);
// every lane of the group must call it and gets the group's vmin.  The
// caller writes the configuration before the call.  Pointcloud work goes to
// `w`.  No block barrier inside.
template <int G>
__device__ inline float config_vmin_group(const Env& env, const GroupRobot& gr, float* gs,
                                          int d, int gl, unsigned gmask, Work& w) {
  const Robot& r = gr.r;
  const float* q = gs;
  float* cs = gs + d;
  float* sn = gs + 2 * d;
  float* pose = gs + 3 * d;        // F x 12
  float* ctr = pose + 12 * r.F;    // (S + A) x 3
  __syncwarp(gmask);
  for (int j = gl; j < d; j += G) {
    cs[j] = cosf(q[j]);
    sn[j] = sinf(q[j]);
  }
  __syncwarp(gmask);

  // FK by rows: this lane's rows i = gl + G m < 3 of every frame.
  constexpr int kRows = G >= 3 ? 1 : (G == 2 ? 2 : 3);
  int row[kRows];
  bool own[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    own[m] = gl + G * m < 3;
    row[m] = own[m] ? gl + G * m : 2;
  }
  float R[kRows][3], t[kRows];
  for (int f = 0; f < r.F; ++f) {
    const int* fi = r.frame_i + f * kFrameInts;
    const float* ff = r.frame_f + f * kFrameFloats;
    const int parent = fi[0];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int i = row[m];
      if (parent < 0) {
        for (int j = 0; j < 3; ++j) R[m][j] = ff[i * 3 + j];
        t[m] = ff[9 + i];
      } else {
        float Rp[3], tp;
        if (parent == f - 1) {
          for (int j = 0; j < 3; ++j) Rp[j] = R[m][j];
          tp = t[m];
        } else {
          const float* src = pose + parent * 12;
          for (int j = 0; j < 3; ++j) Rp[j] = src[i * 3 + j];
          tp = src[9 + i];
        }
        // R = Rp @ origin_rot;  t = Rp @ origin_xyz + tp
        for (int j = 0; j < 3; ++j) {
          float acc = Rp[0] * ff[0 * 3 + j];
          acc = acc + Rp[1] * ff[1 * 3 + j];
          acc = acc + Rp[2] * ff[2 * 3 + j];
          R[m][j] = acc;
        }
        float acc = Rp[0] * ff[9];
        acc = acc + Rp[1] * ff[10];
        acc = acc + Rp[2] * ff[11];
        t[m] = acc + tp;
      }
    }
    const int jt = fi[1];
    if (jt == kRevolute) {
      const float c = cs[fi[2]];
      const float s = sn[fi[2]];
      float Q[9];
      for (int e = 0; e < 9; ++e) Q[e] = (ff[15 + e] + ff[24 + e] * c) + ff[33 + e] * s;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        float Rn[3];
        for (int j = 0; j < 3; ++j) {
          float acc = R[m][0] * Q[0 * 3 + j];
          acc = acc + R[m][1] * Q[1 * 3 + j];
          acc = acc + R[m][2] * Q[2 * 3 + j];
          Rn[j] = acc;
        }
        for (int j = 0; j < 3; ++j) R[m][j] = Rn[j];
      }
    } else if (jt == kPrismatic) {
      const float x = q[fi[2]];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        float acc = R[m][0] * ff[12];
        acc = acc + R[m][1] * ff[13];
        acc = acc + R[m][2] * ff[14];
        t[m] = t[m] + x * acc;
      }
    }
    float* dst = pose + f * 12;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (!own[m]) continue;
      const int i = row[m];
      for (int j = 0; j < 3; ++j) dst[i * 3 + j] = R[m][j];
      dst[9 + i] = t[m];
    }
  }
  __syncwarp(gmask);

  // Robot and payload sphere centres, split across the lanes kUnroll at a
  // time (a lane's spheres k0 + G u): pose, store, environment rows.  A slot
  // past the last sphere repeats sphere k0, which leaves the min as it is.
  float vmin = __int_as_float(0x7f800000);  // +inf
  const int SA = r.S + env.A;
  for (int k0 = gl; k0 < SA; k0 += G * kUnroll) {
    float px[kUnroll], py[kUnroll], pz[kUnroll], rad[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + G * u < SA ? k0 + G * u : k0;
      const bool robot_sphere = k < r.S;
      const float* loc = robot_sphere ? r.sphere_f + k * 4 : env.att + (k - r.S) * 4;
      const float* P = pose + (robot_sphere ? gr.kframe[k] : r.ee_frame) * 12;
      float p[3];
      for (int i = 0; i < 3; ++i) {
        float acc = P[i * 3 + 0] * loc[0];
        acc = acc + P[i * 3 + 1] * loc[1];
        acc = acc + P[i * 3 + 2] * loc[2];
        p[i] = acc + P[9 + i];
      }
      ctr[k * 3 + 0] = p[0];
      ctr[k * 3 + 1] = p[1];
      ctr[k * 3 + 2] = p[2];
      px[u] = p[0];
      py[u] = p[1];
      pz[u] = p[2];
      rad[u] = loc[3];
    }
    vmin = prim_vmin_n<kUnroll>(env, px, py, pz, rad, vmin);
  }
  __syncwarp(gmask);

  // Self-collision pair table, kUnroll pairs a lane at a time (a slot past
  // the last pair repeats pair m0).
  for (int m0 = gl; m0 < r.P; m0 += G * kUnroll) {
    int pi[kUnroll], pj[kUnroll];
    float thr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int m = m0 + G * u < r.P ? m0 + G * u : m0;
      pi[u] = r.pairs[2 * m];
      pj[u] = r.pairs[2 * m + 1];
      thr[u] = r.pair_thr[m];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = pi[u], j = pj[u];
      const float dx = ctr[i * 3 + 0] - ctr[j * 3 + 0];
      const float dy = ctr[i * 3 + 1] - ctr[j * 3 + 1];
      const float dz = ctr[i * 3 + 2] - ctr[j * 3 + 2];
      vmin = fminf(vmin, dx * dx + dy * dy + dz * dz - thr[u]);
    }
  }

  // Payload spheres against the robot's attachment-check spheres.
  const int nac = r.n_att_check;
  for (int idx = gl; idx < env.A * nac; idx += G) {
    const int a = idx / nac;
    const int k = r.att_check[idx - a * nac];
    const int ka = r.S + a;
    const float dx = ctr[ka * 3 + 0] - ctr[k * 3 + 0];
    const float dy = ctr[ka * 3 + 1] - ctr[k * 3 + 1];
    const float dz = ctr[ka * 3 + 2] - ctr[k * 3 + 2];
    const float rs = env.att[a * 4 + 3] + r.sphere_f[k * 4 + 3];
    vmin = fminf(vmin, dx * dx + dy * dy + dz * dz - rs * rs);
  }

  // Heightfields.
  if (env.nh > 0) {
    for (int k = gl; k < SA; k += G) {
      const float cx = ctr[k * 3 + 0];
      const float cy = ctr[k * 3 + 1];
      const float cz = ctr[k * 3 + 2];
      const float rk = k < r.S ? r.sphere_f[k * 4 + 3] : env.att[(k - r.S) * 4 + 3];
      for (int n = 0; n < env.nh; ++n) {
        const float* m = env.hfm + n * 10;
        const float xo = m[0] - cx;
        const float yo = m[1] - cy;
        const float ccx = floorf(fminf(fmaxf(m[3] * xo + m[8], 0.0f), m[6]));
        const float ccy = floorf(fminf(fmaxf(m[4] * yo + m[9], 0.0f), m[7]));
        const int idx = min(max((int)(ccy * m[6] + ccx), 0), env.C - 1);
        const float zh = __ldg(env.hfd + (long long)n * env.C + idx);
        vmin = fminf(vmin, cz - rk - (m[5] * zh + m[2]));
      }
    }
  }
  vmin = group_min<G>(vmin, gmask);
  if (env.bm != nullptr && vmin >= 0.0f) vmin = pc_vmin_group<G>(env, gr, ctr, gl, gmask, vmin, w);
  return vmin;
}

}  // namespace fkcc
