// Path-simplification megakernel for NVIDIA Hopper (sm_90a): the
// SHORTCUT + BSPLINE driver of one path per block.
//
// Replaces the TPU kernel vamp_mvt_tpu/planning/simplify_mega.py::_run (its
// body _make_kernel).  The grid is one block per problem, with the path in
// shared memory.  It mirrors the plain version,
// vamp_mvt_tpu_torch/planning/simplify.py (simplify_batch with no pair or job
// cap binding), which the tests hold it against:
//
//   - the straight-line check of the path's endpoints;
//   - SHORTCUT (simplify.hh:115-141): for vertex i, the candidates j from the
//     last vertex down to i + 2 are checked in batches, the largest valid j
//     wins and the rows in between are erased;
//   - BSPLINE (simplify.hh:14-53): subdivide, pull every even vertex toward
//     the midpoint of its neighbours where both new segments are valid, then
//     check every half segment that no accepted pull re-validated and undo
//     the pass where one fails (the port's repair of the reference, which
//     takes those halves as valid unchecked);
//   - the driver loop, until nothing changes or max_iterations passes.
//
// A segment a -> b is valid iff its N = 8 * max(ceil(|b - a| * res / 8), 1)
// points a + (b - a) * k / N, k = 1..N, pass FK + collision
// (fkcc_device.cuh::config_vmin_group); a batch of segments is checked with
// one flat loop over all their points, T / G configurations at a time, G
// lanes of a warp each.
//
// What bounds it.  FK + collision of the checked points, some 18k-30k FP32
// operations per Panda configuration (plus the pointcloud branch's work,
// which it counts: spheres gated, chunk bounds tested, points evaluated),
// fed by shared-memory loads; the SHORTCUT passes take about 80% of a
// block's cycles (the phase clocks).  The path (max_path x d floats) never
// leaves shared memory, a pointcloud and a heightfield's heights stay in
// global memory (an attachment adds 3 floats a group and payload sphere to
// the FK scratch).  One block per problem of T threads (512; launch_shape in
// ops/kernels/simplify_mega_cuda.py picks T and G): the FK scratch is one a
// group of G lanes (Panda: 128 groups of 4 lanes in 224,180 bytes), so 16
// warps work on one path where the per-thread design ran 4 (128 threads,
// 125,156 bytes).  The segment lists' offsets and the cut at the point
// budget are one warp's shuffle scan, the first valid shortcut and the
// BSPLINE lists' ranks are ballots, and the pass flags are
// __syncthreads_or, where thread 0 walked the lists before.
//
// Numerics.  --fmad=false and the plain version's order of every sum
// (validate.norm_last is left to right).

#include <cuda_runtime.h>

#include "fkcc_device.cuh"

namespace {

constexpr int kScalars = 2;
constexpr int kWork = 4;  // configurations, spheres gated, chunks tested, points
// Phase clocks (cycles of clock64() summed per block, read by thread 0 at
// the barriers around each FK + collision pass), exported after the work
// counters: the pass of the straight-line check, of SHORTCUT, of BSPLINE,
// and everything between passes.
enum Phase { kStraight, kShortcut, kBspline, kBookkeeping, kPhases };

struct SimpParams {
  int d, P, B, max_iters, bspline_steps, num_long;
  float mi, min_change, res8;
};

constexpr int kMaxThreads = 512;  // threads a block (the launcher's T)
// a batch of shortcut candidates holds at most this many rounds of the
// block's groups' points (at least one candidate)
constexpr int kShortcutRounds = 4;

// Shared-memory layout in floats (ints share the 4-byte slots): the
// problem's shape rows, the robot tables, T / G groups' FK scratch, the path
// and its copies, the segment lists (up to 2 * P segments: start (d), vector
// (d), n, offset, bad) and two ballot-word lists over the path's rows.
struct Layout {
  int env, robot, group, path, tmp, old, mid, sa, sv, sn, soff, sbad, keep, acc, words,
      words2, total;
  __host__ __device__ Layout(const SimpParams& p, const fkcc::EnvTables& et,
                             const fkcc::Robot& r, int T, int G) {
    const int d = p.d, S = 2 * p.P, W = (p.P + 31) / 32;
    int o = 0;
    env = o; o += fkcc::env_floats(et);
    robot = o; o += fkcc::robot_floats(r);
    group = o; o += fkcc::group_floats(r, et, d, G) * (T / G);
    path = o; o += p.P * d;
    tmp = o; o += p.P * d;
    old = o; o += p.P * d;
    mid = o; o += p.P * d;
    sa = o; o += S * d;
    sv = o; o += S * d;
    sn = o; o += S;
    soff = o; o += S + 1;
    sbad = o; o += S;
    keep = o; o += p.P;
    acc = o; o += p.P;
    words = o; o += W;
    words2 = o; o += W;
    total = o;
  }
};

struct Block {
  fkcc::Env env;
  fkcc::GroupRobot gr;
  SimpParams p;
  float* group;  // this thread's group's FK scratch
  int gl;        // its lane in the group
  unsigned gmask;
  float* sa;
  float* sv;
  float* sn;
  int* soff;
  int* sbad;
  int* nseg;  // shared: the segments the current pass checks
  long long configs;
  fkcc::Work pc;
  long long* ph;  // (kPhases + 1) in shared memory: cycles, then the last read
};

// Thread 0 charges the cycles since its last read to phase i.
__device__ __forceinline__ void tick(Block& k, int i) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    k.ph[i] += now - k.ph[kPhases];
    k.ph[kPhases] = now;
  }
}

// Stage segment e: start a, end bv (d floats each), point cap `cap`; its
// point count goes to soff[e + 1] (scan() turns counts into offsets).
__device__ __forceinline__ void stage(Block& k, int e, const float* a, const float* bv,
                                      int cap) {
  const int d = k.p.d;
  float* sa = k.sa + e * d;
  float* sv = k.sv + e * d;
  for (int j = 0; j < d; ++j) {
    sa[j] = a[j];
    sv[j] = bv[j] - a[j];
  }
  float acc = sv[0] * sv[0];
  for (int j = 1; j < d; ++j) acc = acc + sv[j] * sv[j];
  const float n = fmaxf(ceilf(sqrtf(acc) * k.p.res8), 1.0f);
  k.sn[e] = n;
  k.soff[e + 1] = min(8 * (int)n, cap);
}

// Warp 0 (every lane calls it): the counts of staged segments 0..n-1 in
// soff[1..n] become offsets (a shuffle scan, 32 segments at a time), and
// their bad flags are cleared.  Returns the number of segments whose points
// end within `budget` (every lane the same).
__device__ int scan(Block& k, int n, int budget) {
  const int lane = threadIdx.x & 31;
  int carry = 0, fit = 0;
  if (lane == 0) k.soff[0] = 0;
  for (int base = 0; base < n; base += 32) {
    const int e = base + lane;
    int v = e < n ? k.soff[e + 1] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += x;
    }
    v += carry;
    if (e < n) {
      k.soff[e + 1] = v;
      k.sbad[e] = 0;
    }
    fit += __popc(__ballot_sync(0xffffffffu, e < n && v <= budget));
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  return fit;
}

// Check the staged segments 0..n-1, or the leading ones whose points end
// within `budget` (at least one); sbad[e] = 1 where a point of segment e
// collides.  One configuration a group of G lanes.  Every thread must call
// it; returns the number of segments checked.
template <int G>
__device__ int check(Block& k, int n, int budget, int phase) {
  const int T = blockDim.x, tid = threadIdx.x, d = k.p.d;
  __syncthreads();
  tick(k, kBookkeeping);
  if (tid < 32) {
    const int fit = scan(k, n, budget);
    if (tid == 0) *k.nseg = max(fit, 1);
  }
  __syncthreads();
  n = *k.nseg;
  const int total = k.soff[n];
  for (int pt = tid / G; pt < total; pt += T / G) {
    int lo = 0, hi = n - 1;  // the segment e with soff[e] <= pt < soff[e + 1]
    while (lo < hi) {
      const int m = (lo + hi + 1) >> 1;
      if (k.soff[m] <= pt) lo = m;
      else hi = m - 1;
    }
    const int e = lo;
    const float frac = fminf((float)(pt - k.soff[e] + 1) / (8.0f * k.sn[e]), 1.0f);
    for (int j = k.gl; j < d; j += G) k.group[j] = k.sa[e * d + j] + k.sv[e * d + j] * frac;
    const float v = fkcc::config_vmin_group<G>(k.env, k.gr, k.group, d, k.gl, k.gmask, k.pc);
    if (k.gl == 0 && v < 0.0f) k.sbad[e] = 1;
  }
  k.configs += total;
  __syncthreads();
  tick(k, phase);
  return n;
}

// Rank of flagged row j among the flagged rows, from the rows' ballot words.
__device__ __forceinline__ int rank_of(const unsigned* words, int j) {
  int r = __popc(words[j >> 5] & ((1u << (j & 31)) - 1u));
  for (int w = 0; w < (j >> 5); ++w) r += __popc(words[w]);
  return r;
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads, 1)
simplify_mega_kernel(fkcc::EnvTables et, fkcc::Robot robot, SimpParams p,
                     const float* __restrict__ paths, const int* __restrict__ lengths,
                     float* __restrict__ out_path, int* __restrict__ out_scal,
                     long long* __restrict__ out_work) {
  extern __shared__ float smem[];
  __shared__ int s_n, s_changed, s_nseg;
  constexpr int kAll = 0x7fffffff;  // a budget that cuts no batch
  __shared__ unsigned long long s_work[kWork - 1];
  __shared__ long long s_ph[kPhases + 1];
  const int T = blockDim.x, tid = threadIdx.x, b = blockIdx.x, lane = tid & 31;
  const int d = p.d, P = p.P;
  const Layout L(p, et, robot, T, G);
  Block k;
  k.env = fkcc::load_env(et, b, smem + L.env);
  k.gr = fkcc::load_robot(robot, smem + L.robot);
  k.p = p;
  k.group = smem + L.group + (tid / G) * fkcc::group_floats(robot, et, d, G);
  k.gl = tid & (G - 1);
  k.gmask = fkcc::group_mask<G>();
  k.sa = smem + L.sa;
  k.sv = smem + L.sv;
  k.sn = smem + L.sn;
  k.soff = reinterpret_cast<int*>(smem + L.soff);
  k.sbad = reinterpret_cast<int*>(smem + L.sbad);
  k.nseg = &s_nseg;
  k.configs = 0;
  k.pc = fkcc::Work{0, 0, 0};
  if (tid < kWork - 1) s_work[tid] = 0;
  if (tid < kPhases) s_ph[tid] = 0;
  if (tid == 0) s_ph[kPhases] = clock64();
  k.ph = s_ph;
  float* path = smem + L.path;
  float* tmp = smem + L.tmp;
  float* old = smem + L.old;
  float* mid = smem + L.mid;
  int* keep = reinterpret_cast<int*>(smem + L.keep);
  int* acc = reinterpret_cast<int*>(smem + L.acc);
  unsigned* words = reinterpret_cast<unsigned*>(smem + L.words);
  unsigned* words2 = reinterpret_cast<unsigned*>(smem + L.words2);
  const int budget = kShortcutRounds * (T / G);

  for (int i = tid; i < P * d; i += T) path[i] = paths[(long long)b * P * d + i];
  const int n0 = lengths[b];
  __syncthreads();

  // --- straight-line check of the endpoints (simplify.py::_straight)
  bool straight = n0 <= 2;
  if (!straight) {
    if (tid == 0) stage(k, 0, path, path + (n0 - 1) * d, p.num_long);
    check<G>(k, 1, kAll, kStraight);
    straight = k.sbad[0] == 0;
  }
  int n = n0, iters = 0;
  if (straight) {
    // [first, last] (also for paths of fewer than 3 vertices)
    const int last = max(n0 - 1, 0);
    __syncthreads();
    for (int j = tid; j < d; j += T) tmp[j] = path[last * d + j];
    __syncthreads();
    for (int j = tid; j < d; j += T) path[d + j] = tmp[j];
    n = 2;
  } else {
    bool changed = true;
    while (changed && iters < p.max_iters) {
      // ------------------------------ SHORTCUT ------------------------------
      if (tid == 0) {
        s_n = n;
        s_changed = 0;
      }
      __syncthreads();
      for (int i = 0; i < s_n - 2; ++i) {
        // candidates j = s_n - 1 down to i + 2, a batch at a time; the
        // first valid one (every warp finds it by ballot) wins
        int j_hi = s_n - 1, best = -1;
        while (j_hi >= i + 2 && best < 0) {
          const int avail = j_hi - (i + 2) + 1;
          const int cnt = min(avail, 2 * P);
          for (int c = tid; c < cnt; c += T)
            stage(k, c, path + i * d, path + (j_hi - c) * d, 1 << 30);
          // the batch is cut at the point budget (keeping one at least)
          const int nseg = check<G>(k, cnt, budget, kShortcut);
          for (int base = 0; base < nseg && best < 0; base += 32) {
            const unsigned ok = __ballot_sync(0xffffffffu, base + lane < nseg &&
                                                           !k.sbad[base + lane]);
            if (ok) best = j_hi - (base + __ffs(ok) - 1);
          }
          j_hi -= nseg;
        }
        const int cur_n = s_n;
        if (best > i + 1) {
          // erase rows i+1 .. best-1: rows best.. move down to i+1..
          const int shift = best - (i + 1);
          const int moved = (cur_n - best) * d;
          for (int x = tid; x < moved; x += T) tmp[x] = path[best * d + x];
          __syncthreads();
          for (int x = tid; x < moved; x += T) path[(i + 1) * d + x] = tmp[x];
          if (tid == 0) {
            s_n = cur_n - shift;
            s_changed = 1;
          }
        }
        __syncthreads();
      }
      n = s_n;
      bool ch = s_changed != 0;

      // ------------------------------ BSPLINE -------------------------------
      for (int step = 0; step < p.bspline_steps; ++step) {
        if (!(2 * n - 1 <= P && n >= 3)) continue;
        const int old_n = n;
        for (int x = tid; x < n * d; x += T) old[x] = path[x];
        // subdivide: even rows keep the vertices, odd rows get midpoints
        const int n2 = 2 * n - 1;
        for (int x = tid; x < n2 * d; x += T) {
          const int row = x / d, j = x % d;
          const float a = path[(row / 2) * d + j];
          tmp[x] = row % 2 == 0 ? a : 0.5f * (a + path[(row / 2 + 1) * d + j]);
        }
        __syncthreads();
        for (int x = tid; x < n2 * d; x += T) path[x] = tmp[x];
        n = n2;
        __syncthreads();
        // midpoint pulls of the even rows 2 <= j < n - 1, and their ballot
        // words
        for (int base = 0; base < n; base += T) {
          const int j = base + tid;
          bool kj = false;
          if (j < n) {
            acc[j] = 0;
            if (j % 2 == 0 && j >= 2 && j < n - 1) {
              const float* prev = path + (j - 1) * d;
              const float* cur = path + j * d;
              const float* nxt = path + (j + 1) * d;
              float* m = mid + j * d;
              float dist = 0.0f;
              for (int c = 0; c < d; ++c) {
                const float t1 = cur[c] + (prev[c] - cur[c]) * p.mi;
                const float t2 = cur[c] + (nxt[c] - cur[c]) * p.mi;
                m[c] = t1 + (t2 - t1) * 0.5f;
                const float diff = cur[c] - m[c];
                dist = c == 0 ? diff * diff : dist + diff * diff;
              }
              kj = sqrtf(dist) > p.min_change;
            }
            keep[j] = kj;
          }
          const unsigned w = __ballot_sync(0xffffffffu, kj);
          if (lane == 0 && j < n) words[j >> 5] = w;
        }
        __syncthreads();
        // each kept pull stages its two segments at twice its rank
        int n_keep = 0;
        for (int w = 0; w < (n + 31) / 32; ++w) n_keep += __popc(words[w]);
        for (int j = tid; j < n; j += T) {
          if (!keep[j]) continue;
          const int c = 2 * rank_of(words, j);
          stage(k, c, path + (j - 1) * d, mid + j * d, 1 << 30);
          stage(k, c + 1, mid + j * d, path + (j + 1) * d, 1 << 30);
        }
        int nseg = 2 * n_keep;
        if (nseg > 0) check<G>(k, nseg, kAll, kBspline);
        bool mine = false;
        for (int j = tid; j < n; j += T) {
          if (!keep[j]) continue;
          const int c = 2 * rank_of(words, j);
          acc[j] = !k.sbad[c] && !k.sbad[c + 1];
          mine = mine || acc[j];
        }
        const bool any_acc = __syncthreads_or(mine) != 0;
        // accepted pulls move their rows; the halves no accepted pull
        // re-validated, (j, j + 1) with j < n - 1, get their ballot words
        for (int x = tid; x < n * d; x += T)
          if (acc[x / d]) path[x] = mid[x];
        for (int base = 0; base < n; base += T) {
          const int j = base + tid;
          const bool half = j + 1 < n && !acc[j] && !acc[j + 1];
          const unsigned w = __ballot_sync(0xffffffffu, half);
          if (lane == 0 && j < n) words2[j >> 5] = w;
        }
        __syncthreads();
        nseg = 0;
        for (int w = 0; w < (n + 31) / 32; ++w) nseg += __popc(words2[w]);
        for (int j = tid; j + 1 < n; j += T) {
          if ((words2[j >> 5] >> (j & 31)) & 1u)
            stage(k, rank_of(words2, j), path + j * d, path + (j + 1) * d, 1 << 30);
        }
        bool sound = true;
        if (nseg > 0) {
          check<G>(k, nseg, kAll, kBspline);
          bool bad = false;
          for (int c = tid; c < nseg; c += T) bad = bad || k.sbad[c];
          sound = __syncthreads_or(bad) == 0;
        }
        if (!sound) {
          for (int x = tid; x < old_n * d; x += T) path[x] = old[x];
          n = old_n;
        }
        ch = ch || (any_acc && sound);
        __syncthreads();
      }
      changed = ch;
      ++iters;
      __syncthreads();
    }
  }

  // --- output: rows past n repeat the last vertex
  __syncthreads();
  for (int x = tid; x < P * d; x += T) {
    const int row = min(x / d, n - 1);
    out_path[(long long)b * P * d + x] = path[row * d + x % d];
  }
  atomicAdd(&s_work[0], (unsigned long long)k.pc.gates);
  atomicAdd(&s_work[1], (unsigned long long)k.pc.chunks);
  atomicAdd(&s_work[2], (unsigned long long)k.pc.points);
  __syncthreads();
  tick(k, kBookkeeping);
  if (tid == 0) {
    out_scal[b * kScalars + 0] = n;
    out_scal[b * kScalars + 1] = straight ? 0 : iters;
    long long* w = out_work + (long long)b * (kWork + kPhases);
    w[0] = k.configs;
    for (int i = 0; i < kWork - 1; ++i) w[1 + i] = (long long)s_work[i];
    for (int i = 0; i < kPhases; ++i) w[kWork + i] = s_ph[i];
  }
}

using Kernel = void (*)(fkcc::EnvTables, fkcc::Robot, SimpParams, const float*, const int*,
                        float*, int*, long long*);

Kernel kernel_for(int G) {
  switch (G) {
    case 1: return simplify_mega_kernel<1>;
    case 2: return simplify_mega_kernel<2>;
    case 4: return simplify_mega_kernel<4>;
    case 8: return simplify_mega_kernel<8>;
    case 16: return simplify_mega_kernel<16>;
    case 32: return simplify_mega_kernel<32>;
    default: return nullptr;
  }
}

}  // namespace

// Launch one block of T threads per path, G lanes a configuration, on
// `stream`; returns the CUDA error code of the launch (0 = ok), or -1 when
// the shape is not one the kernel runs (T a multiple of 32 up to
// kMaxThreads, G a power of two up to 32) or its shared memory does not fit
// in max_smem bytes.  ip / fp: d, P, B, max_iters, bspline_steps, num_long /
// mi, min_change, res8.  launch_info receives the dynamic shared memory in
// bytes, the blocks the card keeps resident on one SM and the kernel's
// registers a thread.
extern "C" int simplify_mega_launch(
    const float* sph, const float* cap, const float* zcap, const float* cub,
    const float* zcub, int ns, int nc, int nzc, int nb, int nzb, int env_batched,
    const int* bitmap, const float* chunks, const float* points, const float* pc_meta,
    int rrows, int nch, int pc_batched, const float* att, const float* att_pc, int A,
    int att_batched, const float* hf_meta, const float* hf_data, int nh, int hf_cells,
    int hf_batched,
    const int* frame_i, const float* frame_f, int F, int n_slots,
    const int* sphere_order, const float* sphere_f, int S, const int* pairs,
    const float* pair_thr, int P, const float* sphere_pc, int ee_frame, const int* att_check,
    int n_att_check, const int* ip, const float* fp,
    const float* paths, const int* lengths, float* out_path, int* out_scal,
    long long* out_work, int T, int G, int max_smem, int* launch_info, void* stream) {
  const fkcc::EnvTables et{sph, cap, zcap, cub, zcub, ns, nc, nzc, nb, nzb, env_batched,
                           bitmap, chunks, points, pc_meta, rrows, nch, pc_batched,
                           att, att_pc, A, att_batched, hf_meta, hf_data, nh, hf_cells,
                           hf_batched};
  const fkcc::Robot robot{frame_i, frame_f, F, n_slots, sphere_order, sphere_f, S,
                          pairs, pair_thr, P, sphere_pc, ee_frame, att_check, n_att_check};
  SimpParams p{ip[0], ip[1], ip[2], ip[3], ip[4], ip[5], fp[0], fp[1], fp[2]};
  const Kernel kernel = kernel_for(G);
  if (kernel == nullptr || T % 32 != 0 || T < 32 || T > kMaxThreads) return -1;
  const int bytes = Layout(p, et, robot, T, G).total * 4;
  if (bytes > max_smem) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch's check does not see it
    return (int)err;
  }
  launch_info[0] = bytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&launch_info[1], kernel, T, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  launch_info[2] = attr.numRegs;
  kernel<<<p.B, T, bytes, (cudaStream_t)stream>>>(et, robot, p, paths, lengths, out_path,
                                                  out_scal, out_work);
  return (int)cudaGetLastError();
}
