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
// (fkcc_device.cuh); a batch of segments is checked with one flat loop over
// all their points, T threads at a time.
//
// What bounds it.  FK + collision of the checked points, some 18k-30k FP32
// operations per Panda configuration (plus the pointcloud branch's work,
// which it counts: spheres gated, chunk bounds tested, points evaluated);
// the path (max_path x d floats) never leaves shared memory, a pointcloud
// and a heightfield's heights stay in global memory (an attachment adds 3
// floats a thread and payload sphere to the FK scratch).  One block per problem, whose shared memory (125,156
// bytes for Panda at T = 128, mostly FK scratch) allows one block per SM.
//
// Numerics.  --fmad=false and the plain version's order of every sum
// (validate.norm_last is left to right).

#include <cuda_runtime.h>

#include "fkcc_device.cuh"

namespace {

constexpr int kScalars = 2;
constexpr int kWork = 4;  // configurations, spheres gated, chunks tested, points

struct SimpParams {
  int d, P, B, max_iters, bspline_steps, num_long;
  float mi, min_change, res8;
};

// Shared-memory layout in floats (ints share the 4-byte slots).  Segment
// lists hold up to 2 * P segments: start (d), vector (d), n, offset, bad.
struct Layout {
  int env, pose, q, path, tmp, old, mid, sa, sv, sn, soff, sbad, keep, acc, total;
  __host__ __device__ Layout(const SimpParams& p, const fkcc::EnvTables& et,
                             const fkcc::Robot& r, int T) {
    const int d = p.d, S = 2 * p.P;
    int o = 0;
    env = o; o += fkcc::env_floats(et);
    pose = o; o += fkcc::scratch_floats(r, et, T);
    q = o; o += d * T;
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
    total = o;
  }
};

struct Block {
  fkcc::Env env;
  fkcc::Robot robot;
  SimpParams p;
  float* pose;
  float* q;
  float* sa;
  float* sv;
  float* sn;
  int* soff;
  int* sbad;
  long long configs;
  fkcc::Work pc;
};

// Stage segment e: start a, end bv (d floats each), point cap `cap`.
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
  k.soff[e + 1] = min(8 * (int)n, cap);  // the count; offsets follow
}

// Check staged segments 0..n-1 (their counts in soff[1..n]); sbad[e] = 1
// where a point of segment e collides.  Every thread must call it.
__device__ void check(Block& k, int n) {
  const int T = blockDim.x, tid = threadIdx.x, d = k.p.d;
  __syncthreads();
  if (tid == 0) {
    k.soff[0] = 0;
    for (int e = 0; e < n; ++e) {
      k.soff[e + 1] += k.soff[e];
      k.sbad[e] = 0;
    }
  }
  __syncthreads();
  const int total = k.soff[n];
  for (int pt = tid; pt < total; pt += T) {
    int lo = 0, hi = n - 1;  // the segment e with soff[e] <= pt < soff[e + 1]
    while (lo < hi) {
      const int m = (lo + hi + 1) >> 1;
      if (k.soff[m] <= pt) lo = m;
      else hi = m - 1;
    }
    const int e = lo;
    const float frac = fminf((float)(pt - k.soff[e] + 1) / (8.0f * k.sn[e]), 1.0f);
    for (int j = 0; j < d; ++j) k.q[j * T + tid] = k.sa[e * d + j] + k.sv[e * d + j] * frac;
    if (fkcc::config_vmin(k.env, k.robot, k.pose, T, tid, k.q + tid, T, k.pc) < 0.0f) k.sbad[e] = 1;
  }
  k.configs += total;
  __syncthreads();
}

__global__ void simplify_mega_kernel(fkcc::EnvTables et, fkcc::Robot robot, SimpParams p,
                                     const float* __restrict__ paths,
                                     const int* __restrict__ lengths,
                                     float* __restrict__ out_path, int* __restrict__ out_scal,
                                     long long* __restrict__ out_work) {
  extern __shared__ float smem[];
  __shared__ int s_n, s_changed, s_best, s_nseg, s_flag;
  __shared__ unsigned long long s_work[kWork - 1];
  const int T = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  const int d = p.d, P = p.P;
  const Layout L(p, et, robot, T);
  Block k;
  k.env = fkcc::load_env(et, b, smem + L.env);
  k.robot = robot;
  k.p = p;
  k.pose = smem + L.pose;
  k.q = smem + L.q;
  k.sa = smem + L.sa;
  k.sv = smem + L.sv;
  k.sn = smem + L.sn;
  k.soff = reinterpret_cast<int*>(smem + L.soff);
  k.sbad = reinterpret_cast<int*>(smem + L.sbad);
  k.configs = 0;
  k.pc = fkcc::Work{0, 0, 0};
  if (tid < kWork - 1) s_work[tid] = 0;
  float* path = smem + L.path;
  float* tmp = smem + L.tmp;
  float* old = smem + L.old;
  float* mid = smem + L.mid;
  int* keep = reinterpret_cast<int*>(smem + L.keep);
  int* acc = reinterpret_cast<int*>(smem + L.acc);
  // a batch of shortcut candidates holds at most this many points
  const int budget = 4 * T;

  for (int i = tid; i < P * d; i += T) path[i] = paths[(long long)b * P * d + i];
  const int n0 = lengths[b];
  __syncthreads();

  // --- straight-line check of the endpoints (simplify.py::_straight)
  bool straight = n0 <= 2;
  if (!straight) {
    if (tid == 0) stage(k, 0, path, path + (n0 - 1) * d, p.num_long);
    check(k, 1);
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
        // candidates j = s_n - 1 down to i + 2, a batch at a time
        int j_hi = s_n - 1;
        if (tid == 0) s_best = -1;
        __syncthreads();
        while (j_hi >= i + 2 && s_best < 0) {
          const int avail = j_hi - (i + 2) + 1;
          const int cnt = min(avail, 2 * P);
          for (int c = tid; c < cnt; c += T)
            stage(k, c, path + i * d, path + (j_hi - c) * d, 1 << 30);
          __syncthreads();
          if (tid == 0) {  // cut the batch at the point budget (keep >= 1)
            int nseg = 1, pts = k.soff[1];
            while (nseg < cnt && pts + k.soff[nseg + 1] <= budget) pts += k.soff[++nseg];
            s_nseg = nseg;
          }
          __syncthreads();
          const int nseg = s_nseg;
          check(k, nseg);
          if (tid == 0) {
            for (int c = 0; c < nseg; ++c) {
              if (!k.sbad[c]) {
                s_best = j_hi - c;
                break;
              }
            }
          }
          j_hi -= nseg;
          __syncthreads();
        }
        const int best = s_best;
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
        // midpoint pulls of the even rows 2 <= j < n - 1
        for (int j = tid; j < n; j += T) {
          keep[j] = 0;
          acc[j] = 0;
          if (j % 2 != 0 || j < 2 || j >= n - 1) continue;
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
          keep[j] = sqrtf(dist) > p.min_change;
        }
        __syncthreads();
        if (tid == 0) {
          int c = 0;
          for (int j = 0; j < n; ++j) {
            if (!keep[j]) continue;
            stage(k, c++, path + (j - 1) * d, mid + j * d, 1 << 30);
            stage(k, c++, mid + j * d, path + (j + 1) * d, 1 << 30);
          }
          s_nseg = c;
        }
        __syncthreads();
        int nseg = s_nseg;
        if (nseg > 0) check(k, nseg);
        if (tid == 0) {
          int c = 0, any = 0;
          for (int j = 0; j < n; ++j) {
            if (!keep[j]) continue;
            acc[j] = !k.sbad[c] && !k.sbad[c + 1];
            any |= acc[j];
            c += 2;
          }
          s_flag = any;
        }
        __syncthreads();
        const bool any_acc = s_flag != 0;
        for (int x = tid; x < n * d; x += T)
          if (acc[x / d]) path[x] = mid[x];
        __syncthreads();
        // every half no accepted pull re-validated: (j, j + 1), j < n - 1
        if (tid == 0) {
          int c = 0;
          for (int j = 0; j + 1 < n; ++j) {
            if (acc[j] || acc[j + 1]) continue;
            stage(k, c++, path + j * d, path + (j + 1) * d, 1 << 30);
          }
          s_nseg = c;
        }
        __syncthreads();
        nseg = s_nseg;
        bool sound = true;
        if (nseg > 0) {
          check(k, nseg);
          if (tid == 0) {
            int bad = 0;
            for (int c = 0; c < nseg; ++c) bad |= k.sbad[c];
            s_flag = bad;
          }
          __syncthreads();
          sound = s_flag == 0;
          __syncthreads();
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
  if (tid == 0) {
    out_scal[b * kScalars + 0] = n;
    out_scal[b * kScalars + 1] = straight ? 0 : iters;
    out_work[(long long)b * kWork] = k.configs;
    for (int i = 0; i < kWork - 1; ++i) out_work[(long long)b * kWork + 1 + i] = (long long)s_work[i];
  }
}

}  // namespace

// Launch one block per path on `stream`; returns the CUDA error code of the
// launch (0 = ok), or -1 when no block of 128, 64 or 32 threads fits in
// max_smem bytes of shared memory (the largest that fits runs).  ip / fp:
// d, P, B, max_iters, bspline_steps, num_long / mi, min_change, res8.
// launch_info receives the threads, the dynamic shared memory in bytes and
// the blocks the card keeps resident on one SM.
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
    long long* out_work, int max_smem, int* launch_info, void* stream) {
  const fkcc::EnvTables et{sph, cap, zcap, cub, zcub, ns, nc, nzc, nb, nzb, env_batched,
                           bitmap, chunks, points, pc_meta, rrows, nch, pc_batched,
                           att, att_pc, A, att_batched, hf_meta, hf_data, nh, hf_cells,
                           hf_batched};
  const fkcc::Robot robot{frame_i, frame_f, F, n_slots, sphere_order, sphere_f, S,
                          pairs, pair_thr, P, sphere_pc, ee_frame, att_check, n_att_check};
  SimpParams p{ip[0], ip[1], ip[2], ip[3], ip[4], ip[5], fp[0], fp[1], fp[2]};
  int T = 0, bytes = 0;
  const int cands[] = {128, 64, 32};
  for (int cand : cands) {
    const int need = Layout(p, et, robot, cand).total * 4;
    if (need <= max_smem) {
      T = cand;
      bytes = need;
      break;
    }
  }
  if (T == 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      simplify_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch's check does not see it
    return (int)err;
  }
  launch_info[0] = T;
  launch_info[1] = bytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&launch_info[2], simplify_mega_kernel, T, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  simplify_mega_kernel<<<p.B, T, bytes, (cudaStream_t)stream>>>(et, robot, p, paths, lengths,
                                                               out_path, out_scal, out_work);
  return (int)cudaGetLastError();
}
