// RRT-Connect planner megakernel for NVIDIA Hopper (sm_90a): one whole
// dynamic-domain, balanced, bidirectional RRT-Connect solve per block.
//
// Replaces the TPU kernel vamp_mvt_tpu/planning/rrtc_mega.py::_run_mega
// (its body _make_mega_kernel).  The grid is one block (or one cluster of k
// blocks, below) per problem; the block loops until its own problem is
// solved, out of sample budget or out of node capacity, so a finished
// problem frees its SM at once.  One step
// mirrors the lockstep plain version, vamp_mvt_tpu_torch/planning/rrtc.py
// (_make_step), which the tests hold it against.  A step has a grow part
// and a connect part:
//
//   grow part:
//     - tree balancing (only while no connect chain is active);
//     - K*W Halton samples (the integer digit recurrence of sampling/halton.py,
//       numerator times the float32 constant 1/denom, scaled by the float32
//       spans and lows of the plain version);
//     - nearest node of tree a for every sample, in the dot form
//       |n|^2 + |s|^2 - 2 n.s with each node's norm stored at insert; ties go
//       to the smallest node index;
//     - the dynamic-domain window prefilter, compaction of the first K kept
//       samples (a warp ballot / popc scan) and the consumed-sample rule;
//     - extension edges, FK + collision of their interpolation points
//       (fkcc_device.cuh), inserts, dynamic-domain radius updates;
//     - nearest node of tree b for every inserted node, and entry into a
//       connect chain from the one nearest to tree b;
//   connect part: up to C increments of the active chain, inserted while
//     valid.
//
// Two cadences, as in the TPU kernel (its `interleave` setting, INTER).  The
// alternating one (the default) runs the grow part while no chain is active
// and the connect part while one is.  The interleaved one runs the grow part
// every step, and an active chain's increments ride along in the same step:
// one FK + collision pass covers the grow edges and the chain's edges, the
// chain's valid prefix is inserted first (rows n_nodes..), the grow nodes
// after it, both nearest-neighbour scans read the pre-step tree, and a new
// chain starts only where the old one failed or was absent.  The fixed cost
// of a step (sampling, the scans, the bookkeeping) is then paid once where
// the alternating cadence pays it on two steps.
//
// At the end the block walks both parent chains and exports only the
// max_path path rows and the scalars (plus its work counters: configurations
// checked, node-sample pairs scanned, and the pointcloud's spheres gated,
// chunk bounds tested and points evaluated), the cycles of each phase of
// a step, read by thread 0 at barriers the step passes anyway, and the
// card's %globaltimer (ns) as the block (cluster) enters and as it leaves,
// and the SM time its blocks held.  A pointcloud
// (fkcc_device.cuh) and a heightfield's heights stay in global memory; a
// heightfield's meta rows (10 floats a field), an attachment's payload rows
// and the robot tables go to shared memory, and each payload sphere adds 3
// floats a group to the FK scratch.
//
// Node memory.  On the TPU the (M + 32, 128) node buffer lived in VMEM.  Here
// each block owns M rows of (d + 4) floats in global memory (configuration,
// in_start flag, dynamic-domain radius, parent index as int bits, squared
// norm); only the live prefix is ever read, and for the trees of a typical
// problem it stays in L1/L2.  Nearest-neighbour scans stage 128 node rows at
// a time into shared memory.  A problem planned by a cluster of k blocks
// (below) has k replicas of its rows, one a block: every block runs the same
// deterministic state machine on the same data and writes the same inserts,
// so no block reads rows another SM wrote (which would need the SMs' L1
// lines kept coherent).
//
// Clusters.  The launcher may run each problem on a thread-block cluster of
// k blocks (k a launch attribute, 1 to 8; problem = blockIdx.x / k, rank =
// the block's rank in the cluster), each on its own SM.  The ranks split the
// two expensive phases and merge through distributed shared memory (DSMEM),
// one cluster barrier an exchange (the edge flags' arrays double-buffered):
//   - the FK + collision pass: rank r takes points r * T / G + group, step
//     k * T / G, and the ranks OR their edge flags together;
//   - both nearest-neighbour scans: rank r scans node chunks r, r + k, ...,
//     and every rank merges the k partial (d^2, index) minima, lower d^2 then
//     lower index, which is the node one scan in index order finds.
// The rest of a step (sampling, prefilter, edges, inserts, state) every rank
// repeats.  So solved flags, iterations, trees and paths are bit-identical
// at every k.  Rank 0 exports the path, the scalars and its phase clocks;
// the work counters are the ranks' sums.  At k = 1 no cluster barrier and
// no DSMEM access runs: the kernel takes the one-block path.
//
// What bounds it.  Per step the block evaluates up to K grow edges and C
// chain increments of 8 * ceil(length * resolution / 8) points each through
// FK + collision (some 18k-30k FP32 operations per Panda configuration) and
// scans the live tree once per sample (2d + 3 operations per node-sample
// pair): FP32 arithmetic and the shared-memory loads that feed it, in either
// cadence; the node rows it reads are a few KB a step.  On the first budget
// the FK + collision pass takes about 90% of a block's cycles (the phase
// clocks); the retry's trees grow to thousands of rows, so its scans, linear
// in the tree, take a larger share.  The kernel ends when its slowest
// problem does (that block's cycles match the kernel's time), so the design
// cuts one problem's step latency; where a launch has fewer problems than
// the card has SMs (the retry, one cloud) a cluster puts k SMs on each:
//   - a block of T threads (512 for every robot; launch_shape in
//     ops/kernels/rrtc_mega_cuda.py picks T and G) checks T / G
//     configurations at a time, G lanes of a warp each
//     (fkcc_device.cuh::config_vmin_group): one FK scratch a group, not a
//     thread (Panda: 364 floats a group, 128 groups of 4 lanes in 220,544
//     bytes), so 16 warps work on one problem where the per-thread design
//     ran 4 (128 threads, 117,676 bytes of per-thread scratch);
//   - the point -> edge map is a binary search over s_eoff;
//   - warp 0 builds the edges and their prefix sum with a shuffle scan,
//     every warp ballots the grow edges' insert positions and finds the
//     grow node nearest to tree b with a warp min (lowest edge on ties), the
//     radius updates run one edge a thread (the last edge sharing a node
//     writes), the chain's increment is double-buffered: a grow step passes
//     6 block barriers besides the scans', a connect step 3 (11 and 5
//     before);
//   - the nearest-neighbour scans split each query's nodes over the T / 128
//     threads that would otherwise wait, and merge their minima;
//   - the cluster split above divides both by k.
//
// Numerics.  --fmad=false; every sum in the plain version's order (sum_last
// is left to right); `range / x` is computed as reciprocal(x) * range and
// `x / range` as x * (1 / range), as PyTorch computes them on the card.  The
// plain version's dot products go through cuBLAS, whose order is its own, so
// a near tie in a nearest-neighbour scan can resolve differently.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstring>

#include "fkcc_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 16;
constexpr int kMaxLanes = 128;   // K * W
constexpr int kMaxEdges = 64;    // K + C
constexpr int kChunk = 128;      // node rows staged per nearest-neighbour pass
constexpr int kMaxThreads = 512; // threads a block (the launcher's T)
constexpr int kMeta = 4;         // in_start, radius, parent, norm
constexpr int kLanesPerThread = kMaxLanes / 32;
constexpr int kScalars = 16;
constexpr int kWork = 5;
// Phase clocks (cycles of clock64() summed per block, read by thread 0 at
// barriers the step passes anyway), exported after the work counters.
enum Phase { kSampling, kNnA, kPrefilter, kEdges, kFkcc, kNnB, kInserts, kPhases };
// Then the cluster's first entry and last exit on the card's %globaltimer
// (ns), and its blocks' exit - entry summed (the SM time it held).
constexpr int kTimes = 3;
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable limit)
// A cluster block's exchange arrays (static shared memory): one for each
// nearest-neighbour scan (a minimum and its index for each of
// kMaxLanes queries), then two for the edge flags, taken by the step's
// parity.  Every exchange writes its array, passes one cluster barrier and
// reads the other ranks' copies.  A rank writes an array again only past
// another exchange's barrier (every step has an edge-flag exchange), which
// every reader of its last use has reached, so one barrier an exchange is
// enough.
constexpr int kXchScan = 2 * kMaxLanes;
constexpr int kXchNnA = 0, kXchNnB = kXchScan, kXchBad = 2 * kXchScan;
constexpr int kXchFloats = 2 * kXchScan + 2 * kMaxEdges;
constexpr int kWorkCols = kWork + kPhases + kTimes;
// Radius of a node never updated: a finite stand-in for infinity, as in the
// TPU kernel's node rows (mega_inputs writes it for the roots).
constexpr float kBig = 1.0e30f;

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The launcher's integer parameters (ip[]) then its float ones (fp[]), in
// this order (ops/kernels/rrtc_mega_cuda.py::params).
struct PlanParams {
  int d, K, C, KW, M, max_path, num_points, dyn, balance, a_start0, G1, B, inter;
  int base[kMaxDim], digits[kMaxDim];
  float range, inv_range, res8, radius, grow_ok, shrink_fail, min_radius, tree_ratio;
  float inv_denom[kMaxDim], low[kMaxDim], span[kMaxDim];
};
constexpr int kIntParams = 13 + 2 * kMaxDim;
constexpr int kFloatParams = 8 + 3 * kMaxDim;
static_assert(sizeof(PlanParams) == 4 * (kIntParams + kFloatParams), "PlanParams is packed");

// Planner state, kept in shared memory and written by thread 0 only.
struct State {
  int iters, sample_idx, n_nodes, size_start, size_goal, a_is_start, connect;
  int c_tip, c_rem, c_other, done, junc_a, junc_b, a_j_start, gsteps, csteps;
  int budget, consumed, inc;  // inc: which half of s_inc holds the chain's increment
  int step;                   // steps taken (its parity picks the edge-flag exchange)
  float c_len;
};

// Shared-memory layout in floats (ints share the 4-byte slots): the
// problem's shape rows, the robot tables, T / G groups' FK scratch, then the
// step's samples, node chunk and edge lists.
struct Layout {
  int env, robot, group, samp, s2, chunk, part, ecfg, evec, enew, en, enear, endist, enrad,
      eq2, eoff, ebad, eod, eoidx, tip, inc, words, pathidx, total;
  __host__ __device__ Layout(const PlanParams& p, const fkcc::EnvTables& et,
                             const fkcc::Robot& r, int T, int G) {
    const int d = p.d, E = kMaxEdges;
    int o = 0;
    env = o; o += fkcc::env_floats(et);
    robot = o; o += fkcc::robot_floats(r);
    group = o; o += fkcc::group_floats(r, et, d, G) * (T / G);
    samp = o; o += kMaxLanes * d;
    s2 = o; o += kMaxLanes;
    chunk = o; o += kChunk * (d + 2);
    part = o; o += 2 * T;
    ecfg = o; o += E * d;
    evec = o; o += E * d;
    enew = o; o += E * d;
    en = o; o += E;
    enear = o; o += E;
    endist = o; o += E;
    enrad = o; o += E;
    eq2 = o; o += E;
    eoff = o; o += E + 1;
    ebad = o; o += E;
    eod = o; o += E;
    eoidx = o; o += E;
    tip = o; o += d;
    inc = o; o += 2 * d;
    words = o; o += kMaxLanes / 32;
    pathidx = o; o += p.max_path;
    total = o;
  }
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The block's rank in its problem's cluster and the cluster's blocks (1
// without a cluster launch), written by thread 0 as the block enters and
// read from shared memory where used, as are the exchange arrays: nothing
// of the cluster is held in a register across a step, so the one-block
// path keeps the registers it had.
__shared__ int s_cluster[2];
__shared__ float s_xch[kXchFloats];
__device__ __forceinline__ int cluster_rank() { return s_cluster[0]; }
__device__ __forceinline__ int cluster_blocks() { return s_cluster[1]; }

// The cluster barrier: every thread of every rank arrives; release /
// acquire, so each rank's shared-memory writes before it are visible to the
// others' reads after it.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// `p` (this block's shared memory) in rank r's shared memory (DSMEM).
template <class V>
__device__ __forceinline__ const V* in_rank(const V* p, int r) {
  return cg::this_cluster().map_shared_rank(const_cast<V*>(p), r);
}

// Left-to-right sum of squares (validate.sum_last of v * v).
__device__ __forceinline__ float sum_sq(const float* v, int d) {
  float acc = v[0] * v[0];
  for (int j = 1; j < d; ++j) acc = acc + v[j] * v[j];
  return acc;
}

// Dot product in index order, no fused multiply-add (--fmad=false).
__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float acc = a[0] * b[0];
  for (int j = 1; j < d; ++j) acc = acc + a[j] * b[j];
  return acc;
}

// Scan the live prefix [0, n_nodes) of a node buffer for the nearest node of
// each query among rows whose in_start flag equals `want` (in_tree) or
// differs from it.  Queries qi = q0 + r * Tq < nq of s_queries (nq x d) with
// squared norms qn2, Tq = min(T, kMaxLanes); a block of more threads splits
// each staged chunk's rows among its T / Tq parts and merges the parts'
// minima through s_part (2 T floats), lowest node index on ties, as one
// scan in index order finds them.  In a cluster of k > 1 blocks the block
// of rank r scans chunks r, r + k, ... and the ranks merge their minima
// through DSMEM by the same rule, in the exchange array s_xch.  Best d2 / index per query in best[] / bidx[]
// (complete in part 0: threads tid < Tq).  Every thread of the block (of
// every rank) must call it.
__device__ void nearest_scan(const float* nb, int RS, int d, int n_nodes, float want,
                             bool in_tree, const float* s_queries, const float* s_qn2,
                             int nq, float* s_chunk, float* s_part, float best[kLanesPerThread],
                             int bidx[kLanesPerThread], long long& pairs, float* s_xch) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int Tq = min(T, kMaxLanes), parts = T / Tq, part = tid / Tq, q0 = tid - part * Tq;
  for (int r = 0; r < kLanesPerThread; ++r) {
    best[r] = inf_f();
    bidx[r] = 0;
  }
  for (int base = cluster_rank() * kChunk; base < n_nodes; base += cluster_blocks() * kChunk) {
    const int cnt = min(kChunk, n_nodes - base);
    __syncthreads();
    for (int i = tid; i < cnt * (d + 2); i += T) {
      const int row = i / (d + 2), col = i % (d + 2);
      const float* src = nb + (long long)(base + row) * RS;
      s_chunk[i] = col < d ? src[col] : (col == d ? src[d + 3] : src[d]);
    }
    __syncthreads();
    for (int r = 0; r < kLanesPerThread; ++r) {
      const int qi = q0 + r * Tq;
      if (qi >= nq) break;
      const float* qv = s_queries + qi * d;
      const float q2 = s_qn2[qi];
      float bd = best[r];
      int bi = bidx[r];
      for (int k = part; k < cnt; k += parts) {
        const float* row = s_chunk + k * (d + 2);
        if ((row[d + 1] == want) != in_tree) continue;
        const float d2 = (q2 + row[d]) - 2.0f * dot(qv, row, d);
        ++pairs;
        if (d2 < bd) {
          bd = d2;
          bi = base + k;
        }
      }
      best[r] = bd;
      bidx[r] = bi;
    }
  }
  if (parts > 1) {  // one query a thread (Tq = kMaxLanes >= nq)
    s_part[tid] = best[0];
    reinterpret_cast<int*>(s_part)[T + tid] = bidx[0];
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < parts; ++p) {
        const float pd = s_part[p * Tq + q0];
        const int pi = reinterpret_cast<int*>(s_part)[T + p * Tq + q0];
        if (pd < best[0] || (pd == best[0] && pi < bidx[0])) {
          best[0] = pd;
          bidx[0] = pi;
        }
      }
    }
  }
  const int ck = cluster_blocks();
  if (ck > 1) {  // part 0 publishes its minima, then merges the other ranks'
    float* xd = s_xch;
    int* xi = reinterpret_cast<int*>(xd + kMaxLanes);
    if (part == 0) {
      for (int r = 0; r < kLanesPerThread; ++r) {
        const int qi = q0 + r * Tq;
        if (qi >= nq) break;
        xd[qi] = best[r];
        xi[qi] = bidx[r];
      }
    }
    cluster_sync();
    if (part == 0) {
      const int rank = cluster_rank();
      for (int q = 0; q < ck; ++q) {
        if (q == rank) continue;
        const float* od = in_rank(xd, q);
        const int* oi = in_rank(xi, q);
        for (int r = 0; r < kLanesPerThread; ++r) {
          const int qi = q0 + r * Tq;
          if (qi >= nq) break;
          const float pd = od[qi];
          const int pi = oi[qi];
          if (pd < best[r] || (pd == best[r] && pi < bidx[r])) {
            best[r] = pd;
            bidx[r] = pi;
          }
        }
      }
    }
  }
  __syncthreads();
}

// Inclusive sum of v over the lanes of a warp (every lane calls it).
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

// kInter: the interleaved cadence (one instantiation each, so the alternating
// one carries none of its code); G: lanes a configuration of the FK pass.
template <bool kInter, int G>
__global__ void __launch_bounds__(kMaxThreads, 1)
rrtc_mega_kernel(fkcc::EnvTables et, fkcc::Robot robot, PlanParams p,
                 const int* __restrict__ ctl, const float* __restrict__ nodes0,
                 float* __restrict__ nodes, float* __restrict__ out_path,
                 int* __restrict__ out_scal, long long* __restrict__ out_work) {
  extern __shared__ float smem[];
  __shared__ long long s_enter, s_exit;  // thread 0's %globaltimer as the block enters, leaves
  if (threadIdx.x == 0) {
    s_enter = globaltimer();
    s_cluster[0] = (int)cg::this_cluster().block_rank();
    s_cluster[1] = (int)cg::this_cluster().num_blocks();
  }
  __shared__ State st;
  __shared__ unsigned long long s_work[kWork - 1];  // pairs, gates, chunks, points
  __shared__ long long s_ph[kPhases + 1];            // the phases' cycles, then the last read
  // problem b, on a cluster of blocks (one without a cluster launch)
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / (int)cg::this_cluster().num_blocks();
  const int d = p.d, K = p.K, C = p.C, KW = p.KW, M = p.M, RS = d + kMeta;
  const Layout L(p, et, robot, T, G);
  const fkcc::Env env = fkcc::load_env(et, b, smem + L.env);
  const fkcc::GroupRobot gr = fkcc::load_robot(robot, smem + L.robot);
  // this thread's group: its scratch, its lane, its lanes
  const int n_groups = T / G, gl = tid & (G - 1);
  const unsigned gmask = fkcc::group_mask<G>();
  float* s_group = smem + L.group + (tid / G) * fkcc::group_floats(robot, et, d, G);
  float* s_samp = smem + L.samp;
  float* s_s2 = smem + L.s2;
  float* s_chunk = smem + L.chunk;
  float* s_part = smem + L.part;
  float* s_ecfg = smem + L.ecfg;
  float* s_evec = smem + L.evec;
  float* s_enew = smem + L.enew;
  float* s_en = smem + L.en;
  int* s_enear = reinterpret_cast<int*>(smem + L.enear);
  float* s_endist = smem + L.endist;
  float* s_enrad = smem + L.enrad;
  float* s_eq2 = smem + L.eq2;
  int* s_eoff = reinterpret_cast<int*>(smem + L.eoff);
  int* s_ebad = reinterpret_cast<int*>(smem + L.ebad);
  float* s_eod = smem + L.eod;
  int* s_eoidx = reinterpret_cast<int*>(smem + L.eoidx);
  float* s_tip = smem + L.tip;
  unsigned* s_words = reinterpret_cast<unsigned*>(smem + L.words);
  int* s_pathidx = reinterpret_cast<int*>(smem + L.pathidx);

  float* nb = nodes + (long long)blockIdx.x * M * RS;  // this block's replica
  long long configs = 0, pairs = 0;
  fkcc::Work pcw{0, 0, 0};

  // ------------------------------ initialisation --------------------------
  const int* c = ctl + b * 8;
  for (int i = tid; i < p.G1 * RS; i += T) {
    const int row = i / RS, col = i % RS;
    const float v = nodes0[((long long)b * p.G1 + row) * RS + col];
    nb[(long long)row * RS + col] = col == d + 2 ? __int_as_float((int)v) : v;
  }
  if (tid == 0) {
    st.iters = 0;
    st.sample_idx = c[0] + 1;
    st.n_nodes = p.G1;
    st.size_start = 1;
    st.size_goal = c[2];
    st.a_is_start = p.a_start0;
    st.connect = 0;
    st.c_tip = 0;
    st.c_rem = 0;
    st.c_other = 0;
    st.done = c[1];
    st.junc_a = 0;
    st.junc_b = 0;
    st.a_j_start = 1;
    st.gsteps = 0;
    st.csteps = 0;
    st.budget = c[3];
    st.inc = 0;
    st.step = 0;
    st.c_len = 1.0f;
    for (int i = 0; i < kWork - 1; ++i) s_work[i] = 0;
    for (int i = 0; i < kPhases; ++i) s_ph[i] = 0;
  }
  for (int j = tid; j < 2 * d; j += T) smem[L.inc + j] = 0.0f;
  __syncthreads();
  // thread 0 charges the cycles since its last read to phase i
  const auto tick = [&](int i) {
    if (tid == 0) {
      const long long now = clock64();
      s_ph[i] += now - s_ph[kPhases];
      s_ph[kPhases] = now;
    }
  };
  if (tid == 0) s_ph[kPhases] = clock64();

  // --------------------------------- loop ---------------------------------
  while (true) {
    __syncthreads();
    tick(kInserts);
    const int n_nodes = st.n_nodes;
    if (!(st.done == 0 && (st.iters < st.budget || st.connect) && n_nodes < M)) break;
    const bool grow = st.connect == 0;
    // The alternating cadence runs either part a step; the interleaved one
    // (kInter) runs the grow part every step, an active chain riding along.
    const bool do_grow = grow || kInter;
    const bool do_conn = !grow;
    // thread 0 rewrites the state at the end of the step; what the other
    // threads read after the FK pass is taken here
    const int c_tip = st.c_tip, inc_cur = st.inc;
    const float* s_inc = smem + L.inc + inc_cur * d;

    // tree balancing (rrtc.hh:100-108), while no chain is active
    int a_is = st.a_is_start;
    if (grow) {
      const float asize = (float)(a_is ? st.size_start : st.size_goal);
      const float bsize = (float)(a_is ? st.size_goal : st.size_start);
      const float ratio = fabsf(asize - bsize) / asize;
      if (!p.balance || ratio < p.tree_ratio) a_is = 1 - a_is;
    }
    const float af = (float)a_is;
    int n_acc = 0;  // grow edges, then the chain's increments

    if (do_grow) {
      // --- K*W Halton samples scaled to the joint limits
      for (int ln = tid; ln < KW; ln += T) {
        const int idx = st.sample_idx + ln;
        float* sv = s_samp + ln * d;
        for (int j = 0; j < d; ++j) {
          const int bj = p.base[j];
          int i = idx, n = 0;
          for (int k = 0; k < p.digits[j]; ++k) {
            n = n * bj + i % bj;
            i = i / bj;
          }
          const float u = (float)n * p.inv_denom[j];
          sv[j] = u * p.span[j] + p.low[j];
        }
        s_s2[ln] = sum_sq(sv, d);
      }
      if (tid == 0) st.consumed = KW;
      tick(kSampling);

      // --- nearest node of tree a for every sample (its first barriers
      // publish the samples)
      float best[kLanesPerThread];
      int bidx[kLanesPerThread];
      nearest_scan(nb, RS, d, n_nodes, af, true, s_samp, s_s2, KW, s_chunk, s_part, best,
                   bidx, pairs, s_xch + kXchNnA);
      tick(kNnA);

      // --- dynamic-domain prefilter, ballot scan of the kept samples
      bool acc[kLanesPerThread];
      float ndist[kLanesPerThread], nrad[kLanesPerThread];
      for (int r = 0; r < kLanesPerThread; ++r) {
        const int ln = tid + r * T;
        acc[r] = false;
        if (ln < KW) {
          ndist[r] = sqrtf(fmaxf(best[r], 0.0f));
          nrad[r] = nb[(long long)bidx[r] * RS + d + 1];
          acc[r] = !(p.dyn && nrad[r] < ndist[r]);
        }
        const int first = r * T;
        if (first < KW) {  // warp-uniform: lanes of a warp share r
          const unsigned word = __ballot_sync(0xffffffffu, acc[r]);
          if (lane == 0 && ln < KW) s_words[ln >> 5] = word;
        }
      }
      __syncthreads();
      const int n_words = (KW + 31) / 32;
      int total_acc = 0;
      for (int w = 0; w < n_words; ++w) total_acc += __popc(s_words[w]);
      n_acc = min(total_acc, K);
      for (int r = 0; r < kLanesPerThread; ++r) {
        const int ln = tid + r * T;
        if (ln >= KW || !acc[r]) continue;
        int rank = __popc(s_words[ln >> 5] & ((1u << (ln & 31)) - 1u));
        for (int w = 0; w < (ln >> 5); ++w) rank += __popc(s_words[w]);
        if (rank >= K) continue;
        if (rank == K - 1) st.consumed = ln + 1;
        for (int j = 0; j < d; ++j) s_ecfg[rank * d + j] = s_samp[ln * d + j];
        s_enear[rank] = bidx[r];
        s_endist[rank] = ndist[r];
        s_enrad[rank] = nrad[r];
      }
      __syncthreads();
      tick(kPrefilter);
    }
    const int n_cedges = do_conn ? min(C, st.c_rem) : 0;
    const float n_conn = do_conn ? fmaxf(ceilf(st.c_len * p.res8), 1.0f) : 1.0f;
    const int n_edges = n_acc + n_cedges;
    if (do_conn) {
      const float* tip = nb + (long long)c_tip * RS;
      for (int j = tid; j < d; j += T) s_tip[j] = tip[j];
    }
    // --- warp 0: the extension edges of the kept samples (edges 0..n_acc-1;
    // n_acc..n_edges-1 are the chain's increments), each edge's point count
    // and their prefix sum s_eoff (a shuffle scan over lanes e and e + 32)
    if (tid < 32) {
      int cnt[2];
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        float n = n_conn;
        if (e < n_acc) {
          const float nd = s_endist[e];
          const float* near = nb + (long long)s_enear[e] * RS;
          const float scale = nd < p.range ? 1.0f : (1.0f / fmaxf(nd, 1e-12f)) * p.range;
          float* cfg = s_ecfg + e * d;  // the sample; becomes the edge start
          float* vec = s_evec + e * d;
          float* nw = s_enew + e * d;
          for (int j = 0; j < d; ++j) {
            const float nj = near[j];
            vec[j] = (cfg[j] - nj) * scale;
            cfg[j] = nj;
            nw[j] = nj + vec[j];
          }
          n = fmaxf(ceilf(fminf(nd, p.range) * p.res8), 1.0f);
          s_en[e] = n;
          s_eq2[e] = sum_sq(nw, d);
        }
        cnt[h] = e < n_edges ? min(8 * (int)n, p.num_points) : 0;
        if (e < n_edges) s_ebad[e] = 0;
      }
      const int lo = warp_scan(cnt[0], lane);
      const int hi = warp_scan(cnt[1], lane) + __shfl_sync(0xffffffffu, lo, 31);
      s_eoff[lane + 1] = lo;
      s_eoff[lane + 33] = hi;
      if (lane == 0) s_eoff[0] = 0;
    }
    __syncthreads();
    tick(kEdges);

    // --- FK + collision of every interpolation point of both kinds of
    // edge, one configuration a group of G lanes (the cluster's groups
    // rank by rank)
    const int total = s_eoff[n_edges];
    if (tid == 0) configs += total;
    for (int pt = cluster_rank() * n_groups + tid / G; pt < total;
         pt += cluster_blocks() * n_groups) {
      int lo = 0, hi = n_edges - 1;  // the edge e with s_eoff[e] <= pt < s_eoff[e + 1]
      while (lo < hi) {
        const int m = (lo + hi + 1) >> 1;
        if (s_eoff[m] <= pt) lo = m;
        else hi = m - 1;
      }
      const int e = lo;
      const int k = pt - s_eoff[e] + 1;
      const bool is_grow = e < n_acc;
      const float n = is_grow ? s_en[e] : n_conn;
      const float frac = fminf((float)k / (8.0f * n), 1.0f);
      if (is_grow) {
        for (int j = gl; j < d; j += G) s_group[j] = s_ecfg[e * d + j] + s_evec[e * d + j] * frac;
      } else {
        const float seg = (float)(e - n_acc) + frac;
        for (int j = gl; j < d; j += G) s_group[j] = s_tip[j] + s_inc[j] * seg;
      }
      const float v = fkcc::config_vmin_group<G>(env, gr, s_group, d, gl, gmask, pcw);
      if (gl == 0 && v < 0.0f) s_ebad[e] = 1;
    }
    __syncthreads();
    if (cluster_blocks() > 1) {  // OR the ranks' edge flags together
      int* xb = reinterpret_cast<int*>(s_xch + kXchBad) + (st.step & 1) * kMaxEdges;
      for (int e = tid; e < n_edges; e += T) xb[e] = s_ebad[e];
      cluster_sync();
      const int rank = cluster_rank(), ck = cluster_blocks();
      for (int e = tid; e < n_edges; e += T) {
        int bad = xb[e];
        for (int q = 0; q < ck; ++q) bad |= q == rank ? 0 : in_rank(xb, q)[e];
        s_ebad[e] = bad;
      }
      __syncthreads();
    }
    tick(kFkcc);

    // --- insert positions: the chain's leading run of valid increments at
    // n_nodes.., then every valid grow edge, in order, while room remains
    // (every warp ballots the grow edges' validity, so each thread knows
    // every edge's position)
    int prefix = 0;
    while (prefix < n_cedges && !s_ebad[n_acc + prefix]) ++prefix;
    const int c_ins = min(prefix, M - n_nodes);
    const int gbase = n_nodes + c_ins;
    const unsigned ok0 = __ballot_sync(0xffffffffu, lane < n_acc && !s_ebad[lane]);
    const unsigned ok1 = __ballot_sync(0xffffffffu, lane + 32 < n_acc && !s_ebad[lane + 32]);
    const int n_ins = min(__popc(ok0) + __popc(ok1), M - gbase);
    const auto epos = [&](int e) {  // insert row of grow edge e, or -1
      const unsigned w = e < 32 ? ok0 : ok1;
      const int bit = e & 31;
      if (!((w >> bit) & 1u)) return -1;
      const int rank = (e < 32 ? 0 : __popc(ok0)) + __popc(w & ((1u << bit) - 1u));
      return rank < M - gbase ? gbase + rank : -1;
    };

    // --- nearest node of tree b (the pre-step prefix) for every grow edge
    if (n_ins > 0) {
      float best[kLanesPerThread];
      int bidx[kLanesPerThread];
      nearest_scan(nb, RS, d, n_nodes, af, false, s_enew, s_eq2, n_acc, s_chunk, s_part,
                   best, bidx, pairs, s_xch + kXchNnB);
      for (int r = 0; r < kLanesPerThread; ++r) {
        const int e = tid + r * T;
        if (e < n_acc) {
          s_eod[e] = sqrtf(fmaxf(best[r], 0.0f));
          s_eoidx[e] = bidx[r];
        }
      }
      __syncthreads();
      tick(kNnB);
    }

    // --- inserts: configuration, tree flag, radius, parent, norm
    for (int j = tid; j < c_ins; j += T) {
      float* row = nb + (long long)(n_nodes + j) * RS;
      const float step = (float)j + 1.0f;
      for (int k = 0; k < d; ++k) row[k] = s_tip[k] + s_inc[k] * step;
      row[d] = af;
      row[d + 1] = kBig;
      row[d + 2] = __int_as_float(j == 0 ? c_tip : n_nodes + j - 1);
      row[d + 3] = sum_sq(row, d);
    }
    for (int e = tid; e < n_acc; e += T) {
      const int pos = epos(e);
      if (pos >= 0) {
        float* row = nb + (long long)pos * RS;
        for (int j = 0; j < d; ++j) row[j] = s_enew[e * d + j];
        row[d] = af;
        row[d + 1] = kBig;
        row[d + 2] = __int_as_float(s_enear[e]);
        row[d + 3] = s_eq2[e];
      }
      // dynamic-domain radius updates (rrtc.hh:152-155, 226-237): from the
      // pre-step radii; of the edges sharing a node the last one writes
      if (p.dyn) {
        bool last = true;
        for (int e2 = e + 1; e2 < n_acc; ++e2) last = last && s_enear[e2] != s_enear[e];
        if (last) {
          const float r = s_enrad[e];
          const bool inf_r = r > 0.5f * kBig;
          const float nr = !s_ebad[e] ? (inf_r ? r : r * p.grow_ok)
                                      : (inf_r ? p.radius : fmaxf(r * p.shrink_fail, p.min_radius));
          nb[(long long)s_enear[e] * RS + d + 1] = nr;
        }
      }
    }

    // --- the inserted grow node nearest to tree b (lowest edge on ties):
    // a warp min over edges e and e + 32, in every warp
    int kc = 0;
    if (n_ins > 0) {
      float v = lane < n_acc && epos(lane) >= 0 ? s_eod[lane] : inf_f();
      int vi = lane;
      if (lane + 32 < n_acc && epos(lane + 32) >= 0 && s_eod[lane + 32] < v) {
        v = s_eod[lane + 32];
        vi = lane + 32;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, vi, o);
        if (ov < v || (ov == v && oi < vi)) {
          v = ov;
          vi = oi;
        }
      }
      kc = v < inf_f() ? vi : 0;
    }

    // --- state update (thread 0): the chain's outcome, then entry into a
    // new chain from the grow node nearest to tree b, where the old chain
    // failed or was absent; a new chain's increment goes to the other half
    // of s_inc, so this step's readers need no barrier
    const float other_dist = s_eod[kc];
    const int other = s_eoidx[kc];
    const int n_ext = (int)ceilf(other_dist * p.inv_range);
    const float n_ext_f = fmaxf((float)n_ext, 1.0f);
    const bool chain_ok = do_conn && prefix == n_cedges && c_ins == prefix;
    const bool enter = do_grow && n_ins > 0 && !chain_ok;
    if (enter) {
      const float* orow = nb + (long long)other * RS;
      float* inc_next = smem + L.inc + (1 - inc_cur) * d;
      for (int j = tid; j < d; j += T) inc_next[j] = (orow[j] - s_enew[kc * d + j]) / n_ext_f;
    }
    if (tid == 0) {
      const int n_nodes_new = n_nodes + c_ins + n_ins;
      if (a_is) st.size_start += c_ins + n_ins;
      else st.size_goal += c_ins + n_ins;
      const int rem_chain = st.c_rem - prefix;
      const int tip_after = enter ? epos(kc)
                                  : (chain_ok && prefix > 0 ? n_nodes + prefix - 1 : c_tip);
      const int rem_after = enter ? n_ext : (do_conn ? rem_chain : 0);
      const bool joined = ((enter && n_ext == 0) || (chain_ok && rem_chain == 0)) && st.done == 0;
      const bool cnext = ((enter && n_ext > 0) || (chain_ok && rem_chain > 0)) && !joined &&
                         n_nodes_new < M;
      if (enter) {
        st.c_len = other_dist / n_ext_f;
        st.inc = 1 - inc_cur;
      }
      if (joined) {
        st.done = 1;
        st.junc_a = tip_after;
        st.junc_b = enter ? other : st.c_other;
        st.a_j_start = a_is;
      }
      if (enter) st.c_other = other;
      st.c_tip = tip_after;
      st.c_rem = rem_after;
      st.connect = cnext ? 1 : 0;
      st.a_is_start = a_is;
      st.n_nodes = n_nodes_new;
      if (do_grow) {
        st.iters += st.consumed;
        st.sample_idx += st.consumed;
        st.gsteps += 1;
      }
      if (do_conn) st.csteps += 1;
      st.step += 1;
    }
  }

  // ------------------------------ path export -----------------------------
  // rows 0..la-1: chain A root..junction; la..la+lb-1: chain B junction..root
  // (the positions rrtc._recover_path scatters to); other rows are zero.
  // Rank 0 of a cluster exports the path and the scalars.
  const int PP = p.max_path;
  const bool lead = cluster_rank() == 0;
  const int pb = blockIdx.x / cluster_blocks();  // b, read again here
  if (tid == 0 && lead) {
    for (int i = 0; i < PP; ++i) s_pathidx[i] = -1;
    int la = -1, lb = -1, cur = st.junc_a;
    for (int i = 0; i < PP; ++i) {
      const int par = __float_as_int(nb[(long long)cur * RS + d + 2]);
      if (la < 0 && par == cur) la = i + 1;
      cur = par;
    }
    la = max(la, 1);
    cur = st.junc_b;
    for (int i = 0; i < PP; ++i) {
      const int par = __float_as_int(nb[(long long)cur * RS + d + 2]);
      if (lb < 0 && par == cur) lb = i + 1;
      cur = par;
    }
    lb = max(lb, 1);
    cur = st.junc_a;
    for (int k = 0; k < la; ++k) {
      s_pathidx[la - 1 - k] = cur;
      cur = __float_as_int(nb[(long long)cur * RS + d + 2]);
    }
    cur = st.junc_b;
    for (int k = 0; k < lb && la + k < PP; ++k) {
      s_pathidx[la + k] = cur;
      cur = __float_as_int(nb[(long long)cur * RS + d + 2]);
    }
    int* sc = out_scal + (long long)pb * kScalars;
    sc[0] = st.done;
    sc[1] = st.junc_a;
    sc[2] = st.junc_b;
    sc[3] = st.a_j_start;
    sc[4] = st.iters;
    sc[5] = st.sample_idx - 1;
    sc[6] = st.n_nodes;
    sc[7] = st.size_start;
    sc[8] = st.size_goal;
    sc[9] = st.gsteps;
    sc[10] = st.csteps;
    sc[11] = la;
    sc[12] = lb;
    sc[13] = 0;
    sc[14] = 0;
    sc[15] = 0;
  }
  atomicAdd(&s_work[0], (unsigned long long)pairs);
  atomicAdd(&s_work[1], (unsigned long long)pcw.gates);
  atomicAdd(&s_work[2], (unsigned long long)pcw.chunks);
  atomicAdd(&s_work[3], (unsigned long long)pcw.points);
  __syncthreads();
  for (int i = tid; i < PP * d && lead; i += T) {
    const int row = i / d, col = i % d;
    const int node = s_pathidx[row];
    out_path[(long long)pb * PP * d + i] = node >= 0 ? nb[(long long)node * RS + col] : 0.0f;
  }
  if (tid == 0) s_exit = globaltimer();
  const int ck = cluster_blocks();
  if (ck > 1) cluster_sync();  // every rank's counters and times are final
  // rank 0: the configurations checked (every rank counts them all), the
  // ranks' other counters summed, its phase clocks, the cluster's first
  // entry and last exit, and its blocks' times summed
  if (tid == 0 && lead) {
    long long enter = s_enter, leave = s_exit, busy = s_exit - s_enter;
    unsigned long long sw[kWork - 1];
    for (int i = 0; i < kWork - 1; ++i) sw[i] = s_work[i];
    for (int q = 1; q < ck; ++q) {
      const long long qe = *in_rank(&s_enter, q), qx = *in_rank(&s_exit, q);
      enter = min(enter, qe);
      leave = max(leave, qx);
      busy += qx - qe;
      const unsigned long long* qw = in_rank(s_work, q);
      for (int i = 0; i < kWork - 1; ++i) sw[i] += qw[i];
    }
    long long* w = out_work + (long long)pb * kWorkCols;
    w[0] = configs;
    for (int i = 0; i < kWork - 1; ++i) w[1 + i] = (long long)sw[i];
    for (int i = 0; i < kPhases; ++i) w[kWork + i] = s_ph[i];
    w[kWork + kPhases] = enter;
    w[kWork + kPhases + 1] = leave;
    w[kWork + kPhases + 2] = busy;
  }
  if (ck > 1) cluster_sync();  // no rank leaves while rank 0 reads its shared memory
}

using Kernel = void (*)(fkcc::EnvTables, fkcc::Robot, PlanParams, const int*, const float*,
                        float*, float*, int*, long long*);

template <bool kInter>
Kernel kernel_for(int G) {
  switch (G) {
    case 1: return rrtc_mega_kernel<kInter, 1>;
    case 2: return rrtc_mega_kernel<kInter, 2>;
    case 4: return rrtc_mega_kernel<kInter, 4>;
    case 8: return rrtc_mega_kernel<kInter, 8>;
    case 16: return rrtc_mega_kernel<kInter, 16>;
    case 32: return rrtc_mega_kernel<kInter, 32>;
    default: return nullptr;
  }
}

// A launch configuration of clusters of k blocks of T threads (attr: its
// one attribute, the cluster's shape).
cudaLaunchConfig_t cluster_config(int blocks, int T, int bytes, int k, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The clusters of k blocks of T threads with `bytes` of dynamic shared
// memory that the card keeps resident at once (cudaOccupancyMaxActiveClusters)
// for the kernel of this cadence and G, in *clusters; returns the CUDA error
// code (0 = ok), or -1 for a shape or k the kernel does not run.
extern "C" int rrtc_mega_clusters(int inter, int G, int T, int bytes, int k, int* clusters) {
  const Kernel kernel = inter ? kernel_for<true>(G) : kernel_for<false>(G);
  if (kernel == nullptr || T % 32 != 0 || T < 32 || T > kMaxThreads || k < 1 ||
      k > kMaxCluster)
    return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(k, T, bytes, k, nullptr, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// Launch one cluster of k blocks of T threads per problem (k = 1: one block,
// no cluster), G lanes a configuration in the FK pass, on `stream`; returns
// the CUDA error code of the launch (0 = ok), or -1 when the shape is not
// one the kernel runs (T a multiple of 32 up to kMaxThreads, G a power of
// two up to 32, k from 1 to kMaxCluster) or its shared memory does not fit
// in max_smem bytes.  ip / fp are host arrays in PlanParams order; `nodes`
// holds B * k blocks' rows.  launch_info receives the dynamic shared memory
// in bytes, the blocks the card keeps resident on one SM and the kernel's
// registers a thread.
extern "C" int rrtc_mega_launch(
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
    const int* ctl, const float* nodes0, float* nodes, float* out_path, int* out_scal,
    long long* out_work, int T, int G, int k, int max_smem, int* launch_info, void* stream) {
  const fkcc::EnvTables et{sph, cap, zcap, cub, zcub, ns, nc, nzc, nb, nzb, env_batched,
                           bitmap, chunks, points, pc_meta, rrows, nch, pc_batched,
                           att, att_pc, A, att_batched, hf_meta, hf_data, nh, hf_cells,
                           hf_batched};
  const fkcc::Robot robot{frame_i, frame_f, F, n_slots, sphere_order, sphere_f, S,
                          pairs, pair_thr, P, sphere_pc, ee_frame, att_check, n_att_check};
  PlanParams p;
  memcpy(&p, ip, kIntParams * 4);
  memcpy(reinterpret_cast<char*>(&p) + kIntParams * 4, fp, kFloatParams * 4);
  const Kernel kernel = p.inter ? kernel_for<true>(G) : kernel_for<false>(G);
  if (kernel == nullptr || T % 32 != 0 || T < 32 || T > kMaxThreads || k < 1 ||
      k > kMaxCluster)
    return -1;
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
  cudaLaunchAttribute cattr;
  cudaLaunchConfig_t cfg = cluster_config(p.B * k, T, bytes, k, stream, &cattr);
  if (k == 1) cfg.numAttrs = 0;  // one block a problem: a plain launch, no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, et, robot, p, ctl, nodes0, nodes, out_path, out_scal,
                           out_work);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
