"""The RRT-Connect planner megakernel for Hopper: binding and launch.

Port of the TPU kernel `vamp_mvt_tpu/planning/rrtc_mega.py::_run_mega`
(body `_make_mega_kernel`).  The kernel is `csrc/rrtc_mega.cu`, CUDA C++ for
sm_90a, built by `ops/kernels/build.py`; its host side (control word, initial
node rows, result) is `planning/rrtc_mega.py`, and its plain version is the
lockstep planner `planning/rrtc.py::plan_batch_compact` in the cadence that
`settings.interleave` names (alternating grow and connect steps, or the grow
part every step with an active chain riding along).

  plan(spec, envs, ctl, nodes0, settings, shape=None)
      ctl (B, 8) int32, nodes0 (B, 1 + G, d + 4) float32, CUDA tensors
      -> path (B, max_path, d) float32, scal (B, 16) int32, work (B, 12) int64

`scal` holds done, junction a, junction b, a-tree-was-start at the join,
iterations, samples drawn, nodes, start-tree size, goal-tree size, grow steps,
connect steps and the two chain lengths; `work` holds the configurations
checked, the node-sample pairs scanned and the pointcloud's spheres gated,
chunk bounds tested and points evaluated (zero without a pointcloud,
`envs.pck`), then the block's clock cycles in each phase of a step
(`PHASES`; `fkcc_cuda.phase_split` sums them over the batch).  A failed
build or launch raises.

The launch shape, T threads a block and G lanes of a warp a configuration
of the FK + collision pass, comes from `launch_shape` (a pure function of
the robot, the tables and the settings, mirroring the kernel's shared-memory
`Layout`); `shape=(T, G)` overrides it (the card tests run every G).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.ops.kernels import build, fkcc_cuda
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.sampling.halton import PRIMES, _digit_counts

MAX_DIM = 16       # kMaxDim of the kernel (one Halton base per dimension)
MAX_LANES = 128    # kMaxLanes: samples a grow step (K * W)
MAX_EDGES = 64     # kMaxEdges: edges a step (K + C)
SCALARS = 16
WORK = 5
# the phases of a planner step whose cycles follow the work counters
PHASES = ("sampling", "nn_a", "prefilter", "edges", "fkcc", "nn_b", "inserts")
# the kernel's static shared memory (state) comes on top of the dynamic part
_STATIC_SMEM = 1024
# node rows staged per nearest-neighbour pass (kChunk)
CHUNK = 128

# Kernel launches made by this process; callers reset it to 0 around a run.
LAUNCHES = 0
# Pointcloud work of the launches on pointcloud tables since a caller last
# set it to None: (3,) int64 on the card (spheres gated, chunk bounds tested,
# points evaluated).
PC_WORK = None
# The last launch's threads a block, lanes a configuration (group), dynamic
# shared memory (bytes), the blocks and warps the card keeps resident on one
# SM and the kernel's registers a thread.
LAST_LAUNCH: dict = {}
_LIB = None


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.library("rrtc_mega")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rrtc_mega_launch.argtypes = [
            *fkcc_cuda.ENV_ARGTYPES, *fkcc_cuda.ROBOT_ARGTYPES,
            P, P,                    # integer and float parameters (host)
            P, P, P,                 # ctl, nodes0, node buffer
            P, P, P,                 # path, scalars, work counters
            I, I,                    # threads a block, lanes a configuration
            I, P, P,                 # max shared memory, launch info, stream
        ]
        lib.rrtc_mega_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def params(spec: RobotSpec, s, G1: int, B: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's integer and float parameters, as float32 values equal to
    the ones the plain version computes with."""
    d = spec.dimension
    if d > MAX_DIM:
        raise ValueError(f"rrtc_mega: dimension {d} above {MAX_DIM}")
    f32 = np.float32
    digits = _digit_counts(d)
    bases = list(PRIMES[:d])
    pad = [0] * (MAX_DIM - d)
    ip = np.array(
        [d, s.samples_per_step, s.connect_segments,
         s.samples_per_step * s.sample_window, s.max_samples, s.max_path,
         validate_mod.n_points_bound(spec, s.range), int(s.dynamic_domain),
         int(s.balance), int(not s.start_tree_first), G1, B, int(s.interleave)]
        + bases + pad + digits + pad, np.int32,
    )
    lows = np.asarray(spec.limits_low, f32)
    spans = np.asarray(spec.limits_high, f32) - lows
    fpad = [f32(0)] * (MAX_DIM - d)
    fp = np.array(
        [f32(s.range), f32(1.0) / f32(s.range), f32(spec.resolution / 8.0),
         f32(s.radius), f32(1.0 + s.alpha), f32(1.0 - s.alpha), f32(s.min_radius),
         f32(s.tree_ratio)]
        + [f32(1.0 / float(b ** c)) for b, c in zip(bases, digits)] + fpad
        + list(lows) + fpad + list(spans) + fpad, np.float32,
    )
    return ip, fp


def smem_floats(spec: RobotSpec, envs: Environment, s, T: int, G: int) -> int:
    """Floats of dynamic shared memory a block of T threads with G lanes a
    configuration takes: csrc/rrtc_mega.cu's Layout."""
    d, E = spec.dimension, MAX_EDGES
    tab = fkcc_cuda.table_floats(spec, envs, G)
    return (tab["env"] + tab["robot"] + tab["group"] * (T // G)
            + MAX_LANES * d + MAX_LANES + CHUNK * (d + 2)     # samples, norms, node chunk
            + 2 * T                                            # the scan's partial minima
            + 3 * E * d + 5 * E + (E + 1) + 3 * E              # edge lists
            + 3 * d + MAX_LANES // 32 + s.max_path)            # tip, increments, words, path


def launch_shape(spec: RobotSpec, envs: Environment, s, shape=None) -> dict:
    """The kernel's launch shape for this robot, these tables and settings
    (fkcc_cuda.choose_shape: the most threads, the fewest rounds of a
    typical step's points, the most lanes a configuration at that count, at
    least MEGA_PC_MIN_GROUP on a pointcloud); `shape` = (T, G) overrides it.  A typical step checks K edges of range *
    resolution points each."""
    points = s.samples_per_step * 8 * int(np.ceil(s.range * spec.resolution / 8.0))
    return fkcc_cuda.choose_shape(lambda T, G: 4 * smem_floats(spec, envs, s, T, G),
                                  _STATIC_SMEM, fkcc_cuda.MAX_SMEM - _STATIC_SMEM, points,
                                  fkcc_cuda.MEGA_PC_MIN_GROUP if envs.pck is not None else 1,
                                  shape)


def _check(spec, envs: Environment, ctl, nodes0, s):
    if not (ctl.is_cuda and nodes0.is_cuda):
        raise ValueError("rrtc_mega kernel launch needs CUDA tensors")
    if ctl.dtype != torch.int32 or nodes0.dtype != torch.float32:
        raise TypeError("rrtc_mega: ctl must be int32 and nodes0 float32")
    B = ctl.shape[0]
    d = spec.dimension
    if ctl.shape != (B, 8) or nodes0.dim() != 3 or nodes0.shape[0] != B \
            or nodes0.shape[2] != d + 4:
        raise ValueError(
            f"rrtc_mega: ctl {tuple(ctl.shape)} must be (B, 8) and nodes0 "
            f"{tuple(nodes0.shape)} (B, 1 + G, {d + 4})")
    if not (ctl.is_contiguous() and nodes0.is_contiguous()):
        raise ValueError("rrtc_mega: ctl and nodes0 must be contiguous")
    if nodes0.shape[1] > s.max_samples:
        raise ValueError("rrtc_mega: more roots than node rows")
    fkcc_cuda._check_inputs(spec, envs, nodes0, B)


def plan(spec: RobotSpec, envs: Environment, ctl: torch.Tensor, nodes0: torch.Tensor,
         settings, shape=None):
    """Launch the planner megakernel, one block per problem (see module doc)."""
    global LAUNCHES, PC_WORK
    _check(spec, envs, ctl, nodes0, settings)
    ls = launch_shape(spec, envs, settings, shape)
    B, G1, _ = nodes0.shape
    d, M, P = spec.dimension, settings.max_samples, settings.max_path
    dev = ctl.device
    ip, fp = params(spec, settings, G1, B)
    nodes = torch.empty((B, M, d + 4), dtype=torch.float32, device=dev)
    path = torch.empty((B, P, d), dtype=torch.float32, device=dev)
    scal = torch.empty((B, SCALARS), dtype=torch.int32, device=dev)
    work = torch.empty((B, WORK + len(PHASES)), dtype=torch.int64, device=dev)
    if B == 0:
        return path, scal, work
    lib = library()
    env, robot, _keep = fkcc_cuda.table_args(spec, envs, dev)
    info = (ctypes.c_int * 3)()
    err = lib.rrtc_mega_launch(
        *env, *robot, ip.ctypes.data, fp.ctypes.data, ctl.data_ptr(), nodes0.data_ptr(),
        nodes.data_ptr(), path.data_ptr(), scal.data_ptr(), work.data_ptr(),
        ls["threads"], ls["group"], fkcc_cuda.MAX_SMEM - _STATIC_SMEM, info,
        build.stream_handle(dev),
    )
    if err == -1:
        raise ValueError(f"rrtc_mega: launch shape {ls} refused by the kernel")
    if err != 0:
        raise RuntimeError(f"rrtc_mega kernel launch failed with CUDA error {err}")
    if info[0] != ls["smem_bytes"]:
        raise RuntimeError(f"rrtc_mega: the kernel's layout takes {info[0]} bytes, "
                           f"smem_floats mirrors {ls['smem_bytes']}")
    LAUNCHES += 1
    if envs.pck is not None:
        PC_WORK = fkcc_cuda.tally_pc_work(PC_WORK, work[:, 2:5])
    LAST_LAUNCH.update(threads=ls["threads"], group=ls["group"], smem_bytes=info[0],
                       blocks_per_sm=info[1], warps_per_sm=info[1] * ls["threads"] // 32,
                       registers=info[2])
    return path, scal, work


# FP32 operations per node-sample pair of the nearest-neighbour scans
# (d products, d - 1 sums, then + norm, 2x, -, compare), counted from
# csrc/rrtc_mega.cu.
def ops_per_pair(d: int) -> int:
    return 2 * d + 3
