"""The fused FK + collision kernel for Hopper: build, binding, plain version.

Port of `vamp_mvt_tpu/ops/kernels/fkcc_pallas.py` (`_run`, its entry points
`fkcc_pallas_batched` / `fkcc_pallas_batched_lanes`) for the primitive,
self-collision, attachment, pointcloud and heightfield branches.  The kernel is `csrc/fkcc.cu` (its
FK + collision code is `csrc/fkcc_device.cuh`, which the megakernels share),
CUDA C++ for sm_90a, built by `ops/kernels/build.py` into `build/` at first
use and bound with ctypes.

  fkcc_batched(spec, envs, q)          q (B, N, d)  -> (B, N) bool
  fkcc_batched_lanes(spec, envs, q_d)  q_d (B, d, N) -> (B, N) bool
  fkcc_vmin(spec, envs, q)             q (B, N, d)  -> (B, N) float32 vmin

`envs` tables are (B, n, f), or (1, n, f) to share one environment across
the batch (the heightfield tables `hf_meta` (B, Nh, 10) and `hf_data`
(B, Nh, C) too); an attachment's leaves are (B, ...) or (1, ...) on their
own; a pointcloud comes as `envs.pck` (collision/pc_kernel.py), the
kernel's form (an MVT or CAPT structure alone is refused on the card:
`supports` is false, and `planning/validate.py::fkcc_valid` takes the plain
version there).  With a pointcloud the kernel's vmin is sign-exact, not
value-exact: it stops at the first negative value and writes -1 for a
certain hit; each launch on a pointcloud adds its work to `PC_WORK`.  G
lanes check a configuration together, so the counters count what the group
did: the spheres gated G at a time (a group gates all G before it acts on a
certain hit among them), and the chunk bounds and points of each round of G
chunks that any lane of the group reached before one lane found a negative
value; at G = 1 they equal the per-configuration counts of a serial scan.

The launch shape, T threads a block and G lanes of a warp a configuration,
comes from `fkcc_shape` (a pure function of the robot, the tables' sizes and
B x N); each entry point takes `shape=(T, G)` or `(None, G)` to override it,
and `LAST_LAUNCH` records the last launch's shape and occupancy.  A CUDA
tensor launches the kernel; a CPU tensor takes the plain version
(`fkcc_batched_plain` / `fkcc_vmin_plain`).  There is no fallback: a failed
build, load or launch raises.
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision import pc_kernel
from vamp_mvt_tpu_torch.collision.environment import TABLES, Environment
from vamp_mvt_tpu_torch.ops import fkcc as fkcc_ops
from vamp_mvt_tpu_torch.ops import smat
from vamp_mvt_tpu_torch.ops.kernels import build
from vamp_mvt_tpu_torch.robots.spec import PRISMATIC, REVOLUTE, RobotSpec

# Shared memory one block may use on an H100 (227 KB).  fkcc's launch shape
# comes from fkcc_shape, the megakernels' from choose_shape (both below).
MAX_SMEM = 232448

# Kernel launches made by this process; callers reset it to 0 around a run.
LAUNCHES = 0
# Pointcloud work of the launches on pointcloud tables since a caller last
# set it to None: (3,) int64 on the card (spheres gated, chunk bounds tested,
# points evaluated).
PC_WORK = None
# The last launch's threads a block, lanes a configuration (group),
# configurations a block, dynamic shared memory (bytes), the blocks and warps
# the card keeps resident on one SM, the kernel's registers a thread, and
# the blocks and waves over the card's SMs.
LAST_LAUNCH: dict = {}
_LIB = None
_SHAPES: dict = {}
# The packed table arguments of the last few Environments launched on
# (_table_pack), most recent last, each with the Environment it describes.
_PACKS: OrderedDict = OrderedDict()
_PACK_ENTRIES = 8
_TABLES: dict = {}
_HOST_TABLES: dict = {}


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


def library() -> ctypes.CDLL:
    """Build (see ops/kernels/build.py) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = build.library("fkcc")
        L = ctypes.POINTER(ctypes.c_longlong)
        # the table arguments (ENV_ARGTYPES then ROBOT_ARGTYPES, as 64-bit
        # integers), the call's (_CALL), the launch info out
        lib.fkcc_launch.argtypes = [L, L, ctypes.POINTER(ctypes.c_int)]
        lib.fkcc_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Robot tables
# ---------------------------------------------------------------------------


def robot_tables(spec: RobotSpec) -> dict[str, np.ndarray]:
    """Host tables the kernel walks instead of code generated per robot.

    frame_i (F, 6) int32: parent, joint type, q index, shared-memory slot
      (frames that parent a non-adjacent frame; -1 otherwise) and the
      [begin, end) range of the frame's spheres in `sphere_order`.
    frame_f (F, 42) float32: origin rotation (9), origin xyz (3), axis (3) and
      the Rodrigues coefficients A, I - A, K (9 each, smat.axis_rotation).
    sphere_order (S,) int32: sphere indices grouped by frame.
    sphere_f (S, 4) float32: local centre and radius.
    pairs (P, 2) int32 and pair_thr (P,) float32 = (r_i + r_j)^2.
    sphere_pc (S, 4) float32: radius, radius class, chit_ok, gate_ok for the
      pointcloud branch (pc_kernel.sphere_table).
    ee_frame: the frame whose pose carries an attachment's payload spheres.
    att_check (Sc,) int32: the robot spheres a payload is checked against.
    """
    F = len(spec.frames)
    frame_i = np.zeros((F, 6), np.int32)
    frame_f = np.zeros((F, 42), np.float32)
    order = np.argsort(spec.sphere_frame, kind="stable").astype(np.int32)
    counts = np.bincount(spec.sphere_frame, minlength=F)
    ends = np.cumsum(counts)
    slots = 0
    for k, f in enumerate(spec.frames):
        needs_slot = any(
            g.parent == k and gi != k + 1 for gi, g in enumerate(spec.frames)
        )
        frame_i[k] = (
            f.parent, f.joint_type, f.q_index, slots if needs_slot else -1,
            ends[k] - counts[k], ends[k],
        )
        slots += int(needs_slot)
        A, IA, K = smat.axis_rotation_terms(f.axis)
        frame_f[k] = np.concatenate([
            np.asarray(f.origin_rot, np.float64).reshape(-1),
            np.asarray(f.origin_xyz, np.float64), np.asarray(f.axis, np.float64),
            A.reshape(-1), IA.reshape(-1), K.reshape(-1),
        ])
    sphere_f = np.concatenate(
        [spec.sphere_local, spec.sphere_radius[:, None]], axis=1
    ).astype(np.float32)
    return dict(
        frame_i=frame_i, frame_f=frame_f, n_slots=slots, sphere_order=order,
        sphere_f=sphere_f,
        pairs=np.ascontiguousarray(spec.self_collision_pairs, np.int32).reshape(-1, 2),
        pair_thr=fkcc_ops.pair_thresholds(spec),
        sphere_pc=pc_kernel.sphere_table(spec.sphere_radius),
        ee_frame=int(spec.ee_frame),
        att_check=np.ascontiguousarray(spec.attachment_check_spheres, np.int32).reshape(-1),
    )


def _host_tables(spec: RobotSpec) -> dict:
    key = id(spec)
    if key not in _HOST_TABLES:
        _HOST_TABLES[key] = (spec, robot_tables(spec))  # spec pins the id
    return _HOST_TABLES[key][1]


def _device_tables(spec: RobotSpec, device: torch.device) -> dict:
    key = (id(spec), str(device))
    if key not in _TABLES:
        _TABLES[key] = (spec, {
            k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
            for k, v in _host_tables(spec).items()
        })
    return _TABLES[key][1]


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


# the kernel's pointcloud tables: name, dtype, dims (leading batch dim first)
_PC_TABLES = (("bitmap", torch.int32, 3), ("chunks", torch.float32, 3),
              ("points", torch.float32, 3), ("meta", torch.float32, 3))


def supports(envs: Environment) -> bool:
    """Whether the kernels read every table of `envs`: the JAX package's rule
    (`fkcc_pallas.supports`).  An MVT or CAPT pointcloud without its kernel
    form (`envs.pck`) is read by the plain version only; the callers' dispatch
    (`planning/validate.py::fkcc_valid`) sends it there, on the tensors' own
    device, as the JAX package sends it to its XLA path."""
    return (envs.mvt is None and envs.capt is None) or envs.pck is not None


def _check_inputs(spec: RobotSpec, envs: Environment, q: torch.Tensor, B: int):
    if q.dtype != torch.float32:
        raise TypeError(f"fkcc: q must be float32, got {q.dtype}")
    for name in TABLES + ("hf_meta", "hf_data"):
        t = getattr(envs, name)
        if t.device != q.device:
            raise ValueError(f"fkcc: env.{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"fkcc: env.{name} must be float32 (B, n, f)")
        if t.shape[0] != envs.spheres.shape[0] or t.shape[0] not in (1, B):
            raise ValueError(f"fkcc: env.{name} batch {t.shape[0]} vs q batch {B}")
    nh = envs.hf_meta.shape[1]
    if envs.hf_meta.shape[2] != 10 or envs.hf_data.shape[1] != nh \
            or (nh and envs.hf_data.shape[2] == 0):
        raise ValueError("fkcc: env.hf_meta must be (B, Nh, 10) and env.hf_data (B, Nh, C > 0)")
    att = envs.attachment
    if att is not None:
        if not 0 <= spec.ee_frame < len(spec.frames):
            raise ValueError(f"fkcc: {spec.name} names no end-effector frame to attach to")
        ab, A = att.spheres.shape[0], att.spheres.shape[-2]
        for name, tail in (("tf_rot", (3, 3)), ("tf_pos", (3,)), ("spheres", (A, 4))):
            t = getattr(att, name)
            if t.device != q.device:
                raise ValueError(f"fkcc: env.attachment.{name} on {t.device}, q on {q.device}")
            if t.dtype != torch.float32 or tuple(t.shape) != (ab,) + tail or ab not in (1, B):
                raise ValueError(
                    f"fkcc: env.attachment.{name} must be float32 with a leading batch of 1 "
                    f"or {B} (spheres (B, A, 4)), got {tuple(t.shape)} {t.dtype}")
    if envs.pck is None:
        if not supports(envs):
            raise ValueError(
                "fkcc: the CUDA kernels read a pointcloud as env.pck (the kernel "
                "form, EnvironmentBuilder.add_kernel_pointcloud), not as MVT or CAPT")
        return
    pb = envs.pck.meta.shape[0]
    for name, dtype, dims in _PC_TABLES:
        t = getattr(envs.pck, name)
        if t.device != q.device:
            raise ValueError(f"fkcc: env.pck.{name} on {t.device}, q on {q.device}")
        if t.dtype != dtype or t.dim() != dims or t.shape[0] != pb or pb not in (1, B):
            raise ValueError(f"fkcc: env.pck.{name} must be {dtype} (B, n, f) with B = 1 "
                             f"or {B}, got {tuple(t.shape)} {t.dtype}")
    if envs.pck.bitmap.shape[1:] != (2 * pc_kernel.MAX_CLASSES * _rrows(envs.pck), 128) \
            or envs.pck.points.shape[1:] != (envs.pck.chunks.shape[1], 3 * pc_kernel.CS) \
            or envs.pck.chunks.shape[2] != 8 or envs.pck.meta.shape[1:] != (1, 8):
        raise ValueError("fkcc: env.pck does not have collision/pc_kernel.py's layout")


def _rrows(pck) -> int:
    return max(pck.bitmap.shape[1] // (2 * pc_kernel.MAX_CLASSES), 1)


# ctypes argument types of the shape, pointcloud, attachment and heightfield
# tables and of the robot tables, in the order every launcher of the port
# (fkcc, rrtc_mega, simplify_mega) takes them.
ENV_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
ROBOT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_int]


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def table_args(spec: RobotSpec, envs: Environment, device: torch.device):
    """Launch arguments of the shape tables (pointers, row counts, batched
    flag), of the pointcloud tables (pointers, bitmap rows of a class,
    chunks, batched flag; null pointers without a pointcloud), of the
    attachment (its payload rows, tf_rot @ xyz + tf_pos and radius, and
    their pointcloud sphere-table rows; count, batched flag), of the
    heightfields (meta, data, fields, cells a field, batched flag) and of the
    robot tables, plus the tensors they point into (keep them alive until the
    launch returns)."""
    env_t = [getattr(envs, n).contiguous() for n in TABLES]
    tabs = _device_tables(spec, device)
    env = [_ptr(t) for t in env_t] + [t.shape[1] for t in env_t] + [
        int(envs.spheres.shape[0] > 1)]
    if envs.pck is None:
        pc_t = []
        env += [None] * 4 + [0, 0, 0]
    else:
        pc_t = [getattr(envs.pck, n).contiguous() for n, _, _ in _PC_TABLES]
        env += [t.data_ptr() for t in pc_t] + [
            _rrows(envs.pck), pc_t[1].shape[1], int(pc_t[3].shape[0] > 1)]
    if envs.attachment is None:
        att_t = []
        env += [None, None, 0, 0]
    else:
        rows = fkcc_ops.attachment_rows(envs.attachment).contiguous()    # (B, A, 4)
        att_t = [rows, pc_kernel.attachment_table(rows[..., 3], spec.sphere_radius).contiguous()]
        env += [_ptr(t) for t in att_t] + [rows.shape[1], int(rows.shape[0] > 1)]
    hf_t = [envs.hf_meta.contiguous(), envs.hf_data.contiguous()]
    env += [_ptr(t) for t in hf_t] + [hf_t[0].shape[1], hf_t[1].shape[2],
                                      int(hf_t[0].shape[0] > 1)]
    robot = [
        _ptr(tabs["frame_i"]), _ptr(tabs["frame_f"]), len(spec.frames),
        tabs["n_slots"], _ptr(tabs["sphere_order"]), _ptr(tabs["sphere_f"]),
        spec.n_spheres, _ptr(tabs["pairs"]), _ptr(tabs["pair_thr"]),
        len(spec.self_collision_pairs), _ptr(tabs["sphere_pc"]),
        tabs["ee_frame"], _ptr(tabs["att_check"]), len(tabs["att_check"]),
    ]
    return env, robot, env_t + pc_t + att_t + hf_t


def tally_pc_work(total, work: torch.Tensor):
    """`total` (None or a (3,) int64 tensor on the card) plus the pointcloud
    work of one launch, `work` (B, 3): spheres gated, chunk bounds tested,
    points evaluated.  Summed on the card: no synchronisation."""
    w = work.sum(0)
    return w if total is None else total + w


# ---------------------------------------------------------------------------
# The megakernels' launch shape (threads a block T, lanes a configuration G)
# ---------------------------------------------------------------------------

# What one H100 SM holds (CUDA occupancy rules for sm_90): shared memory for
# its blocks, of which each block also takes 1 KB for the system, 64K
# registers, 2048 threads and 32 blocks.  All three kernels are built with
# __launch_bounds__(512, 1), so a thread has at most 128 registers.
SMS = 132
SM_SMEM = 233472
BLOCK_SMEM_RESERVED = 1024
SM_REGISTERS = 65536
SM_THREADS = 2048
SM_BLOCKS = 32
MEGA_MAX_REGISTERS = 128
MEGA_THREADS = (512, 256, 128, 64, 32)
MEGA_GROUPS = (1, 2, 4, 8, 16, 32)
# Lanes a configuration on pointcloud tables: the chunk scan of an undecided
# sphere, split across the group's lanes, takes most of an FK pass there.
MEGA_PC_MIN_GROUP = 8


def table_floats(spec: RobotSpec, envs: Environment, G: int) -> dict:
    """The shared-memory floats of a megakernel block that do not depend on
    its step lists, mirrored from csrc/fkcc_device.cuh: the problem's shape,
    heightfield-meta and payload rows (`env_floats`), the robot tables
    (`robot_floats`) and the FK scratch of one group of G lanes
    (`group_floats`, padded to 3 G modulo 32)."""
    rows = {n: getattr(envs, n).shape[1] for n in TABLES}
    A = 0 if envs.attachment is None else envs.attachment.spheres.shape[-2]
    nh = envs.hf_meta.shape[1]
    env = (rows["spheres"] * 4 + (rows["capsules"] + rows["z_capsules"]) * 8
           + (rows["cuboids"] + rows["z_cuboids"]) * 15 + nh * 10 + A * 8)
    F, S, P = len(spec.frames), spec.n_spheres, len(spec.self_collision_pairs)
    robot = F * (6 + 42) + S * 9 + P * 3 + len(spec.attachment_check_spheres)
    group = 3 * spec.dimension + 12 * F + 3 * (S + A)
    group += (3 * G - group) % 32
    return dict(env=env, robot=robot, group=group)


def blocks_per_sm(T: int, smem_bytes: int, static_bytes: int) -> int:
    """Blocks of T threads with this shared memory that one SM keeps
    resident, at the kernels' register cap."""
    by_smem = SM_SMEM // (smem_bytes + static_bytes + BLOCK_SMEM_RESERVED)
    by_regs = SM_REGISTERS // (MEGA_MAX_REGISTERS * T)
    return min(by_smem, by_regs, SM_THREADS // T, SM_BLOCKS)


def choose_shape(smem_bytes, static_bytes: int, max_smem: int, points: int,
                 min_group: int = 1, shape=None, cluster: int = 1) -> dict:
    """The launch shape of a megakernel: `smem_bytes(T, G)` is its dynamic
    shared memory, `points` the configurations a typical FK pass checks,
    `cluster` the blocks that share a problem's FK pass.
    Of the shapes (T in MEGA_THREADS, G in MEGA_GROUPS, G <= T) whose
    shared memory is at most `max_smem` (the card refuses a launch above a
    block's 227 KB, whatever `max_smem` says), take G at least `min_group`
    where one fits, then the most threads (a block runs one problem, and the
    slowest problem's latency sets the kernel's end), then the fewest rounds
    of cluster x T / G configurations for `points`, then the most lanes a
    configuration at that count (each lane's share of a check shrinks with
    G).  `shape` = (T, G) takes that shape
    instead, if it fits, and None for either the best of it.  Returns threads, group, smem_bytes, blocks_per_sm
    and warps_per_sm; raises ValueError when no shape fits."""
    cands = []
    for T in MEGA_THREADS:
        for G in MEGA_GROUPS:
            if G > T or (shape is not None and (shape[1] not in (None, G)
                                                or shape[0] not in (None, T))):
                continue
            nbytes = smem_bytes(T, G)
            if nbytes > max_smem:
                continue
            blocks = blocks_per_sm(T, nbytes, static_bytes)
            cands.append(dict(threads=T, group=G, smem_bytes=nbytes, blocks_per_sm=blocks,
                              warps_per_sm=blocks * T // 32))
    if not cands:
        raise ValueError("no launch shape fits" if shape is None
                         else f"launch shape {tuple(shape)} does not fit")
    return max(cands, key=lambda c: (c["group"] >= min_group, c["threads"],
                                     -points * c["group"] // (cluster * c["threads"]),
                                     c["group"]))


# ---------------------------------------------------------------------------
# fkcc's launch shape, sized to the launch's B x N
# ---------------------------------------------------------------------------

# Spheres and pairs a lane takes at a time (fkcc_device.cuh::kUnroll).
UNROLL = 4
# The largest block fkcc_shape picks, and on a pointcloud.  The kernel runs
# blocks of up to 512 threads (the override and the sweeps take them), but
# in bench/time_fkcc.py's sweep on the H100 no case ran fastest at 512: one
# block an SM leaves it idle while the block's last groups drain and the
# next block loads its tables, where two blocks of 256 overlap (700 x 1024
# primitives: 1.72 ms at (256, 4), 1.86 at (512, 4)).  A pointcloud's chunk
# scans end early or late by configuration, and its blocks of 128 came out
# 7% ahead of 256 (64 clouds x 1024: 2.16 ms at (128, 8), 2.31 at (256, 8)).
FKCC_MAX_PICK = 256
FKCC_PC_MAX_PICK = 128
# The fewest blocks fkcc_shape lets a launch run on, where it has that many
# configurations: one problem of 64 checked 16 blocks of 128 threads in
# 0.0207 ms, 8 blocks of 256 in 0.0219 (the same sweep).  A launch of fewer
# than 16 x FKCC_MIN_PER_BLOCK configurations keeps at least that many a
# block: an AOX segment check of 40 took 0.0198 ms on 20 blocks of 64
# threads, 0.0156 on 10 blocks of 128 and 0.0151 on 5 of 256 (a later sweep,
# H100 80GB HBM3, 700.00 W): a block's table copy outweighs its share there.
FKCC_MIN_BLOCKS = 16
FKCC_MIN_PER_BLOCK = 4
# The cost model of fkcc_shape, in SM cycles (see there), fitted to that
# sweep's device times over its fourteen cases (each case's pick within 5%
# of its fastest shape): a warp's cycles per operation
# of one lane while the SM has issue slots to spare, the warp instructions
# an SM issues a cycle once its warps contend, the contention's growth with
# log2(G) (a group's lanes read its one scratch at scattered addresses),
# and a thread's cycles per table float it copies into shared memory.
CYCLES_PER_OP = 3
ISSUE_PER_CYCLE = 6
CONTENTION_PER_LOG2_G = 0.1
CYCLES_PER_LOAD = 50


def fk_ops(spec: RobotSpec) -> int:
    """FP32 operations of one configuration's FK (all three rows of every
    frame's pose; sin and cos count as one operation each)."""
    fk = 0
    for f in spec.frames:
        if f.parent >= 0:
            fk += 45 + 18  # R = Rp @ C; t = Rp @ xyz + tp
        if f.joint_type == REVOLUTE:
            fk += 2 + 36 + 45  # sin, cos; Rodrigues; R @ Q
        elif f.joint_type == PRISMATIC:
            fk += 21
    return fk


def lane_ops(spec: RobotSpec, envs: Environment, G: int) -> int:
    """FP32 operations that one lane of a group of G does for one
    configuration in config_vmin_group (csrc/fkcc_device.cuh), with every
    row of the shape tables counted live (the chooser reads nothing back
    from the card): FK by rows (3 rows over min(G, 3) lanes), the spheres
    and pairs UNROLL at a time (a lane's last round padded to UNROLL), the
    payload checks and heightfields split by index, the min over the
    group.  The pointcloud branch depends on the data and is not counted."""
    A = 0 if envs.attachment is None else envs.attachment.spheres.shape[-2]
    nh = envs.hf_meta.shape[1]
    S, P, SA = spec.n_spheres, len(spec.self_collision_pairs), spec.n_spheres + A
    per_sphere = 18 + sum(OPS_PER_ROW[n] * getattr(envs, n).shape[1] for n in TABLES)
    rounds = lambda n: math.ceil(n / (G * UNROLL)) * UNROLL  # noqa: E731
    return (fk_ops(spec) * math.ceil(3 / G) // 3 + 2 * math.ceil(spec.dimension / G)
            + rounds(SA) * per_sphere + rounds(P) * OPS_PER_PAIR
            + math.ceil(A * len(spec.attachment_check_spheres) / G) * OPS_PER_ATT_CHECK
            + math.ceil(SA / G) * nh * OPS_PER_HF + int(math.log2(G)))


def _table_key(envs: Environment) -> tuple:
    return (tuple(getattr(envs, n).shape[1] for n in TABLES),
            None if envs.attachment is None else envs.attachment.spheres.shape[-2],
            envs.hf_meta.shape[1], envs.pck is not None)


def fkcc_shape(spec: RobotSpec, envs: Environment, B: int, N: int, shape=None) -> dict:
    """The fkcc kernel's launch shape for B problems of N configurations:
    T threads a block (MEGA_THREADS) and G lanes a configuration
    (MEGA_GROUPS), T / G configurations a block, one problem a block.

    Of the shapes of at most FKCC_MAX_PICK threads (FKCC_PC_MAX_PICK on a
    pointcloud) whose shared memory (the problem's rows, the robot tables
    and T / G group scratches: `table_floats`, mirrored from
    csrc/fkcc_device.cuh) fits MAX_SMEM and which hold no more
    configurations a block than N rounded up to a power of two and run at
    least min(FKCC_MIN_BLOCKS, B N / FKCC_MIN_PER_BLOCK) blocks, take G at least
    MEGA_PC_MIN_GROUP on a pointcloud where one fits, then the least
    estimated time, then the most blocks (more SMs), then the fewest lanes.
    The estimate, in SM cycles: waves x a lane's operations (`lane_ops`) x
    max(CYCLES_PER_OP, W / ISSUE_PER_CYCLE x (1 + CONTENTION_PER_LOG2_G x
    log2 G)) + the table floats a thread copies x CYCLES_PER_LOAD, where
    waves = the blocks over SMS x the blocks an SM keeps resident
    (`blocks_per_sm`) and W = the warps on a busy SM.  So a launch of a few
    configurations spreads each over many lanes (a lane's share of a check
    shrinks with G), and a large one keeps many configurations resident on
    few lanes each (a group's scratch is paid once; its idle FK lanes,
    padded rounds and scattered scratch reads grow with G).

    `shape` = (T, G) takes that shape instead, if it fits, and (None, G) the
    best T for that G.  Returns threads, group, configs_per_block,
    smem_bytes, blocks_per_sm, warps_per_sm, blocks and waves; raises
    ValueError when no shape fits."""
    key = (id(spec), _table_key(envs), B, N, None if shape is None else tuple(shape))
    hit = _SHAPES.get(key)
    if hit is not None:
        return dict(hit[1])
    min_group = MEGA_PC_MIN_GROUP if envs.pck is not None else 1
    pick = FKCC_PC_MAX_PICK if envs.pck is not None else FKCC_MAX_PICK
    cap = 1 << max(N - 1, 0).bit_length()  # N rounded up to a power of two
    min_blocks = min(FKCC_MIN_BLOCKS, -(-B * N // FKCC_MIN_PER_BLOCK))
    cands = []
    for G in MEGA_GROUPS:
        if shape is not None and G != shape[1]:
            continue
        tab = table_floats(spec, envs, G)
        ops = lane_ops(spec, envs, G)
        for T in MEGA_THREADS:
            per = T // G
            if G > T or (shape is None and (per > cap or T > pick)) or (
                    shape is not None and shape[0] not in (None, T)):
                continue
            nbytes = 4 * (tab["env"] + tab["robot"] + tab["group"] * per)
            if nbytes > MAX_SMEM:
                continue
            bps = blocks_per_sm(T, nbytes, 0)
            blocks = B * -(-N // per)
            if shape is None and blocks < min_blocks:
                continue
            waves = -(-blocks // (SMS * bps))
            busy = min(bps, -(-blocks // SMS)) * T // 32
            contend = busy / ISSUE_PER_CYCLE * (1 + CONTENTION_PER_LOG2_G * math.log2(G))
            est = (waves * ops * max(CYCLES_PER_OP, contend)
                   + (tab["env"] + tab["robot"]) / T * CYCLES_PER_LOAD)
            cands.append(dict(threads=T, group=G, configs_per_block=per, smem_bytes=nbytes,
                              blocks_per_sm=bps, warps_per_sm=bps * T // 32, blocks=blocks,
                              waves=waves, est_cycles=est))
    if not cands:
        raise ValueError("fkcc: no launch shape fits" if shape is None
                         else f"fkcc: launch shape {tuple(shape)} does not fit")
    best = min(cands, key=lambda c: (c["group"] < min_group, c["est_cycles"], -c["blocks"],
                                     c["group"]))
    if len(_SHAPES) > 4096:
        _SHAPES.clear()
    _SHAPES[key] = (spec, best)  # spec pins the id
    return dict(best)


def phase_split(work: torch.Tensor, first: int, names) -> dict:
    """The phase clocks of a megakernel launch, columns `first..` of its
    `work` (B, first + len(names)): each phase's cycles summed over the
    blocks, and its share of their total."""
    cyc = work[:, first:first + len(names)].sum(0).tolist()
    total = sum(cyc)
    return {"cycles": dict(zip(names, cyc)),
            "share": {n: (c / total if total else 0.0) for n, c in zip(names, cyc)}}


def _leaves(envs: Environment) -> list:
    out = [getattr(envs, n) for n in TABLES] + [envs.hf_meta, envs.hf_data]
    for part in (envs.attachment, envs.pck):
        if part is not None:
            out += list(part)
    return out


def _table_pack(spec: RobotSpec, envs: Environment, q: torch.Tensor, B: int):
    """fkcc_launch's table arguments for `envs` (`table_args`, as 64-bit
    integers) and the tensors they point into, after `_check_inputs`.  A
    launch on the same Environment object, device and batch, none of whose
    tensors has changed in place since, reuses them: the lockstep planner and
    the roadmap planners launch on one Environment hundreds of times, and
    deriving its payload rows costs more host time than the launch itself.
    The last _PACK_ENTRIES packs are kept, each holding its Environment;
    tables that table_args had to copy (not contiguous) are packed anew at
    every launch."""
    leaves = _leaves(envs)
    key = (id(envs), id(spec), q.device, B, tuple(t._version for t in leaves))
    pack = _PACKS.get(key)
    if pack is not None:
        _PACKS.move_to_end(key)
        return pack[1:]
    _check_inputs(spec, envs, q, B)
    env, robot, keep = table_args(spec, envs, q.device)
    vals = [0 if v is None else int(v) for v in env + robot]
    tab = (ctypes.c_longlong * len(vals))(*vals)
    if all(t.is_contiguous() for t in leaves):
        _PACKS[key] = (envs, tab, keep)  # envs pins the id, keep the derived tables
        while len(_PACKS) > _PACK_ENTRIES:
            _PACKS.popitem(last=False)
    return tab, keep


def _launch(spec, envs, q, q_strides, B, N, want_vmin, shape=None):
    global LAUNCHES, PC_WORK
    if not q.is_cuda:
        raise ValueError("fkcc kernel launch needs CUDA tensors")
    if q.dtype != torch.float32:
        raise TypeError(f"fkcc: q must be float32, got {q.dtype}")
    if B > 65535:
        raise ValueError(f"fkcc: batch {B} exceeds the grid's 65535 problems")
    tab, _keep = _table_pack(spec, envs, q, B)
    valid = torch.empty((B, N), dtype=torch.int8, device=q.device)
    vmin = torch.empty((B, N), dtype=torch.float32, device=q.device) if want_vmin else None
    has_pc = envs.pck is not None
    work = torch.zeros((B, 3), dtype=torch.int64, device=q.device) if has_pc else None
    if N == 0:
        return valid, vmin
    if has_pc and torch.cuda.is_current_stream_capturing():
        raise ValueError("fkcc: a launch on a pointcloud cannot be captured (PC_WORK)")
    ls = fkcc_shape(spec, envs, B, N, shape)
    lib = library()
    call = (ctypes.c_longlong * 14)(
        q.data_ptr(), *q_strides, B, N, spec.dimension, valid.data_ptr(), _ptr(vmin) or 0,
        _ptr(work) or 0, ls["threads"], ls["group"], MAX_SMEM, build.stream_handle(q.device))
    info = (ctypes.c_int * 3)()
    err = lib.fkcc_launch(tab, call, info)
    if err == -1:
        raise ValueError(f"fkcc: launch shape {ls} refused by the kernel")
    if err != 0:
        raise RuntimeError(f"fkcc kernel launch failed with CUDA error {err}")
    if info[0] != ls["smem_bytes"]:
        raise RuntimeError(f"fkcc: the kernel's layout takes {info[0]} bytes, "
                           f"table_floats mirrors {ls['smem_bytes']}")
    LAUNCHES += 1
    if has_pc:
        PC_WORK = tally_pc_work(PC_WORK, work)
    LAST_LAUNCH.update(threads=ls["threads"], group=ls["group"],
                       configs_per_block=ls["configs_per_block"], smem_bytes=info[0],
                       blocks_per_sm=info[1], warps_per_sm=info[1] * ls["threads"] // 32,
                       registers=info[2], blocks=ls["blocks"],
                       waves=-(-ls["blocks"] // (SMS * max(info[1], 1))))
    return valid, vmin


def capture(fn):
    """`fn`'s work captured as a CUDA graph on the current device: returns
    (graph, the fkcc launches inside it, the packed tables they read, which
    the graph's launches keep pointing into).  Capturing runs nothing, so
    LAUNCHES is left as it was; `replay` counts the graph's launches each
    time it runs them.  Tables on a pointcloud are refused: a launch there
    sums its work into PC_WORK on the host's side of the capture."""
    global LAUNCHES
    before = LAUNCHES
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
        launches = LAUNCHES - before
    finally:
        LAUNCHES = before
    return graph, launches, list(_PACKS.values())


def replay(captured) -> None:
    """Run a graph from `capture`; its fkcc launches count here."""
    global LAUNCHES
    graph, launches, _keep = captured
    graph.replay()
    LAUNCHES += launches


def _kernel(spec, envs, q, want_vmin, shape=None):
    """q (B, N, d) -> int8 validity (B, N) and optionally vmin."""
    q = q.contiguous()
    B, N, d = q.shape
    return _launch(spec, envs, q, (N * d, 1, d), B, N, want_vmin, shape)


def _kernel_lanes(spec, envs, q_d, want_vmin, shape=None):
    """q_d (B, d, N) -> int8 validity (B, N) and optionally vmin."""
    q_d = q_d.contiguous()
    B, d, N = q_d.shape
    return _launch(spec, envs, q_d, (d * N, N, 1), B, N, want_vmin, shape)


# ---------------------------------------------------------------------------
# Plain version (CPU tensors, and the check of the kernel on the card)
# ---------------------------------------------------------------------------

# elements of the largest (B, chunk, S, n) intermediate of the plain version
_PLAIN_ELEMS = 1 << 24


def fkcc_vmin_plain(spec: RobotSpec, envs: Environment, q: torch.Tensor) -> torch.Tensor:
    """q (B, N, d) -> (B, N) float32 vmin, chunked over configurations."""
    B, N, _ = q.shape
    width = max(
        [getattr(envs, n).shape[-2] for n in TABLES + ("hf_meta",)]
        + [len(spec.self_collision_pairs) // max(spec.n_spheres, 1), 1]
        + [3 * st.voxel_points.shape[-2] for st in (envs.mvt,) if st is not None]
        + [3 * st.aff_points.shape[-2] for st in (envs.capt,) if st is not None]
    )
    chunk = max(_PLAIN_ELEMS // (B * spec.n_spheres * width), 1)
    env4 = envs.map(lambda t: t.unsqueeze(1))  # (B, 1, n, f)
    parts = [
        fkcc_ops.fkcc_vmin(spec, env4, q[:, i : i + chunk])
        for i in range(0, N, chunk)
    ]
    return torch.cat(parts, dim=1) if parts else q.new_zeros((B, 0))


def fkcc_batched_plain(spec: RobotSpec, envs: Environment, q: torch.Tensor) -> torch.Tensor:
    return fkcc_vmin_plain(spec, envs, q) >= 0.0


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def fkcc_batched(spec: RobotSpec, envs: Environment, q: torch.Tensor,
                 shape=None) -> torch.Tensor:
    """q (B, ..., d) with per-problem envs -> (B, ...) bool validity."""
    B, inner = q.shape[0], q.shape[1:-1]
    qf = q.reshape(B, -1, spec.dimension)
    if qf.is_cuda:
        out = _kernel(spec, envs, qf, False, shape)[0].bool()
    else:
        out = fkcc_batched_plain(spec, envs, qf)
    return out.reshape((B,) + tuple(inner))


def fkcc_batched_lanes(spec: RobotSpec, envs: Environment, q_d: torch.Tensor,
                       shape=None) -> torch.Tensor:
    """Lanes layout: q_d (B, d, N) -> (B, N) bool validity."""
    if q_d.is_cuda:
        return _kernel_lanes(spec, envs, q_d, False, shape)[0].bool()
    return fkcc_batched_plain(spec, envs, q_d.transpose(1, 2))


def fkcc_vmin(spec: RobotSpec, envs: Environment, q: torch.Tensor,
              shape=None) -> torch.Tensor:
    """q (B, N, d) -> (B, N) float32 minimum signed value (valid iff >= 0;
    with a pointcloud the kernel's value is sign-exact only)."""
    if q.is_cuda:
        return _kernel(spec, envs, q, True, shape)[1]
    return fkcc_vmin_plain(spec, envs, q)


# ---------------------------------------------------------------------------
# Work count (the bound in chip_smoke.py)
# ---------------------------------------------------------------------------

# FP32 operations per robot sphere and live row of each table, and per pair,
# counted from csrc/fkcc_device.cuh (sin/cos count as one operation each).
OPS_PER_ROW = {"spheres": 12, "capsules": 29, "z_capsules": 19,
               "cuboids": 35, "z_cuboids": 26}
OPS_PER_PAIR = 10
# The attachment branch: posing a payload sphere (9 multiply, 9 add), and
# each payload sphere against each attachment-check sphere (3 subtract, 3
# multiply, 2 add, the radius sum, its square, subtract, min).  The
# heightfield branch, per sphere and field: 2 subtract, 2 multiply-add, 4
# clamps, 2 floors, 1 multiply-add and a conversion to the cell index, 1
# multiply-add of the height, 2 subtract, 1 min.
OPS_PER_POSE = 18
OPS_PER_ATT_CHECK = 12
OPS_PER_HF = 20
# The pointcloud branch (fkcc_device.cuh::pc_vmin): per sphere gated (3
# subtract, 3 multiply, 3 floor, 6 compare), per chunk bound tested (3
# subtract, 3 multiply, 2 add, 2 add, 1 multiply, 1 compare), per point
# evaluated (3 subtract, 3 multiply, 2 add, 1 subtract, 1 min).
OPS_PER_GATE = 15
OPS_PER_CHUNK = 12
OPS_PER_POINT = 10


def pc_ops(work) -> int:
    """FP32 operations of the pointcloud work counters (gates, chunks,
    points; any array whose last dim holds the three)."""
    w = np.asarray(work, np.int64).reshape(-1, 3).sum(0)
    return int(w[0] * OPS_PER_GATE + w[1] * OPS_PER_CHUNK + w[2] * OPS_PER_POINT)


def ops_per_config(spec: RobotSpec, live: dict[str, np.ndarray], n_attach=0,
                   n_heightfields: int = 0) -> np.ndarray:
    """FP32 operations of one configuration's FK + collision check
    (csrc/fkcc_device.cuh) in each problem, given each problem's live row
    counts (arrays of shape (B,)), its live payload spheres (an int, or an
    array of shape (B,)) and its heightfields (those outside the pointcloud
    branch); shared by all three kernels."""
    fk = fk_ops(spec) + 18 * spec.n_spheres + OPS_PER_PAIR * len(spec.self_collision_pairs) + 1
    fk += n_attach * (OPS_PER_POSE + OPS_PER_ATT_CHECK * len(spec.attachment_check_spheres))
    fk += (spec.n_spheres + n_attach) * n_heightfields * OPS_PER_HF
    return fk + sum(
        OPS_PER_ROW[n] * np.asarray(live[n], np.int64) for n in TABLES
    ) * (spec.n_spheres + n_attach)


def op_count(spec: RobotSpec, live: dict[str, np.ndarray], n_configs: int,
             n_attach=0, n_heightfields: int = 0) -> int:
    """FP32 operations the kernel does for `n_configs` configurations of each
    problem, given each problem's live row counts (arrays of shape (B,)),
    payload spheres and heightfields."""
    return int(n_configs * np.sum(ops_per_config(spec, live, n_attach, n_heightfields)))
