"""The path-simplification megakernel for Hopper: binding and launch.

Port of the TPU kernel `vamp_mvt_tpu/planning/simplify_mega.py::_run` (body
`_make_kernel`).  The kernel is `csrc/simplify_mega.cu`, CUDA C++ for sm_90a,
built by `ops/kernels/build.py`; its host side and plain version are in
`planning/simplify_mega.py`.

  simplify(spec, envs, paths, lengths, settings, shape=None)
      paths (B, P, d) float32, lengths (B,) int32, CUDA tensors
      -> path (B, P, d) float32 padded with its last vertex,
         scal (B, 2) int32 (length, driver iterations),
         work (B, 8) int64 (configurations checked, the pointcloud's
         spheres gated, chunk bounds tested and points evaluated, then the
         block's clock cycles in each phase, `PHASES`)

A failed build or launch raises.  The launch shape (T threads a block, G
lanes a configuration) comes from `launch_shape`, mirroring the kernel's
shared-memory `Layout`; `shape=(T, G)` overrides it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.ops.kernels import build, fkcc_cuda
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.robots.spec import RobotSpec

_STATIC_SMEM = 1024
WORK = 4
# the FK + collision passes of the straight-line check, SHORTCUT and BSPLINE,
# and the bookkeeping between passes, whose cycles follow the work counters
PHASES = ("straight", "shortcut", "bspline", "bookkeeping")

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
        lib = build.library("simplify_mega")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.simplify_mega_launch.argtypes = [
            *fkcc_cuda.ENV_ARGTYPES, *fkcc_cuda.ROBOT_ARGTYPES,
            P, P,                    # integer and float parameters (host)
            P, P,                    # paths, lengths
            P, P, P,                 # path, scalars, work counters
            I, I,                    # threads a block, lanes a configuration
            I, P, P,                 # max shared memory, launch info, stream
        ]
        lib.simplify_mega_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def params(spec: RobotSpec, s, P: int, B: int) -> tuple[np.ndarray, np.ndarray]:
    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    ip = np.array([spec.dimension, P, B, s.max_iterations, s.bspline_max_steps,
                   validate_mod.n_points_bound(spec, span)], np.int32)
    fp = np.array([s.bspline_midpoint_interpolation, s.bspline_min_change,
                   spec.resolution / validate_mod.RAKE], np.float32)
    return ip, fp


def smem_floats(spec: RobotSpec, envs: Environment, P: int, T: int, G: int) -> int:
    """Floats of dynamic shared memory a block of T threads with G lanes a
    configuration takes for paths of P rows: csrc/simplify_mega.cu's
    Layout."""
    d = spec.dimension
    tab = fkcc_cuda.table_floats(spec, envs, G)
    return (tab["env"] + tab["robot"] + tab["group"] * (T // G)
            + 4 * P * d                         # path and its three copies
            + 2 * (2 * P) * d + 3 * (2 * P) + 1  # segment starts, vectors, n, offsets, flags
            + 2 * P + 2 * ((P + 31) // 32))      # keep, acc and their ballot words


def launch_shape(spec: RobotSpec, envs: Environment, P: int, shape=None) -> dict:
    """The kernel's launch shape for this robot, these tables and paths of P
    rows (fkcc_cuda.choose_shape, at least MEGA_PC_MIN_GROUP lanes a
    configuration on a pointcloud); `shape` = (T, G) overrides it.  A
    typical pass checks a few segments of 64 points."""
    return fkcc_cuda.choose_shape(lambda T, G: 4 * smem_floats(spec, envs, P, T, G),
                                  _STATIC_SMEM, fkcc_cuda.MAX_SMEM - _STATIC_SMEM, 256,
                                  fkcc_cuda.MEGA_PC_MIN_GROUP if envs.pck is not None else 1,
                                  shape)


def simplify(spec: RobotSpec, envs: Environment, paths: torch.Tensor,
             lengths: torch.Tensor, settings, shape=None):
    """Launch the simplify megakernel, one block per path (see module doc)."""
    global LAUNCHES, PC_WORK
    if not (paths.is_cuda and lengths.is_cuda):
        raise ValueError("simplify_mega kernel launch needs CUDA tensors")
    if paths.dtype != torch.float32 or lengths.dtype != torch.int32:
        raise TypeError("simplify_mega: paths must be float32 and lengths int32")
    if paths.dim() != 3 or paths.shape[2] != spec.dimension \
            or lengths.shape != (paths.shape[0],):
        raise ValueError(
            f"simplify_mega: paths {tuple(paths.shape)} must be (B, P, "
            f"{spec.dimension}) and lengths {tuple(lengths.shape)} (B,)")
    if not (paths.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("simplify_mega: paths and lengths must be contiguous")
    B, P, d = paths.shape
    fkcc_cuda._check_inputs(spec, envs, paths, B)
    dev = paths.device
    out = torch.empty_like(paths)
    scal = torch.empty((B, 2), dtype=torch.int32, device=dev)
    work = torch.empty((B, WORK + len(PHASES)), dtype=torch.int64, device=dev)
    if B == 0:
        return out, scal, work
    ls = launch_shape(spec, envs, P, shape)
    ip, fp = params(spec, settings, P, B)
    lib = library()
    env, robot, _keep = fkcc_cuda.table_args(spec, envs, dev)
    info = (ctypes.c_int * 3)()
    err = lib.simplify_mega_launch(
        *env, *robot, ip.ctypes.data, fp.ctypes.data, paths.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), scal.data_ptr(), work.data_ptr(),
        ls["threads"], ls["group"], fkcc_cuda.MAX_SMEM - _STATIC_SMEM, info,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == -1:
        raise ValueError(f"simplify_mega: launch shape {ls} refused by the kernel")
    if err != 0:
        raise RuntimeError(f"simplify_mega kernel launch failed with CUDA error {err}")
    if info[0] != ls["smem_bytes"]:
        raise RuntimeError(f"simplify_mega: the kernel's layout takes {info[0]} bytes, "
                           f"smem_floats mirrors {ls['smem_bytes']}")
    LAUNCHES += 1
    if envs.pck is not None:
        PC_WORK = fkcc_cuda.tally_pc_work(PC_WORK, work[:, 1:4])
    LAST_LAUNCH.update(threads=ls["threads"], group=ls["group"], smem_bytes=info[0],
                       blocks_per_sm=info[1], warps_per_sm=info[1] * ls["threads"] // 32,
                       registers=info[2])
    return out, scal, work
