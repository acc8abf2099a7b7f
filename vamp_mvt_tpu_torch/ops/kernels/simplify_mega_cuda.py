"""The path-simplification megakernel for Hopper: binding and launch.

Port of the TPU kernel `vamp_mvt_tpu/planning/simplify_mega.py::_run` (body
`_make_kernel`).  The kernel is `csrc/simplify_mega.cu`, CUDA C++ for sm_90a,
built by `ops/kernels/build.py`; its host side and plain version are in
`planning/simplify_mega.py`.

  simplify(spec, envs, paths, lengths, settings)
      paths (B, P, d) float32, lengths (B,) int32, CUDA tensors
      -> path (B, P, d) float32 padded with its last vertex,
         scal (B, 2) int32 (length, driver iterations),
         work (B, 4) int64 (configurations checked, and the pointcloud's
         spheres gated, chunk bounds tested and points evaluated)

A failed build or launch raises.
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

# Kernel launches made by this process; callers reset it to 0 around a run.
LAUNCHES = 0
# Pointcloud work of the launches on pointcloud tables since a caller last
# set it to None: (3,) int64 on the card (spheres gated, chunk bounds tested,
# points evaluated).
PC_WORK = None
# The last launch's threads a block, dynamic shared memory (bytes) and the
# blocks the card keeps resident on one SM.
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


def simplify(spec: RobotSpec, envs: Environment, paths: torch.Tensor,
             lengths: torch.Tensor, settings):
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
    work = torch.empty((B, WORK), dtype=torch.int64, device=dev)
    if B == 0:
        return out, scal, work
    ip, fp = params(spec, settings, P, B)
    lib = library()
    env, robot, _keep = fkcc_cuda.table_args(spec, envs, dev)
    info = (ctypes.c_int * 3)()
    err = lib.simplify_mega_launch(
        *env, *robot, ip.ctypes.data, fp.ctypes.data, paths.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), scal.data_ptr(), work.data_ptr(),
        fkcc_cuda.MAX_SMEM - _STATIC_SMEM, info,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == -1:
        raise ValueError(f"simplify_mega: {spec.name} does not fit a block's shared memory")
    if err != 0:
        raise RuntimeError(f"simplify_mega kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    if envs.pck is not None:
        PC_WORK = fkcc_cuda.tally_pc_work(PC_WORK, work[:, 1:4])
    LAST_LAUNCH.update(threads=info[0], smem_bytes=info[1], blocks_per_sm=info[2])
    return out, scal, work
