"""The fused FK + collision kernel for Hopper: build, binding, plain version.

Port of `vamp_mvt_tpu/ops/kernels/fkcc_pallas.py` (`_run`, its entry points
`fkcc_pallas_batched` / `fkcc_pallas_batched_lanes`) for the primitive and
self-collision branches.  The kernel is `csrc/fkcc.cu`, CUDA C++ for sm_90a,
compiled with nvcc into `build/` at first use (keyed by a hash of the source
and flags) and bound with ctypes.

  fkcc_batched(spec, envs, q)          q (B, N, d)  -> (B, N) bool
  fkcc_batched_lanes(spec, envs, q_d)  q_d (B, d, N) -> (B, N) bool
  fkcc_vmin(spec, envs, q)             q (B, N, d)  -> (B, N) float32 vmin

`envs` tables are (B, n, f), or (1, n, f) to share one environment across
the batch.  A CUDA tensor launches the kernel; a CPU tensor takes the plain
version (`fkcc_batched_plain` / `fkcc_vmin_plain`).  There is no fallback:
a failed build, load or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import TABLES, Environment
from vamp_mvt_tpu_torch.ops import fkcc as fkcc_ops
from vamp_mvt_tpu_torch.ops import smat
from vamp_mvt_tpu_torch.robots.spec import PRISMATIC, REVOLUTE, RobotSpec

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fkcc.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# Shared memory one block may use on an H100 (227 KB).
MAX_SMEM = 232448
THREADS = (128, 64, 32)

# Kernel launches made by this process; callers reset it to 0 around a run.
LAUNCHES = 0
# What the last build reported: seconds, whether the library came from the
# cache, and nvcc's output (registers and shared memory per kernel).
BUILD_INFO: dict = {}

_LIB = None
_LIB_LOCK = threading.Lock()
_TABLES: dict = {}
_HOST_TABLES: dict = {}


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fkcc kernel cannot be built")


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.perf_counter()
        src = SOURCE.read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"fkcc_{key}.so"
        cached = so.exists()
        log = ""
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, check=False,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {SOURCE}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fkcc_launch.argtypes = [
            P, P, P, P, P, I, I, I, I, I, I,      # env tables, rows, batched
            P, L, L, L, I, I,                     # q, strides, B, N
            P, P, I, I,                           # frame tables, F, slots
            P, P, I, P, P, I,                     # spheres, S, pairs, P
            P, P,                                 # outputs
            I, I, P,                              # threads, smem, stream
        ]
        lib.fkcc_launch.restype = ctypes.c_int
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0, cached=cached, log=log, path=str(so)
        )
        _LIB = lib
        return lib


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


def smem_bytes(spec: RobotSpec, rows: dict[str, int], threads: int) -> int:
    """Dynamic shared memory of one block: the problem's shape rows, the
    stored frame poses and every sphere centre of every thread."""
    n_slots = _host_tables(spec)["n_slots"]
    env = (rows["spheres"] * 4 + (rows["capsules"] + rows["z_capsules"]) * 8
           + (rows["cuboids"] + rows["z_cuboids"]) * 15)
    return 4 * (env + (n_slots * 12 + spec.n_spheres * 3) * threads)


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def _check_inputs(spec: RobotSpec, envs: Environment, q: torch.Tensor, B: int):
    fkcc_ops.check_supported(envs)
    if q.dtype != torch.float32:
        raise TypeError(f"fkcc: q must be float32, got {q.dtype}")
    for name in TABLES:
        t = getattr(envs, name)
        if t.device != q.device:
            raise ValueError(f"fkcc: env.{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"fkcc: env.{name} must be float32 (B, n, f)")
        if t.shape[0] != envs.spheres.shape[0] or t.shape[0] not in (1, B):
            raise ValueError(f"fkcc: env.{name} batch {t.shape[0]} vs q batch {B}")


def _launch(spec, envs, q, q_strides, B, N, want_vmin):
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError("fkcc kernel launch needs CUDA tensors")
    _check_inputs(spec, envs, q, B)
    if B > 65535:
        raise ValueError(f"fkcc: batch {B} exceeds the grid's 65535 problems")
    tabs = _device_tables(spec, q.device)
    env_t = [getattr(envs, n).contiguous() for n in TABLES]
    env_batched = int(envs.spheres.shape[0] > 1)
    rows = {n: t.shape[1] for n, t in zip(TABLES, env_t)}
    threads = next(
        (T for T in THREADS if smem_bytes(spec, rows, T) <= MAX_SMEM), None
    )
    if threads is None:
        raise ValueError(
            f"fkcc: {spec.name} with rows {rows} needs "
            f"{smem_bytes(spec, rows, THREADS[-1])} bytes of shared memory "
            f"at {THREADS[-1]} threads, above the {MAX_SMEM} a block may use"
        )
    valid = torch.empty((B, N), dtype=torch.int8, device=q.device)
    vmin = torch.empty((B, N), dtype=torch.float32, device=q.device) if want_vmin else None
    if N == 0:
        return valid, vmin
    lib = library()
    ptr = lambda t: t.data_ptr() if t is not None and t.numel() else None
    err = lib.fkcc_launch(
        *[ptr(t) for t in env_t], *[rows[n] for n in TABLES], env_batched,
        q.data_ptr(), *q_strides, B, N,
        ptr(tabs["frame_i"]), ptr(tabs["frame_f"]), len(spec.frames),
        tabs["n_slots"], ptr(tabs["sphere_order"]), ptr(tabs["sphere_f"]),
        spec.n_spheres, ptr(tabs["pairs"]), ptr(tabs["pair_thr"]),
        len(spec.self_collision_pairs), valid.data_ptr(), ptr(vmin),
        threads, smem_bytes(spec, rows, threads),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fkcc kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return valid, vmin


def _kernel(spec, envs, q, want_vmin):
    """q (B, N, d) -> int8 validity (B, N) and optionally vmin."""
    q = q.contiguous()
    B, N, d = q.shape
    return _launch(spec, envs, q, (N * d, 1, d), B, N, want_vmin)


def _kernel_lanes(spec, envs, q_d, want_vmin):
    """q_d (B, d, N) -> int8 validity (B, N) and optionally vmin."""
    q_d = q_d.contiguous()
    B, d, N = q_d.shape
    return _launch(spec, envs, q_d, (d * N, N, 1), B, N, want_vmin)


# ---------------------------------------------------------------------------
# Plain version (CPU tensors, and the check of the kernel on the card)
# ---------------------------------------------------------------------------

# elements of the largest (B, chunk, S, n) intermediate of the plain version
_PLAIN_ELEMS = 1 << 24


def fkcc_vmin_plain(spec: RobotSpec, envs: Environment, q: torch.Tensor) -> torch.Tensor:
    """q (B, N, d) -> (B, N) float32 vmin, chunked over configurations."""
    B, N, _ = q.shape
    width = max(
        [getattr(envs, n).shape[-2] for n in TABLES]
        + [len(spec.self_collision_pairs) // max(spec.n_spheres, 1), 1]
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


def fkcc_batched(spec: RobotSpec, envs: Environment, q: torch.Tensor) -> torch.Tensor:
    """q (B, ..., d) with per-problem envs -> (B, ...) bool validity."""
    B, inner = q.shape[0], q.shape[1:-1]
    qf = q.reshape(B, -1, spec.dimension)
    if qf.is_cuda:
        out = _kernel(spec, envs, qf, False)[0].bool()
    else:
        out = fkcc_batched_plain(spec, envs, qf)
    return out.reshape((B,) + tuple(inner))


def fkcc_batched_lanes(spec: RobotSpec, envs: Environment, q_d: torch.Tensor) -> torch.Tensor:
    """Lanes layout: q_d (B, d, N) -> (B, N) bool validity."""
    if q_d.is_cuda:
        return _kernel_lanes(spec, envs, q_d, False)[0].bool()
    return fkcc_batched_plain(spec, envs, q_d.transpose(1, 2))


def fkcc_vmin(spec: RobotSpec, envs: Environment, q: torch.Tensor) -> torch.Tensor:
    """q (B, N, d) -> (B, N) float32 minimum signed value (valid iff >= 0)."""
    if q.is_cuda:
        return _kernel(spec, envs, q, True)[1]
    return fkcc_vmin_plain(spec, envs, q)


# ---------------------------------------------------------------------------
# Work count (the bound in chip_smoke.py)
# ---------------------------------------------------------------------------

# FP32 operations per robot sphere and live row of each table, and per pair,
# counted from csrc/fkcc.cu (sin/cos count as one operation each).
OPS_PER_ROW = {"spheres": 12, "capsules": 29, "z_capsules": 19,
               "cuboids": 35, "z_cuboids": 26}
OPS_PER_PAIR = 10


def op_count(spec: RobotSpec, live: dict[str, np.ndarray], n_configs: int) -> int:
    """FP32 operations the kernel does for `n_configs` configurations of each
    problem, given each problem's live row counts (arrays of shape (B,))."""
    fk = 0
    for f in spec.frames:
        if f.parent >= 0:
            fk += 45 + 18  # R = Rp @ C; t = Rp @ xyz + tp
        if f.joint_type == REVOLUTE:
            fk += 2 + 36 + 45  # sin, cos; Rodrigues; R @ Q
        elif f.joint_type == PRISMATIC:
            fk += 21
    fk += 18 * spec.n_spheres + OPS_PER_PAIR * len(spec.self_collision_pairs) + 1
    per_problem = sum(
        OPS_PER_ROW[n] * np.asarray(live[n], np.int64) for n in TABLES
    ) * spec.n_spheres
    return int(n_configs * (fk * len(per_problem) + int(np.sum(per_problem))))
