"""Environment of collision primitives as dense struct-of-arrays tensors.

Port of `vamp_mvt_tpu/collision/environment.py`: primitive and heightfield
tables, the pointcloud structures (MVT, CAPT and the kernel-resident form)
and the end-effector attachment.  Row layouts match the JAX package and the
reference exactly:

  sphere:  (x, y, z, r)                                        4 floats
  capsule: (x1, y1, z1, xv, yv, zv, r, rdv), rdv = 1/|v|^2     8 floats
  cuboid:  (center(3), axis_1(3), axis_2(3), axis_3(3), half_extents(3)) 15
  heightfield meta: (x, y, z, 1/sx, 1/sy, 1/sz, xd, yd, xd2, yd2)       10
  heightfield data: the grid's heights row-major, zero-padded to the
                    table's width

Z-aligned capsules/cuboids are routed to their own tables.  Tables are padded
with inert rows whose first coordinate is 1e8; the live rows always form a
prefix (the fused kernel scans only that prefix, counting rows with
|x0| < 1e7), and every builder here checks that.

A pointcloud rides along as `mvt` (collision/mvt.py), `capt`
(collision/capt.py) and `pck` (collision/pc_kernel.py, the form the CUDA
kernels read): named tuples of tensors with the same leading batch dims as
the tables, or None.  So does `attachment`: payload spheres carried by the
end effector (`Attachment`: tf_rot (..., 3, 3), tf_pos (..., 3), spheres
(..., A, 4)), or None.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.capt import CAPTData, build_capt
from vamp_mvt_tpu_torch.collision.mvt import MVTData, build_mvt
from vamp_mvt_tpu_torch.collision.pc_kernel import CS, PCKernelData, build_pc_kernel

# Inert padding: far away, zero radius -> distances are huge positive.
_FAR = 1.0e8
# A row is live iff |x0| is below this (the kernel's live-count rule).
LIVE_LIMIT = 1.0e7

TABLES = ("spheres", "capsules", "z_capsules", "cuboids", "z_cuboids")
POINTCLOUDS = ("mvt", "capt", "pck")


def tree_map(fn, x):
    """Apply `fn` to every array or tensor of a (nested) tuple; None stays."""
    if x is None:
        return None
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    return type(x)(*(tree_map(fn, v) for v in x))


class Attachment(NamedTuple):
    """End-effector payload: spheres in an EE-relative frame (reference
    collision/attachments.hh:12-57).  Arrays, or tensors in an Environment
    with its leading batch dims."""

    tf_rot: object   # (..., 3, 3) attachment frame rotation (EE-relative)
    tf_pos: object   # (..., 3)
    spheres: object  # (..., A, 4) x, y, z, r in the attachment frame


def make_attachment(spheres, tf_rot=None, tf_pos=None) -> Attachment:
    """An Attachment of float32 arrays (JAX ops/fkcc.py::make_attachment)."""
    return Attachment(
        tf_rot=np.asarray(np.eye(3) if tf_rot is None else tf_rot, np.float32).reshape(3, 3),
        tf_pos=np.asarray(np.zeros(3) if tf_pos is None else tf_pos, np.float32).reshape(3),
        spheres=np.asarray(spheres, np.float32).reshape(-1, 4),
    )


class Environment(NamedTuple):
    """Dense SoA environment; every tensor may carry leading batch dims."""

    spheres: torch.Tensor      # (..., Ns, 4)
    capsules: torch.Tensor     # (..., Nc, 8)
    z_capsules: torch.Tensor   # (..., Nzc, 8)
    cuboids: torch.Tensor      # (..., Nb, 15)
    z_cuboids: torch.Tensor    # (..., Nzb, 15)
    hf_meta: torch.Tensor      # (..., Nh, 10)
    hf_data: torch.Tensor      # (..., Nh, max_cells)
    mvt: MVTData | None = None
    capt: CAPTData | None = None
    pck: PCKernelData | None = None
    attachment: Attachment | None = None

    def map(self, fn) -> "Environment":
        """Apply `fn` to every tensor (indexing, device moves, broadcasts)."""
        return Environment(*(tree_map(fn, t) for t in self))

    def to(self, device) -> "Environment":
        return self.map(lambda t: t.to(device))

    @property
    def device(self) -> torch.device:
        return self.spheres.device


# ---------------------------------------------------------------------------
# Host-side builders (numpy; mirror reference factory.hh semantics)
# ---------------------------------------------------------------------------


def _euler_xyz_matrix(rho: float, theta: float, phi: float) -> np.ndarray:
    """Reference factory.hh:37-40: R = Rz(phi) Ry(theta) Rx(rho)."""
    cr, sr = math.cos(rho), math.sin(rho)
    cp, sp = math.cos(theta), math.sin(theta)
    cy, sy = math.cos(phi), math.sin(phi)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return rz @ ry @ rx


def make_sphere(center, radius) -> np.ndarray:
    return np.array([*center, radius], dtype=np.float32)


def make_cuboid(center, euler_xyz, half_extents) -> np.ndarray:
    """Cuboid from center + Euler XYZ + half extents (factory.hh:26-60)."""
    R = _euler_xyz_matrix(*euler_xyz)
    return np.array(
        [*center, *R[:, 0], *R[:, 1], *R[:, 2], *half_extents], dtype=np.float32
    )


def make_capsule_endpoints(p1, p2, radius) -> np.ndarray:
    """Capsule/cylinder from endpoints (factory.hh cylinder::endpoints)."""
    p1 = np.asarray(p1, dtype=np.float64)
    v = np.asarray(p2, dtype=np.float64) - p1
    rdv = 1.0 / float(v @ v)
    return np.array([*p1, *v, radius, rdv], dtype=np.float32)


def make_capsule_center(center, euler_xyz, radius, length) -> np.ndarray:
    """Capsule from center + Euler XYZ + radius + length."""
    R = _euler_xyz_matrix(*euler_xyz)
    c = np.asarray(center, dtype=np.float64)
    half = R @ np.array([0.0, 0.0, length / 2.0])
    return make_capsule_endpoints(c + half, c - half, radius)


def make_heightfield(center, scale, grid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Heightfield meta and data (reference shapes.hh:249-312,
    factory.hh:364-385).  grid: (H, W) row-major heights; scale = (sx, sy,
    sz) world units per cell (and per height unit for z).  The meta keeps
    the reciprocal scales, as the reference factory does, and halves the
    grid's width and height as integers (shapes.hh:289)."""
    h, w = grid.shape
    sx, sy, sz = scale
    meta = np.array(
        [center[0], center[1], center[2], 1.0 / sx, 1.0 / sy, 1.0 / sz,
         float(w), float(h), float(w // 2), float(h // 2)],
        dtype=np.float32,
    )
    return meta, grid.astype(np.float32).reshape(-1)


_INERT = {
    "spheres": np.array([_FAR, _FAR, _FAR, 0.0], dtype=np.float32),
    "capsules": np.array([_FAR, _FAR, _FAR, 0.0, 0.0, 1.0, 0.0, 1.0], dtype=np.float32),
    "cuboids": np.array(
        [_FAR, _FAR, _FAR, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0], dtype=np.float32
    ),
}


def check_live_prefix(name: str, rows: np.ndarray) -> None:
    """Raise unless the live rows of every (…, n, f) table form a prefix.

    The fused kernel counts rows with |x0| < 1e7 and scans only that many
    leading rows, so a live row after an inert one would never be checked.
    """
    rows = np.asarray(rows)
    if rows.shape[-2] == 0:
        return
    live = np.abs(rows[..., 0]) < LIVE_LIMIT
    count = live.sum(axis=-1, keepdims=True)
    prefix = np.arange(rows.shape[-2]) < count
    if not np.array_equal(live, prefix):
        raise ValueError(
            f"{name}: live rows do not form a prefix (an inert 1e8 row "
            "precedes a live one); the kernel's live count would skip it"
        )


@dataclasses.dataclass
class EnvironmentBuilder:
    """Accumulates shapes host-side, emits a padded dense Environment."""

    spheres: list = dataclasses.field(default_factory=list)
    capsules: list = dataclasses.field(default_factory=list)
    z_capsules: list = dataclasses.field(default_factory=list)
    cuboids: list = dataclasses.field(default_factory=list)
    z_cuboids: list = dataclasses.field(default_factory=list)
    mvt: MVTData | None = None
    capt: CAPTData | None = None
    pck: PCKernelData | None = None
    heightfields: list = dataclasses.field(default_factory=list)
    attachment: Attachment | None = None

    def add_sphere(self, center, radius):
        self.spheres.append(make_sphere(center, radius))
        return self

    def add_capsule(self, arr: np.ndarray):
        # z-aligned iff xv == yv == 0 (reference bindings/environment.cc:138)
        if arr[3] == 0.0 and arr[4] == 0.0:
            self.z_capsules.append(arr)
        else:
            self.capsules.append(arr)
        return self

    def add_cuboid(self, arr: np.ndarray):
        # z-aligned iff axis_3_z == 1 (reference bindings/environment.cc:124)
        if arr[11] == 1.0:
            self.z_cuboids.append(arr)
        else:
            self.cuboids.append(arr)
        return self

    def add_heightfield(self, meta: np.ndarray, data: np.ndarray):
        self.heightfields.append((np.asarray(meta, np.float32), np.asarray(data, np.float32)))
        return self

    def attach(self, attachment: Attachment):
        """Carry payload spheres on the end effector (reference Environment
        attachments, collision/attachments.hh:12-57)."""
        self.attachment = attachment
        return self

    def add_mvt_pointcloud(self, points, r_min: float, r_max: float, workspace_min,
                           workspace_max, r_point: float, **pad) -> int:
        """Build and attach an MVT structure; returns the build time in ns
        (reference bindings/environment.cc:164-177).  `pad`: build_mvt's
        pad_voxels / pad_capacity."""
        t0 = time.perf_counter_ns()
        self.mvt = build_mvt(points, r_min, r_max, workspace_min, workspace_max, r_point, **pad)
        return time.perf_counter_ns() - t0

    def add_capt_pointcloud(self, points, r_min: float, r_max: float, r_point: float,
                            use_native: bool = True, **pad) -> int:
        """Build and attach a CAPT structure; returns the build time in ns
        (reference bindings/environment.cc:152-163).  `pad`: build_capt's
        pad_leaves / pad_capacity."""
        t0 = time.perf_counter_ns()
        self.capt = build_capt(points, r_min, r_max, r_point, use_native=use_native, **pad)
        return time.perf_counter_ns() - t0

    def add_kernel_pointcloud(self, points, class_radii, workspace_min, workspace_max,
                              r_point: float, max_radius: float, pad_chunks: int | None = None,
                              use_native: bool = True) -> int:
        """Build and attach the kernel-resident structure
        (collision/pc_kernel.py), padded to `pad_chunks` chunks; returns the
        build time in ns."""
        t0 = time.perf_counter_ns()
        self.pck = build_pc_kernel(points, class_radii, workspace_min, workspace_max,
                                   r_point, max_radius, pad_chunks=pad_chunks,
                                   use_native=use_native)
        return time.perf_counter_ns() - t0

    def build(
        self,
        n_spheres: int | None = None,
        n_capsules: int | None = None,
        n_z_capsules: int | None = None,
        n_cuboids: int | None = None,
        n_z_cuboids: int | None = None,
        n_heightfields: int | None = None,
        hf_cells: int | None = None,
        device=None,
    ) -> Environment:
        """The padded tables on `device`.  Heightfields pad to
        `n_heightfields` fields of `hf_cells` cells; an inert field lies far
        below (z = -1e8) on a 1 x 1 grid, so it never collides."""
        def pad(name, rows, cap, inert):
            cap = len(rows) if cap is None else cap
            cap = max(cap, len(rows))
            out = np.tile(inert, (max(cap, 1), 1))
            if not cap:
                out = out[:0]
            for i, r in enumerate(rows):
                out[i] = r
            check_live_prefix(name, out)
            return torch.as_tensor(out, device=device)

        nh = len(self.heightfields) if n_heightfields is None else n_heightfields
        cells = hf_cells
        if cells is None:
            cells = max((d.size for _, d in self.heightfields), default=0)
        if nh < len(self.heightfields) or any(d.size > cells for _, d in self.heightfields):
            raise ValueError("build: n_heightfields / hf_cells below what was added")
        hf_meta = np.zeros((nh, 10), dtype=np.float32)
        hf_meta[:, 2] = -_FAR
        hf_meta[:, 6] = 1.0
        hf_meta[:, 7] = 1.0
        hf_data = np.zeros((nh, max(cells, 1) if nh else 0), dtype=np.float32)
        for i, (m, d) in enumerate(self.heightfields):
            hf_meta[i] = m
            hf_data[i, : d.size] = d

        return Environment(
            spheres=pad("spheres", self.spheres, n_spheres, _INERT["spheres"]),
            capsules=pad("capsules", self.capsules, n_capsules, _INERT["capsules"]),
            z_capsules=pad(
                "z_capsules", self.z_capsules, n_z_capsules, _INERT["capsules"]
            ),
            cuboids=pad("cuboids", self.cuboids, n_cuboids, _INERT["cuboids"]),
            z_cuboids=pad(
                "z_cuboids", self.z_cuboids, n_z_cuboids, _INERT["cuboids"]
            ),
            hf_meta=torch.as_tensor(hf_meta, device=device),
            hf_data=torch.as_tensor(hf_data, device=device),
            **{name: tree_map(lambda a: torch.as_tensor(a, device=device), getattr(self, name))
               for name in POINTCLOUDS + ("attachment",)},
        )


def empty_environment(device=None) -> Environment:
    return EnvironmentBuilder().build(device=device)


def _pad_to(t: torch.Tensor, shape, fill) -> torch.Tensor:
    """t padded at the end of every dim to `shape` with `fill`."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = torch.full(tuple(shape), fill, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _pad_pointclouds(envs: list[Environment]) -> list[Environment]:
    """Pad each problem's pointcloud structures to the batch's largest, the
    way the JAX package pads them for a batch (mbm.py:930-950 for the
    kernel form; build_mvt / build_capt pad_* arguments for the others):
    pck chunks to the most chunks (far bounds, far points; meta keeps each
    problem's live count), MVT voxels and capacity (+inf points, empty
    boxes), CAPT leaves and capacity (+inf).  Raise where a batch cannot be
    one array: another voxel grid (W) or another CAPT depth."""
    out = list(envs)
    for name in POINTCLOUDS:
        present = [getattr(e, name) is not None for e in envs]
        if not any(present):
            continue
        if not all(present):
            raise ValueError(f"stack_environments: some problems lack env.{name}")
        sts = [getattr(e, name) for e in envs]
        if name == "pck":
            if len({tuple(s.bitmap.shape) for s in sts}) > 1:
                raise ValueError("stack_environments: pointclouds of another voxel grid (W)")
            n = max(s.chunks.shape[0] for s in sts)
            sts = [s._replace(chunks=_pad_chunks(s.chunks, n),
                              points=_pad_to(s.points, (n, 3 * CS), _FAR)) for s in sts]
        elif name == "mvt":
            if len({tuple(s.grid.shape) for s in sts}) > 1:
                raise ValueError("stack_environments: MVTs of another voxel grid (W)")
            nv = max(s.voxel_points.shape[0] for s in sts)
            c = max(s.voxel_points.shape[1] for s in sts)
            lo, hi = np.finfo(np.float32).max, np.finfo(np.float32).min
            sts = [s._replace(
                voxel_points=_pad_to(s.voxel_points, (nv, c, 3), math.inf),
                voxel_count=_pad_to(s.voxel_count, (nv,), 0),
                voxel_aabb=torch.cat([
                    _pad_to(s.voxel_aabb[:, :3], (nv, 3), lo),
                    _pad_to(s.voxel_aabb[:, 3:], (nv, 3), hi)], 1)) for s in sts]
        else:
            if len({tuple(s.tests.shape) for s in sts}) > 1:
                raise ValueError("stack_environments: CAPT trees of another depth")
            nl = max(s.leaf_aabb.shape[0] for s in sts)
            c = max(s.aff_points.shape[1] for s in sts)
            sts = [s._replace(
                leaf_aabb=_pad_to(s.leaf_aabb, (nl, 6), math.inf),
                aff_points=_pad_to(s.aff_points, (nl, c, 3), math.inf),
                aff_count=_pad_to(s.aff_count, (nl,), 0)) for s in sts]
        out = [e._replace(**{name: st}) for e, st in zip(out, sts)]
    return out


def _pad_chunks(chunks: torch.Tensor, n: int) -> torch.Tensor:
    """Chunk bounds padded to n rows: far centres, radius 0."""
    if chunks.shape[0] == n:
        return chunks
    pad = torch.zeros((n - chunks.shape[0], 8), dtype=chunks.dtype, device=chunks.device)
    pad[:, :3] = _FAR
    return torch.cat([chunks, pad])


def _check_attachments(envs: list[Environment]) -> None:
    """Raise unless every problem of a batch carries an attachment of the
    same number of spheres, or none does."""
    atts = [e.attachment for e in envs]
    if all(a is None for a in atts):
        return
    if any(a is None for a in atts):
        raise ValueError("stack_environments: some problems lack an attachment")
    if len({tuple(a.spheres.shape) for a in atts}) > 1:
        raise ValueError("stack_environments: attachments of another sphere count (A)")


def stack_environments(envs: list[Environment]) -> Environment:
    """Stack environments of the same table capacities into a batched
    Environment; pointcloud structures are padded to the batch's largest.
    Attachments must have the same sphere count across the batch."""
    _check_attachments(envs)
    envs = _pad_pointclouds(envs)

    def stack(*xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return type(xs[0])(*(stack(*ys) for ys in zip(*xs)))

    return Environment(*(stack(*fields) for fields in zip(*envs)))


def broadcast_environment(env: Environment, batch: int) -> Environment:
    """Give an unbatched environment a leading batch dimension (a view)."""
    return env.map(lambda t: t.unsqueeze(0).expand((batch,) + tuple(t.shape)))
