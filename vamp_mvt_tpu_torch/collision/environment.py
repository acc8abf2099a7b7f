"""Environment of collision primitives as dense struct-of-arrays tensors.

Port of `vamp_mvt_tpu/collision/environment.py` (primitives and
heightfield tables; pointclouds and attachments are not ported yet).  Row
layouts match the JAX package and the reference exactly:

  sphere:  (x, y, z, r)                                        4 floats
  capsule: (x1, y1, z1, xv, yv, zv, r, rdv), rdv = 1/|v|^2     8 floats
  cuboid:  (center(3), axis_1(3), axis_2(3), axis_3(3), half_extents(3)) 15

Z-aligned capsules/cuboids are routed to their own tables.  Tables are padded
with inert rows whose first coordinate is 1e8; the live rows always form a
prefix (the fused kernel scans only that prefix, counting rows with
|x0| < 1e7), and every builder here checks that.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

# Inert padding: far away, zero radius -> distances are huge positive.
_FAR = 1.0e8
# A row is live iff |x0| is below this (the kernel's live-count rule).
LIVE_LIMIT = 1.0e7

TABLES = ("spheres", "capsules", "z_capsules", "cuboids", "z_cuboids")


class Environment(NamedTuple):
    """Dense SoA environment; every tensor may carry leading batch dims."""

    spheres: torch.Tensor      # (..., Ns, 4)
    capsules: torch.Tensor     # (..., Nc, 8)
    z_capsules: torch.Tensor   # (..., Nzc, 8)
    cuboids: torch.Tensor      # (..., Nb, 15)
    z_cuboids: torch.Tensor    # (..., Nzb, 15)
    hf_meta: torch.Tensor      # (..., Nh, 10)
    hf_data: torch.Tensor      # (..., Nh, max_cells)

    def map(self, fn) -> "Environment":
        """Apply `fn` to every tensor (indexing, device moves, broadcasts)."""
        return Environment(*(fn(t) for t in self))

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

    def build(
        self,
        n_spheres: int | None = None,
        n_capsules: int | None = None,
        n_z_capsules: int | None = None,
        n_cuboids: int | None = None,
        n_z_cuboids: int | None = None,
        device=None,
    ) -> Environment:
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
            hf_meta=torch.zeros((0, 10), dtype=torch.float32, device=device),
            hf_data=torch.zeros((0, 0), dtype=torch.float32, device=device),
        )


def empty_environment(device=None) -> Environment:
    return EnvironmentBuilder().build(device=device)


def stack_environments(envs: list[Environment]) -> Environment:
    """Stack same-capacity environments into a batched Environment."""
    return Environment(*(torch.stack(ts) for ts in zip(*envs)))


def broadcast_environment(env: Environment, batch: int) -> Environment:
    """Give an unbatched environment a leading batch dimension (a view)."""
    return env.map(lambda t: t.unsqueeze(0).expand((batch,) + tuple(t.shape)))
