"""Robot specification: static kinematic + collision data.

The port's copy of `vamp_mvt_tpu/robots/spec.py` without URDF parsing: specs
come from the baked JSON (`robots/_specs.json`, see `registry.py`).  A robot
is data: a kinematic tree of frames plus per-link collision spheres, the
self-collision pair table and joint limits.  Arrays stay numpy; FK and the
collision kernels turn them into tensors on the device that needs them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FIXED = 0
REVOLUTE = 1
PRISMATIC = 2


@dataclasses.dataclass(frozen=True)
class Frame:
    """One joint/link frame in the kinematic tree (topological order)."""

    name: str  # child link name
    parent: int  # index of parent frame (-1 = world root)
    joint_type: int  # FIXED / REVOLUTE / PRISMATIC
    q_index: int  # index into the configuration vector, -1 for fixed
    origin_rot: np.ndarray  # (3, 3) constant rotation of the joint origin
    origin_xyz: np.ndarray  # (3,) constant translation of the joint origin
    axis: np.ndarray  # (3,) joint axis in the child frame


@dataclasses.dataclass(frozen=True, eq=False)
class RobotSpec:
    """Static robot data.  eq=False: identity hashing, so a spec can key
    per-robot caches (kernel tables, pair thresholds)."""

    name: str
    dimension: int
    resolution: int  # motion-validation density
    frames: tuple[Frame, ...]  # topological order, frames[i].parent < i
    sphere_frame: np.ndarray  # (S,) int — owning frame index per sphere
    sphere_local: np.ndarray  # (S, 3) float — center in the owning frame
    sphere_radius: np.ndarray  # (S,) float
    limits_low: np.ndarray  # (d,)
    limits_high: np.ndarray  # (d,)
    self_collision_pairs: np.ndarray  # (P, 2) int
    attachment_check_spheres: np.ndarray = None
    joint_names: tuple[str, ...] = ()
    end_effector: str = ""
    ee_frame: int = -1

    @property
    def n_spheres(self) -> int:
        return int(self.sphere_local.shape[0])

    @property
    def min_radius(self) -> float:
        return float(self.sphere_radius.min())

    @property
    def max_radius(self) -> float:
        return float(self.sphere_radius.max())

    def space_measure(self) -> float:
        return float(np.prod(self.limits_high - self.limits_low))
