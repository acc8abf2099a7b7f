"""Robot registry: baked specs for the reference's robot set.

Reads the port's own `robots/_specs.json`, a byte-for-byte copy of the JAX
package's file (a test holds the two equal).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from vamp_mvt_tpu_torch.robots.spec import FIXED, PRISMATIC, Frame, RobotSpec

_SPECS_PATH = Path(__file__).parent / "_specs.json"
_CACHE: dict[str, RobotSpec] = {}

ROBOTS = ("sphere", "ur5", "panda", "fetch", "baxter")

# Default RRT-Connect ranges per robot (reference src/vamp/constants.py:3-9).
RRT_RANGES = {"sphere": 1.0, "ur5": 1.5, "panda": 1.0, "fetch": 1.0, "baxter": 0.5}


def spec_to_dict(spec: RobotSpec) -> dict:
    """The JSON form `spec_from_dict` reads (robots/_specs.json's entries)."""
    return {
        "name": spec.name,
        "dimension": spec.dimension,
        "resolution": spec.resolution,
        "frames": [
            {
                "name": f.name,
                "parent": f.parent,
                "joint_type": f.joint_type,
                "q_index": f.q_index,
                "origin_rot": np.asarray(f.origin_rot).reshape(-1).tolist(),
                "origin_xyz": np.asarray(f.origin_xyz).tolist(),
                "axis": np.asarray(f.axis).tolist(),
            }
            for f in spec.frames
        ],
        "sphere_frame": spec.sphere_frame.tolist(),
        "sphere_local": spec.sphere_local.tolist(),
        "sphere_radius": spec.sphere_radius.tolist(),
        "limits_low": spec.limits_low.tolist(),
        "limits_high": spec.limits_high.tolist(),
        "self_collision_pairs": spec.self_collision_pairs.tolist(),
        "attachment_check_spheres": spec.attachment_check_spheres.tolist(),
        "joint_names": list(spec.joint_names),
        "end_effector": spec.end_effector,
        "ee_frame": spec.ee_frame,
    }


def spec_from_dict(d: dict) -> RobotSpec:
    return RobotSpec(
        name=d["name"],
        dimension=d["dimension"],
        resolution=d["resolution"],
        frames=tuple(
            Frame(
                name=f["name"],
                parent=f["parent"],
                joint_type=f["joint_type"],
                q_index=f["q_index"],
                origin_rot=np.array(f["origin_rot"], dtype=np.float64).reshape(3, 3),
                origin_xyz=np.array(f["origin_xyz"], dtype=np.float64),
                axis=np.array(f["axis"], dtype=np.float64),
            )
            for f in d["frames"]
        ),
        sphere_frame=np.array(d["sphere_frame"], dtype=np.int32),
        sphere_local=np.array(d["sphere_local"], dtype=np.float32).reshape(-1, 3),
        sphere_radius=np.array(d["sphere_radius"], dtype=np.float32),
        limits_low=np.array(d["limits_low"], dtype=np.float32),
        limits_high=np.array(d["limits_high"], dtype=np.float32),
        self_collision_pairs=np.array(
            d["self_collision_pairs"], dtype=np.int32
        ).reshape(-1, 2),
        attachment_check_spheres=np.array(
            d.get("attachment_check_spheres", list(range(len(d["sphere_radius"])))),
            dtype=np.int32,
        ),
        joint_names=tuple(d["joint_names"]),
        end_effector=d["end_effector"],
        ee_frame=d["ee_frame"],
    )


def sphere_spec(
    lows=(-10.0, -10.0, 0.0), highs=(10.0, 10.0, 5.0), radius: float = 0.2
) -> RobotSpec:
    """The R^3 point robot: three prismatic joints along x/y/z carrying one
    collision sphere, so it reuses the generic FK/collision path."""
    eye = np.eye(3)
    zero = np.zeros(3)
    axes = [np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])]
    frames = [Frame("world", -1, FIXED, -1, eye, zero, zero)]
    for i, ax in enumerate(axes):
        frames.append(Frame(f"axis_{'xyz'[i]}", i, PRISMATIC, i, eye, zero, ax))
    return RobotSpec(
        name="sphere",
        dimension=3,
        resolution=32,
        frames=tuple(frames),
        sphere_frame=np.array([3], dtype=np.int32),
        sphere_local=np.zeros((1, 3), dtype=np.float32),
        sphere_radius=np.array([radius], dtype=np.float32),
        limits_low=np.array(lows, dtype=np.float32),
        limits_high=np.array(highs, dtype=np.float32),
        self_collision_pairs=np.zeros((0, 2), dtype=np.int32),
        attachment_check_spheres=np.array([0], dtype=np.int32),
        joint_names=("x", "y", "z"),
        end_effector="axis_z",
        ee_frame=3,
    )


def load(name: str) -> RobotSpec:
    if name == "sphere":
        return sphere_spec()
    if name not in _CACHE:
        with open(_SPECS_PATH) as f:
            specs = json.load(f)
        if name not in specs:
            raise KeyError(f"unknown robot {name!r}; available: {list(specs)}")
        _CACHE[name] = spec_from_dict(specs[name])
    return _CACHE[name]
