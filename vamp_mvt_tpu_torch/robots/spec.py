"""Robot specification: static kinematic + collision data.

The port's copy of `vamp_mvt_tpu/robots/spec.py`.  A robot is data: a
kinematic tree of frames plus per-link collision spheres, the
self-collision pair table and joint limits.  The registry's specs come from
the baked JSON (`robots/_specs.json`, see `registry.py`); `parse_urdf` reads
a spherized URDF into the same form.  Arrays stay numpy; FK and the
collision kernels turn them into tensors on the device that needs them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

# The self-collision tables extracted from the reference, a data file of the
# JAX package (read, never imported).
REFERENCE_DATA = (Path(__file__).resolve().parents[2] / "vamp_mvt_tpu" / "robots"
                  / "_reference_data.json")

FIXED = 0
REVOLUTE = 1
PRISMATIC = 2

_JOINT_TYPES = {
    "fixed": FIXED,
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
}


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """URDF convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return rz @ ry @ rx


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

    def scale(self, unit: np.ndarray) -> np.ndarray:
        """[0,1]^d -> joint space (reference robots/panda.hh:77)."""
        return unit * (self.limits_high - self.limits_low) + self.limits_low

    def descale(self, q: np.ndarray) -> np.ndarray:
        """Joint space -> [0,1]^d, the inverse of `scale`."""
        return (q - self.limits_low) / (self.limits_high - self.limits_low)


def _parse_floats(s: str | None, default: str = "0 0 0") -> np.ndarray:
    return np.array([float(x) for x in (s or default).split()])


def parse_urdf(
    path: str | Path,
    name: str,
    resolution: int,
    end_effector: str,
    self_collision_pairs: np.ndarray | None = None,
    joint_order: list[str] | None = None,
    attachment_check_spheres=None,
) -> RobotSpec:
    """Parse a spherized URDF into a RobotSpec.

    Actuated joints are numbered in `joint_order` if given, else document order.
    Collision <sphere> elements become collision spheres in document order
    (links in document order, spheres within a link in document order) — this
    matches the reference generator's ordering, verified against the golden
    tables in tests/test_fk_golden.py.
    """
    root = ET.parse(str(path)).getroot()

    links: dict[str, list[tuple[np.ndarray, float]]] = {}
    link_doc_order: list[str] = []
    for link in root.findall("link"):
        lname = link.get("name")
        link_doc_order.append(lname)
        spheres = []
        for col in link.findall("collision"):
            geom = col.find("geometry")
            sph = geom.find("sphere") if geom is not None else None
            if sph is None:
                continue
            origin = col.find("origin")
            xyz = _parse_floats(origin.get("xyz") if origin is not None else None)
            spheres.append((xyz, float(sph.get("radius"))))
        links[lname] = spheres

    joints = []
    children = set()
    for joint in root.findall("joint"):
        jtype = joint.get("type")
        if jtype not in _JOINT_TYPES:
            raise ValueError(f"unsupported joint type {jtype}")
        origin = joint.find("origin")
        xyz = _parse_floats(origin.get("xyz") if origin is not None else None)
        rpy = _parse_floats(origin.get("rpy") if origin is not None else None)
        axis = _parse_floats(
            joint.find("axis").get("xyz") if joint.find("axis") is not None else None,
            "1 0 0",
        )
        limit = joint.find("limit")
        lo = float(limit.get("lower", "0")) if limit is not None else 0.0
        hi = float(limit.get("upper", "0")) if limit is not None else 0.0
        joints.append(
            dict(
                name=joint.get("name"),
                type=_JOINT_TYPES[jtype],
                parent=joint.find("parent").get("link"),
                child=joint.find("child").get("link"),
                xyz=xyz,
                rot=rpy_matrix(*rpy),
                axis=axis,
                low=lo,
                high=hi,
            )
        )
        children.add(joint.find("child").get("link"))

    root_links = [l for l in link_doc_order if l not in children]
    if len(root_links) != 1:
        raise ValueError(f"expected one root link, got {root_links}")

    # Configuration indices for actuated joints.
    actuated = [j for j in joints if j["type"] != FIXED]
    if joint_order is not None:
        by_name = {j["name"]: j for j in actuated}
        actuated = [by_name[n] for n in joint_order]
    q_index = {j["name"]: i for i, j in enumerate(actuated)}

    # Build frames in topological order (BFS from root, in joint document order).
    frames: list[Frame] = [
        Frame(
            name=root_links[0],
            parent=-1,
            joint_type=FIXED,
            q_index=-1,
            origin_rot=np.eye(3),
            origin_xyz=np.zeros(3),
            axis=np.zeros(3),
        )
    ]
    frame_index = {root_links[0]: 0}
    pending = list(joints)
    while pending:
        progressed = False
        rest = []
        for j in pending:
            if j["parent"] in frame_index:
                frames.append(
                    Frame(
                        name=j["child"],
                        parent=frame_index[j["parent"]],
                        joint_type=j["type"],
                        q_index=q_index.get(j["name"], -1),
                        origin_rot=j["rot"],
                        origin_xyz=j["xyz"],
                        axis=j["axis"],
                    )
                )
                frame_index[j["child"]] = len(frames) - 1
                progressed = True
            else:
                rest.append(j)
        pending = rest
        if not progressed:
            raise ValueError(f"disconnected joints: {[j['name'] for j in pending]}")

    # Spheres: link document order.
    sphere_frame, sphere_local, sphere_radius = [], [], []
    for lname in link_doc_order:
        if lname not in frame_index:
            continue
        for xyz, r in links.get(lname, []):
            sphere_frame.append(frame_index[lname])
            sphere_local.append(xyz)
            sphere_radius.append(r)

    lows = np.array([j["low"] for j in actuated], dtype=np.float32)
    highs = np.array([j["high"] for j in actuated], dtype=np.float32)

    pairs = (
        np.zeros((0, 2), dtype=np.int32)
        if self_collision_pairs is None
        else np.asarray(self_collision_pairs, dtype=np.int32)
    )

    acs = (
        np.arange(len(sphere_radius), dtype=np.int32)
        if attachment_check_spheres is None
        else np.asarray(attachment_check_spheres, dtype=np.int32)
    )
    return RobotSpec(
        name=name,
        dimension=len(actuated),
        resolution=resolution,
        frames=tuple(frames),
        sphere_frame=np.array(sphere_frame, dtype=np.int32),
        sphere_local=np.array(sphere_local, dtype=np.float32),
        sphere_radius=np.array(sphere_radius, dtype=np.float32),
        limits_low=lows,
        limits_high=highs,
        self_collision_pairs=pairs,
        attachment_check_spheres=acs,
        joint_names=tuple(j["name"] for j in actuated),
        end_effector=end_effector,
        ee_frame=frame_index.get(end_effector, len(frames) - 1),
    )


def load_reference_data() -> dict:
    """Self-collision pairs / radii tables extracted from the reference."""
    with open(REFERENCE_DATA) as f:
        return json.load(f)
