"""User-facing API mirroring the reference's Python surface.

Port of `vamp_mvt_tpu/api.py`: per-robot modules (`panda.rrtc(...)`,
`panda.simplify(...)`), an `Environment` wrapper (`add_sphere`, `attach`,
`add_heightfield`, ...) and `png_to_heightfield`:

    import vamp_mvt_tpu_torch as vmt
    env = vmt.Environment()
    env.add_sphere(vmt.Sphere([0, 0, 0.5], 0.2))
    env.attach(vmt.Attachment(spheres=[[0, 0, 0.12, 0.06]]))
    result = vmt.panda.rrtc(start, goal, env)
    simple = vmt.panda.simplify(result.path, result.path_length, env)

Every method that touches tensors takes `device=None`, which means the GPU
(`device.resolve_device`): without one it raises unless given
`device="cpu"`.  On the GPU every collision check runs in the CUDA kernel
(`csrc/fkcc.cu`); `rrtc` plans with the lockstep planner (`planning/rrtc.py
::plan`), as the JAX API does, and its results are tensors on that device.
`prm`, `fcit` and `roadmap` keep their graphs on the host
(`planning/prm.py`, `planning/fcit.py`) and return numpy results, as the JAX
API's do; `aorrtc` refines with lockstep AOX searches on the device
(`planning/aorrtc.py::solve`).
"""

from __future__ import annotations

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.ops import fk as fk_mod
from vamp_mvt_tpu_torch.ops import fkcc as fkcc_mod
from vamp_mvt_tpu_torch.planning import aorrtc as aorrtc_mod
from vamp_mvt_tpu_torch.planning import fcit as fcit_mod
from vamp_mvt_tpu_torch.planning import prm as prm_mod
from vamp_mvt_tpu_torch.planning import rrtc as rrtc_mod
from vamp_mvt_tpu_torch.planning import simplify as simplify_mod
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.robots import registry

RRTCSettings = rrtc_mod.RRTCSettings
SimplifySettings = simplify_mod.SimplifySettings
PRMSettings = prm_mod.PRMSettings
PRMNeighborParams = prm_mod.PRMStarNeighborParams
FCITSettings = fcit_mod.FCITSettings
AORRTCSettings = aorrtc_mod.AORRTCSettings
Attachment = envmod.make_attachment


def Sphere(center, radius):
    return ("sphere", envmod.make_sphere(center, radius))


def Cuboid(center, euler_xyz, half_extents):
    return ("cuboid", envmod.make_cuboid(center, euler_xyz, half_extents))


def Cylinder(center, euler_xyz, radius, length):
    return ("capsule", envmod.make_capsule_center(center, euler_xyz, radius, length))


def Capsule(p1, p2, radius):
    return ("capsule", envmod.make_capsule_endpoints(p1, p2, radius))


class Environment:
    """Reference-style environment wrapper over EnvironmentBuilder; the
    built tables are kept per device until the next change."""

    def __init__(self):
        self._b = envmod.EnvironmentBuilder()
        self._built: dict = {}

    def _add(self, shape, kind, add):
        k, arr = shape
        if k != kind:
            raise ValueError(f"expected a {kind}, got a {k}")
        add(arr)
        self._built.clear()

    def add_sphere(self, shape):
        self._add(shape, "sphere", lambda a: self._b.add_sphere(a[:3], a[3]))

    def add_cuboid(self, shape):
        self._add(shape, "cuboid", self._b.add_cuboid)

    def add_capsule(self, shape):
        self._add(shape, "capsule", self._b.add_capsule)

    def add_heightfield(self, meta, data):
        self._b.add_heightfield(meta, data)
        self._built.clear()

    def add_mvt_pointcloud(self, points, r_min, r_max, ws_min, ws_max, r_point):
        ns = self._b.add_mvt_pointcloud(points, r_min, r_max, ws_min, ws_max, r_point)
        self._built.clear()
        return ns

    def add_capt_pointcloud(self, points, r_min, r_max, r_point):
        ns = self._b.add_capt_pointcloud(points, r_min, r_max, r_point)
        self._built.clear()
        return ns

    def attach(self, attachment):
        self._b.attach(attachment)
        self._built.clear()

    def build(self, device=None) -> envmod.Environment:
        dev = resolve_device(device)
        if dev not in self._built:
            self._built[dev] = self._b.build(device=dev)
        return self._built[dev]


def _as_env(env, dev: torch.device) -> envmod.Environment:
    if isinstance(env, Environment):
        return env.build(dev)
    if isinstance(env, envmod.EnvironmentBuilder):
        return env.build(device=dev)
    return env.to(dev)


class Halton:
    """Reference-style sampler handle: reset/skip map to sample offsets
    (bindings/robot_helper.hh:360-379)."""

    def __init__(self):
        self.offset = 0

    def reset(self):
        self.offset = 0

    def skip(self, n: int):
        self.offset += int(n)


class RobotModule:
    """Per-robot namespace (reference bindings/robot_helper.hh:325-597)."""

    def __init__(self, name: str):
        self.name = name
        self._spec = None

    @property
    def spec(self):
        if self._spec is None:
            self._spec = registry.load(self.name)
        return self._spec

    # --- info -----------------------------------------------------------
    def dimension(self):
        return self.spec.dimension

    def resolution(self):
        return self.spec.resolution

    def n_spheres(self):
        return self.spec.n_spheres

    def space_measure(self):
        return self.spec.space_measure()

    def joint_names(self):
        return list(self.spec.joint_names)

    def min_max_radii(self):
        return self.spec.min_radius, self.spec.max_radius

    def halton(self):
        return Halton()

    def _q(self, config, dev) -> torch.Tensor:
        return torch.as_tensor(np.asarray(config, np.float32), device=dev)

    # --- kinematics -----------------------------------------------------
    def fk(self, config, device=None):
        """Collision spheres at a configuration: (S, 4) x, y, z, r."""
        dev = resolve_device(device)
        centers = fk_mod.sphere_positions(self.spec, self._q(config, dev)[None])[0]
        return np.concatenate([centers.cpu().numpy(), self.spec.sphere_radius[:, None]], axis=1)

    def eefk(self, config, device=None):
        """End-effector pose: (R (3, 3), t (3,))."""
        dev = resolve_device(device)
        R, t = fk_mod.eefk(self.spec, self._q(config, dev)[None])
        return R[0].cpu().numpy(), t[0].cpu().numpy()

    # --- validation -----------------------------------------------------
    def validate(self, config, env, check_bounds: bool = False, device=None):
        """Configuration validity: self and environment collision (the
        attachment included), optionally joint limits (reference
        robot_helper.hh:255-267; check_bounds defaults to False there too)."""
        spec = self.spec
        q = np.asarray(config, np.float32)
        if check_bounds and ((q < spec.limits_low).any() or (q > spec.limits_high).any()):
            return False
        dev = resolve_device(device)
        return bool(fkcc_mod.fkcc(spec, _as_env(env, dev), self._q(q, dev)[None], dev)[0])

    def validate_motion(self, a, b, env, device=None):
        spec = self.spec
        dev = resolve_device(device)
        span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
        envs = _as_env(env, dev).map(lambda t: t[None])
        return bool(validate_mod.validate_motion(
            spec, envs, self._q(a, dev)[None], self._q(b, dev)[None],
            validate_mod.n_points_bound(spec, span))[0])

    def debug(self, config, env, device=None):
        """Colliding sphere indices against the environment, and colliding
        self pairs (the reference's fkcc_debug returns names; this returns
        indices)."""
        spec = self.spec
        dev = resolve_device(device)
        centers = fk_mod.sphere_positions(spec, self._q(config, dev)[None])
        radii = torch.as_tensor(spec.sphere_radius, device=dev)
        env_hit = (fkcc_mod.env_vmin(_as_env(env, dev), centers[:, :, None, :],
                                     radii[:, None]) < 0.0)[0].cpu().numpy()
        pairs = spec.self_collision_pairs
        c = centers[0].cpu().numpy()
        d2 = np.sum((c[pairs[:, 0]] - c[pairs[:, 1]]) ** 2, axis=1)
        rs = spec.sphere_radius[pairs[:, 0]] + spec.sphere_radius[pairs[:, 1]]
        return {
            "env_colliding_spheres": np.flatnonzero(env_hit).tolist(),
            "self_colliding_pairs": [tuple(map(int, p)) for p in pairs[d2 < rs * rs]],
        }

    def filter_self_from_pointcloud(self, points, config, env, point_radius=0.0025,
                                    device=None):
        """Drop points colliding with the robot at `config` or with the
        environment (reference robot_helper.hh:284-322)."""
        spec = self.spec
        dev = resolve_device(device)
        pts = torch.as_tensor(np.asarray(points, np.float32).reshape(-1, 3), device=dev)
        centers = fk_mod.sphere_positions(spec, self._q(config, dev)[None])[0]
        d2 = torch.sum((pts[:, None, :] - centers[None]) ** 2, dim=-1)
        rs = torch.as_tensor(spec.sphere_radius, device=dev)[None] + point_radius
        robot_hit = (d2 < rs * rs).any(dim=1)
        r = torch.full((pts.shape[0], 1), point_radius, dtype=torch.float32, device=dev)
        env_hit = fkcc_mod.env_collision(_as_env(env, dev), pts[:, None, :], r)
        return pts[~(robot_hit | env_hit)].cpu().numpy()

    # --- planners -------------------------------------------------------
    def _plan_args(self, start, goals, sampler):
        goals = np.asarray(goals, np.float32)
        if goals.ndim == 1:
            goals = goals[None]
        offset = sampler.offset if isinstance(sampler, Halton) else int(sampler or 0)
        return np.asarray(start, np.float32), goals, offset

    def default_rrtc_settings(self, **kw):
        kw.setdefault("range", registry.RRT_RANGES.get(self.name, 1.0))
        kw.setdefault("max_iterations", 4096)
        kw.setdefault("max_samples", 4096)
        kw.setdefault("max_path", 96)
        kw.setdefault("samples_per_step", 8)
        kw.setdefault("connect_segments", 4)
        return RRTCSettings(**kw)

    def rrtc(self, start, goals, env, settings=None, sampler=None, device=None):
        """RRT-Connect from `start` to any of `goals` ((d,) or (G, d)) with
        the lockstep planner; an RRTCResult of tensors on the device."""
        dev = resolve_device(device)
        start, goals, offset = self._plan_args(start, goals, sampler)
        return rrtc_mod.plan(
            self.spec, _as_env(env, dev), self._q(start, dev), self._q(goals, dev),
            torch.ones(goals.shape[0], dtype=torch.bool, device=dev),
            settings or self.default_rrtc_settings(), offset)

    def simplify(self, path, path_length, env, settings=None, sampler=None, device=None):
        """SHORTCUT + BSPLINE on a padded path (P, d) of `path_length`
        vertices; a SimplifyResult of tensors on the device."""
        dev = resolve_device(device)
        return simplify_mod.simplify(
            self.spec, _as_env(env, dev), torch.as_tensor(path, device=dev).to(torch.float32),
            torch.as_tensor(path_length, device=dev).to(torch.int32),
            settings or SimplifySettings())

    def prm(self, start, goals, env, settings=None, sampler=None, device=None):
        """PRM* from `start` to any of `goals`: a PRMResult (numpy)."""
        dev = resolve_device(device)
        start, goals, offset = self._plan_args(start, goals, sampler)
        return prm_mod.solve(self.spec, _as_env(env, dev), start, goals, settings, offset,
                             device=dev)

    def fcit(self, start, goals, env, settings=None, sampler=None, device=None):
        """FCIT* from `start` to any of `goals`: a PRMResult (numpy)."""
        dev = resolve_device(device)
        start, goals, offset = self._plan_args(start, goals, sampler)
        return fcit_mod.solve(self.spec, _as_env(env, dev), start, goals, settings, offset,
                              device=dev)

    def roadmap(self, start, goal, env, settings=None, sampler=None, device=None):
        """A PRM* roadmap from `start` and `goal` without early exit."""
        dev = resolve_device(device)
        start, goals, offset = self._plan_args(start, goal, sampler)
        return prm_mod.build_roadmap(self.spec, _as_env(env, dev), start, goals[0], settings,
                                     offset, device=dev)

    def aorrtc(self, start, goals, env, settings=None, sampler=None, device=None):
        """AORRTC from `start` to any of `goals`: RRT-Connect, then AOX
        cost-bounded refinement (planning/aorrtc.py::solve); the best
        SimplifyResult, tensors on the device."""
        dev = resolve_device(device)
        start, goals, offset = self._plan_args(start, goals, sampler)
        if settings is None:
            settings = AORRTCSettings(rrtc=self.default_rrtc_settings())
        res, _ = aorrtc_mod.solve(self.spec, _as_env(env, dev), start, goals, settings, offset,
                                  device=dev)
        return res


def png_to_heightfield(filename, center, scaling):
    """PNG -> heightfield meta and data (reference src/vamp/__init__.py:54-66)."""
    from PIL import Image

    image = Image.open(filename).convert("L")
    array = np.asarray(image) / 255.0
    array = np.flip(array, axis=0)
    return envmod.make_heightfield(center, scaling, array)


ROBOTS = list(registry.ROBOTS)

sphere = RobotModule("sphere")
ur5 = RobotModule("ur5")
panda = RobotModule("panda")
fetch = RobotModule("fetch")
baxter = RobotModule("baxter")
