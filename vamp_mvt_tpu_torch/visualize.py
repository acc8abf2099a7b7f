"""Visualization and result-reporting utilities.

Port of `vamp_mvt_tpu/visualize.py`.  The reference's PyBulletSimulator
(src/vamp/pybullet_interface.py:39-415) mirrors environments and animates
paths in PyBullet.  Here:

- `PyBulletVisualizer`: the same role when pybullet is installed (URDF load,
  shape mirroring, path animation); raises a clear error otherwise.
- matplotlib plots that need no simulator: 3D environment/workspace plots,
  joint-trajectory plots, roadmap plots.
- `results_to_dict` / `results_dataframe`: pandas result records mirroring
  reference src/vamp/__init__.py:191-228.

Every function takes torch tensors (on any device) or numpy arrays.  The
functions that compute (the environment's tables, the end-effector traces)
run on `device`, the GPU unless the caller names another; only the arrays
that are drawn come back to the host.  matplotlib and pandas are imported
inside the functions that draw or build frames, so importing this module
needs neither.
"""

from __future__ import annotations

import numpy as np
import torch

from vamp_mvt_tpu_torch.device import resolve_device


def _np(x) -> np.ndarray:
    """A tensor on any device, or anything numpy reads, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def results_to_dict(plan_result, simp_result=None) -> dict:
    """Per-problem record (reference src/vamp/__init__.py:191-228)."""
    solved = bool(_np(plan_result.solved))
    data = {
        "planning_iterations": int(_np(plan_result.iterations)),
        "solved": solved,
        "planning_graph_size": int(_np(plan_result.size_start))
        + int(_np(plan_result.size_goal)),
        "initial_path_vertices": int(_np(plan_result.path_length)),
        "initial_path_cost": float(_np(plan_result.cost)) if solved else float("inf"),
    }
    if simp_result is not None:
        data.update(
            simplified_path_vertices=int(_np(simp_result.path_length)),
            simplified_path_cost=float(_np(simp_result.cost)),
        )
    else:
        data.update(
            simplified_path_vertices=data["initial_path_vertices"],
            simplified_path_cost=data["initial_path_cost"],
        )
    return data


def results_dataframe(suite_result):
    """Whole-suite pandas DataFrame from a bench.mbm.SuiteResult."""
    import pandas as pd

    p, s = suite_result.plan, suite_result.simplified
    return pd.DataFrame(
        {
            "problem": [n for n, _ in suite_result.names],
            "index": [i for _, i in suite_result.names],
            "valid": _np(suite_result.valid),
            "solved": _np(p.solved),
            "planning_iterations": _np(p.iterations),
            "planning_graph_size": _np(p.size_start) + _np(p.size_goal),
            "initial_path_cost": _np(p.cost),
            "simplified_path_cost": _np(s.cost),
            "initial_path_vertices": _np(p.path_length),
            "simplified_path_vertices": _np(s.path_length),
        }
    )


def _cuboid_wires(row):
    """12 wireframe segments of a cuboid row (center + 3 axes + half-extents,
    environment.make_cuboid layout)."""
    c = row[0:3]
    axes = np.stack([row[3:6], row[6:9], row[9:12]])
    h = row[12:15]
    corners = np.array(
        [c + axes.T @ (h * s) for s in
         [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]]
    )
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    return [corners[[i, j]] for i, j in edges]


def plot_workspace(spec, env=None, paths=(), out_path=None, n_samples=40,
                   pointcloud=None, title=None, device=None):
    """3D render of environment shapes + end-effector traces of paths.

    Matplotlib twin of the PyBullet mirroring (reference
    pybullet_interface.py:122-324) for headless hosts: spheres as scaled
    scatter, capsules/cylinders as axis segments with radius-scaled line
    width, cuboids as 12-edge wireframes, heightfields as surface meshes,
    pointclouds as small scatter, and per-path end-effector traces.
    The environment is built and FK runs on `device` (default: the GPU).
    """
    dev = resolve_device(device)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from vamp_mvt_tpu_torch.ops import fk

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")

    if env is not None:
        e = env.build(device=dev) if hasattr(env, "build") else env
        sph = _np(e.spheres)
        real = sph[:, 0] < 1e7
        if real.any():
            ax.scatter(*sph[real, :3].T, s=2000 * sph[real, 3] ** 2, alpha=0.3,
                       c="tab:red", label="spheres")
        for arr in (e.capsules, e.z_capsules):
            a = _np(arr)
            real = a[:, 0] < 1e7
            for row in a[real]:
                p1, v, r = row[0:3], row[3:6], row[6]
                seg = np.stack([p1, p1 + v])
                ax.plot(*seg.T, "-", c="tab:green", alpha=0.6,
                        linewidth=max(1.0, 60 * r))
        for arr in (e.cuboids, e.z_cuboids):
            a = _np(arr)
            real = a[:, 0] < 1e7
            for row in a[real]:
                for seg in _cuboid_wires(row):
                    ax.plot(*seg.T, "-", c="tab:orange", alpha=0.6,
                            linewidth=0.8)
        hfm = _np(e.hf_meta)
        hfd = _np(e.hf_data)
        for n in range(hfm.shape[0]):
            m = hfm[n]
            if m[2] < -1e7:  # inert padding row
                continue
            W, H = int(m[6]), int(m[7])
            grid = hfd[n][: W * H].reshape(H, W)
            # invert the cell transform (sphere_heightfield.hh:20-23):
            # world x of column cx solves m3*(m0-x)+m8 = cx+0.5
            cx = np.arange(W) + 0.5
            cy = np.arange(H) + 0.5
            xs = m[0] - (cx - m[8]) / m[3]
            ys = m[1] - (cy - m[9]) / m[4]
            X, Y = np.meshgrid(xs, ys)
            Z = m[5] * grid + m[2]
            ax.plot_surface(X, Y, Z, alpha=0.35, cmap="terrain",
                            linewidth=0, antialiased=False)

    if pointcloud is not None and len(pointcloud):
        pc = _np(pointcloud)
        col = 0.8 * (pc / np.maximum(np.abs(pc).max(axis=0), 1e-9))
        ax.scatter(*pc.T, s=1.5, c=np.clip(np.abs(col), 0, 1), alpha=0.5)

    for path in paths:
        path = _np(path)
        # interpolate and trace the end effector
        ts = np.linspace(0, len(path) - 1, n_samples)
        lo = np.floor(ts).astype(int)
        hi = np.minimum(lo + 1, len(path) - 1)
        frac = (ts - lo)[:, None]
        qs = path[lo] * (1 - frac) + path[hi] * frac
        _, ee = fk.eefk(spec, torch.as_tensor(qs, dtype=torch.float32, device=dev))
        ee = _np(ee)
        ax.plot(*ee.T, "-o", markersize=2)

    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    if title:
        ax.set_title(title)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def render_problem(robot: str, problem: dict, path=None, path_length=None,
                   pointcloud=None, out_path=None, device=None):
    """One-call MBM scene render: problem dict -> environment + optional
    solved path + optional pointcloud (matplotlib; works headless).

    The PyBullet twin is PyBulletVisualizer.add_environment_from_problem_dict
    + draw_pointcloud + animate (reference pybullet_interface.py:284-324).
    The environment is built and FK runs on `device` (default: the GPU).
    """
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.robots import registry

    dev = resolve_device(device)
    spec = registry.load(robot)
    env = mbm.problem_to_builder(problem).build(device=dev)
    paths = ()
    if path is not None:
        p = _np(path)
        if path_length is not None:
            p = p[: max(int(path_length), 2)]
        paths = (p,)
    return plot_workspace(
        spec, env, paths=paths, pointcloud=pointcloud, out_path=out_path, device=dev,
        title=f"{robot} {problem.get('problem', '')}[{problem.get('index', '')}]",
    )


def plot_joint_trajectories(path, path_length=None, out_path=None):
    """Per-joint trajectory plot of a (padded) path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = _np(path)
    if path_length is not None:
        path = path[: int(_np(path_length))]
    fig, ax = plt.subplots(figsize=(8, 4))
    for j in range(path.shape[1]):
        ax.plot(path[:, j], "-o", markersize=3, label=f"q{j}")
    ax.set_xlabel("waypoint"); ax.set_ylabel("joint value (rad)")
    ax.legend(ncol=4, fontsize=8)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def plot_roadmap(roadmap, out_path=None):
    """3D roadmap plot (first three configuration dimensions)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    v = _np(roadmap.vertices)
    ax.scatter(*v[:, :3].T, s=4)
    for i, j in roadmap.edges[:5000]:
        seg = v[[i, j], :3]
        ax.plot(*seg.T, "k-", linewidth=0.2, alpha=0.4)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def _euler_xyz_quat(e):
    """Euler XYZ (rho, theta, phi) -> xyzw quaternion, matching the rotation
    convention of environment._euler_xyz_matrix (R = Rz Ry Rx)."""
    r, t, p = (np.asarray(e, np.float64) / 2.0)
    cr, sr, ct, st, cp, sp = np.cos(r), np.sin(r), np.cos(t), np.sin(t), np.cos(p), np.sin(p)
    return [
        float(sr * ct * cp - cr * st * sp),
        float(cr * st * cp + sr * ct * sp),
        float(cr * ct * sp - sr * st * cp),
        float(cr * ct * cp + sr * st * sp),
    ]


class PyBulletVisualizer:
    """PyBullet mirror of the reference PyBulletSimulator
    (src/vamp/pybullet_interface.py:39-415): URDF robot, environment shape
    mirroring (sphere/capsule/cylinder/cuboid/heightmap), MBM problem-dict
    scenes, roadmap and pointcloud drawing, and path animation.  Requires
    pybullet; raises ImportError without it — render_problem/plot_workspace
    above are the headless twins."""

    def __init__(self, urdf_path: str | None = None, gui: bool = False):
        try:
            import pybullet as pb
            import pybullet_utils.bullet_client as bc
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "pybullet is not installed; use the matplotlib helpers "
                "(render_problem/plot_workspace/plot_joint_trajectories)"
            ) from e
        self._pb = pb
        self.client = bc.BulletClient(pb.GUI if gui else pb.DIRECT)
        self.robot = None
        self._joints = []
        if urdf_path is not None:
            self.robot = self.client.loadURDF(urdf_path, useFixedBase=True)
            self._joints = [
                i
                for i in range(self.client.getNumJoints(self.robot))
                if self.client.getJointInfo(self.robot, i)[2] != pb.JOINT_FIXED
            ]

    def set_configuration(self, q):
        for ji, qi in zip(self._joints, _np(q)):
            self.client.resetJointState(self.robot, ji, float(qi))

    def set_camera(self, position, look_at):
        import math

        dx, dy, dz = (position[i] - look_at[i] for i in range(3))
        self.client.resetDebugVisualizerCamera(
            cameraDistance=math.sqrt(dx * dx + dy * dy + dz * dz),
            cameraYaw=math.degrees(math.atan2(dz, dx)),
            cameraPitch=math.degrees(
                math.atan2(math.sqrt(dz * dz + dx * dx), dy) + math.pi
            ),
            cameraTargetPosition=list(look_at),
        )

    # --- shape mirroring (reference pybullet_interface.py:122-283) ---------

    def _body(self, geom, position, rot_xyzw=None, rgba=(0.8, 0.2, 0.2, 0.6),
              **kw):
        vs = self.client.createVisualShape(geom, rgbaColor=list(rgba), **kw)
        # collision geometry uses height= instead of length=
        ckw = {("height" if k == "length" else k): v for k, v in kw.items()}
        cs = self.client.createCollisionShape(geom, **ckw)
        return self.client.createMultiBody(
            baseVisualShapeIndex=vs,
            baseCollisionShapeIndex=cs,
            basePosition=list(position),
            baseOrientation=list(rot_xyzw) if rot_xyzw is not None else [0, 0, 0, 1],
        )

    def add_sphere(self, center, radius, rgba=(0.8, 0.2, 0.2, 0.6)):
        return self._body(self._pb.GEOM_SPHERE, center, radius=radius, rgba=rgba)

    def add_capsule(self, radius, length, position, rot_xyzw,
                    rgba=(0.2, 0.6, 0.2, 0.6)):
        return self._body(
            self._pb.GEOM_CAPSULE, position, rot_xyzw, rgba,
            radius=radius, length=length,
        )

    def add_cylinder(self, radius, length, position, rot_xyzw,
                     rgba=(0.2, 0.6, 0.2, 0.6)):
        return self._body(
            self._pb.GEOM_CYLINDER, position, rot_xyzw, rgba,
            radius=radius, length=length,
        )

    def add_cuboid(self, half_extents, position, rot_xyzw,
                   rgba=(0.8, 0.5, 0.2, 0.6)):
        return self._body(
            self._pb.GEOM_BOX, position, rot_xyzw, rgba,
            halfExtents=list(half_extents),
        )

    def add_height_map(self, height_file, texture_file=None,
                       scale=(1, 1, 1), center=(0.0, 0.0, 0.0)):
        cs = self.client.createCollisionShape(
            shapeType=self._pb.GEOM_HEIGHTFIELD, meshScale=list(scale),
            fileName=str(height_file),
        )
        terrain = self.client.createMultiBody(
            baseCollisionShapeIndex=cs, basePosition=list(center)
        )
        if texture_file:
            tex = self.client.loadTexture(str(texture_file))
            self.client.changeVisualShape(terrain, -1, textureUniqueId=tex)
        self.client.changeVisualShape(terrain, -1, rgbaColor=[1, 1, 1, 1])
        return terrain

    def update_object_position(self, body_id, position, rot_xyzw=(0, 0, 0, 1)):
        self.client.resetBasePositionAndOrientation(
            body_id, list(position), list(rot_xyzw)
        )

    def add_environment_from_problem_dict(self, problem: dict):
        """Mirror an MBM problem dict (bench.mbm.load_problems layout; euler
        orientations are converted) — reference pybullet_interface.py:284-310."""
        ids = []
        for obj in problem.get("sphere", []):
            ids.append(self.add_sphere(obj["position"], obj["radius"]))
        for obj in problem.get("cylinder", []):
            q = (obj.get("orientation_quat_xyzw")
                 or _euler_xyz_quat(obj["orientation_euler_xyz"]))
            ids.append(
                self.add_capsule(obj["radius"], obj["length"], obj["position"], q)
            )
        for obj in problem.get("box", []):
            q = (obj.get("orientation_quat_xyzw")
                 or _euler_xyz_quat(obj["orientation_euler_xyz"]))
            ids.append(
                self.add_cuboid(obj["half_extents"], obj["position"], q)
            )
        return ids

    # --- debug drawing (reference pybullet_interface.py:312-331) -----------

    def draw_roadmap(self, spec, roadmap, device=None):
        """End-effector-space roadmap edges as debug lines (FK on `device`,
        default: the GPU)."""
        from vamp_mvt_tpu_torch.ops import fk

        dev = resolve_device(device)
        v = _np(roadmap.vertices)
        _, ee = fk.eefk(spec, torch.as_tensor(v, dtype=torch.float32, device=dev))
        ee = _np(ee)
        for i, j in roadmap.edges:
            self.client.addUserDebugLine(list(ee[i]), list(ee[j]))

    def draw_pointcloud(self, pc, lifetime: float = 0.0, pointsize: int = 3):
        pc = _np(pc).astype(np.float64)
        colors = 0.8 * np.abs(pc) / np.maximum(np.abs(pc).max(axis=0), 1e-9)
        self.client.addUserDebugPoints(
            pc.tolist(), np.clip(colors, 0, 1).tolist(),
            pointSize=pointsize, lifeTime=lifetime,
        )

    def clear_pointcloud(self):
        self.client.removeAllUserDebugItems()

    # --- playback ----------------------------------------------------------

    def animate(self, path, steps_per_segment: int = 20, callback=None):
        path = _np(path)
        for a, b in zip(path[:-1], path[1:]):
            for t in np.linspace(0, 1, steps_per_segment):
                q = a * (1 - t) + b * t
                self.set_configuration(q)
                if callback:
                    callback(q)

    def play_once(self, path, steps_per_segment: int = 20, dt: float = 0.016):
        """Single real-time playback pass (reference play_once without the
        interactive keyboard loop, which needs a GUI session)."""
        import time as _time

        def pace(_q):
            _time.sleep(dt)

        self.animate(path, steps_per_segment, callback=pace)
