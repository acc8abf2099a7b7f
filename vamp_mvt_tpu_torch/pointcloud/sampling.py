"""Pointcloud generation from problem primitives.

The port's copy of `vamp_mvt_tpu/pointcloud/sampling.py` (numpy only).  It
mirrors the reference's surface sampling (src/vamp/pointcloud.py:29-126,
derived from geometrout) with the identical legacy-numpy RNG call order, so
that with np.random.seed(0) the clouds are bit-identical to the JAX
package's and the reference's.
"""

from __future__ import annotations

import numpy as np


def _quat_matrix(q):
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n == 0:
        return np.eye(3)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _apply_pose(points: np.ndarray, pos, quat_xyzw) -> np.ndarray:
    R = _quat_matrix(quat_xyzw)
    return points @ R.T + np.asarray(pos)


def cylinder_surface(pos, quat_xyzw, radius, height, num_points, noise=0.0):
    """Sample the full cylinder surface (caps + side), area-weighted."""
    angles = np.random.uniform(-np.pi, np.pi, num_points)
    circle = np.stack((np.cos(angles), np.sin(angles)), axis=1)
    side_area = height * 2 * np.pi * radius
    cap_area = np.pi * radius**2
    total = side_area + 2 * cap_area
    probs = np.array([cap_area / total, side_area / total, cap_area / total])
    which = np.searchsorted(np.cumsum(probs), np.random.random(num_points), side="right")
    circle[which == 0] *= np.random.uniform(
        0, radius, size=(np.count_nonzero(which == 0), 1)
    )
    circle[which == 1] *= radius
    circle[which == 2] *= np.random.uniform(
        0, radius, size=(np.count_nonzero(which == 2), 1)
    )
    z = np.ones((num_points, 1))
    z[which == 0] = -height / 2
    z[which == 1] = np.random.uniform(
        -height / 2, height / 2, size=(np.count_nonzero(which == 1), 1)
    )
    z[which == 2] = height / 2
    pts = np.concatenate((circle, z), axis=1)
    pts = _apply_pose(pts, pos, quat_xyzw)
    jitter = 2 * noise * np.random.random_sample(pts.shape) - noise
    return pts + jitter


def sphere_surface(center, radius, num_points, noise=0.0):
    """Sample a sphere's surface uniformly (normalised Gaussian directions;
    the port's own: MBM's clouds sample no sphere)."""
    d = np.random.standard_normal((num_points, 3))
    pts = np.asarray(center) + radius * d / np.linalg.norm(d, axis=1, keepdims=True)
    jitter = 2 * noise * np.random.random_sample(pts.shape) - noise
    return pts + jitter


def cuboid_surface(pos, quat_xyzw, dims, num_points, noise=0.0):
    """Sample the box surface, face-area-weighted."""
    dims = np.asarray(dims, dtype=float)
    pts = np.random.uniform(-1.0, 1.0, (num_points, 3)) * dims / 2
    probs = np.array(
        [
            dims[1] * dims[2],
            dims[1] * dims[2],
            dims[0] * dims[2],
            dims[0] * dims[2],
            dims[0] * dims[1],
            dims[0] * dims[1],
        ]
    )
    probs /= probs.sum()
    sides = np.searchsorted(np.cumsum(probs), np.random.random(num_points), side="right")
    for s, (axis, sign) in enumerate(
        [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]
    ):
        pts[sides == s, axis] = sign * dims[axis] / 2
    pts = _apply_pose(pts, pos, quat_xyzw)
    jitter = 2 * noise * np.random.random_sample(pts.shape) - noise
    return pts + jitter


def _euler_to_quat_xyzw(rho, theta, phi):
    """Euler XYZ (factory convention Rz(phi)Ry(theta)Rx(rho)) -> quat xyzw."""
    cr, sr = np.cos(rho / 2), np.sin(rho / 2)
    cp, sp = np.cos(theta / 2), np.sin(theta / 2)
    cy, sy = np.cos(phi / 2), np.sin(phi / 2)
    return (
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    )


def problem_to_pointcloud(problem: dict, samples_per_object: int) -> np.ndarray:
    """Sample every cylinder/box in an MBM problem dict
    (reference src/vamp/pointcloud.py:120-126; spheres are not sampled)."""
    np.random.seed(0)
    clouds = []
    for c in problem["cylinder"]:
        q = c.get("orientation_quat_xyzw") or _euler_to_quat_xyzw(
            *c["orientation_euler_xyz"]
        )
        clouds.append(
            cylinder_surface(c["position"], q, c["radius"], c["length"], samples_per_object)
        )
    for b in problem["box"]:
        q = b.get("orientation_quat_xyzw") or _euler_to_quat_xyzw(
            *b["orientation_euler_xyz"]
        )
        clouds.append(
            cuboid_surface(
                b["position"], q, np.asarray(b["half_extents"]) * 2, samples_per_object
            )
        )
    return np.vstack(clouds) if clouds else np.zeros((0, 3))
