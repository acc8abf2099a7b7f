"""A problem's pointcloud, made plainly: surface samples, then the SCDF filter.

As VAMP's pointcloud MotionBenchMaker script makes it (src/vamp/pointcloud.py
and the C++ filter, collision/filter.hh): each cylinder and box surface is
sampled with the legacy numpy generator seeded 0 for each problem, spheres
are not sampled, and the cloud is culled to the robot's reach and thinned by
the space-filling-curve distance filter (six Morton orders, each dropping a
point within `min_dist` of the last point kept).  All in numpy; the filter's
arithmetic is float32, as the C++ filter's.
"""

from __future__ import annotations

import itertools

import numpy as np

MORTON_FACTOR = 1000


def _quat_matrix(q):
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _euler_quat(rho, theta, phi):
    """Euler XYZ (Rz(phi) Ry(theta) Rx(rho)) -> quaternion x, y, z, w."""
    cr, sr = np.cos(rho / 2), np.sin(rho / 2)
    cp, sp = np.cos(theta / 2), np.sin(theta / 2)
    cy, sy = np.cos(phi / 2), np.sin(phi / 2)
    return (sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy)


def _cylinder(rs, pos, quat, radius, height, n):
    angles = rs.uniform(-np.pi, np.pi, n)
    circle = np.stack((np.cos(angles), np.sin(angles)), axis=1)
    side, cap = height * 2 * np.pi * radius, np.pi * radius ** 2
    probs = np.array([cap, side, cap]) / (side + 2 * cap)
    which = np.searchsorted(np.cumsum(probs), rs.random(n), side="right")
    circle[which == 0] *= rs.uniform(0, radius, size=(np.count_nonzero(which == 0), 1))
    circle[which == 1] *= radius
    circle[which == 2] *= rs.uniform(0, radius, size=(np.count_nonzero(which == 2), 1))
    z = np.ones((n, 1))
    z[which == 0] = -height / 2
    z[which == 1] = rs.uniform(-height / 2, height / 2, size=(np.count_nonzero(which == 1), 1))
    z[which == 2] = height / 2
    pts = np.concatenate((circle, z), axis=1) @ _quat_matrix(quat).T + np.asarray(pos)
    return pts + (2 * 0.0 * rs.random_sample(pts.shape) - 0.0)


def _cuboid(rs, pos, quat, dims, n):
    dims = np.asarray(dims, dtype=float)
    pts = rs.uniform(-1.0, 1.0, (n, 3)) * dims / 2
    probs = np.array([dims[1] * dims[2]] * 2 + [dims[0] * dims[2]] * 2 + [dims[0] * dims[1]] * 2)
    probs /= probs.sum()
    sides = np.searchsorted(np.cumsum(probs), rs.random(n), side="right")
    for s, (axis, sign) in enumerate([(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]):
        pts[sides == s, axis] = sign * dims[axis] / 2
    pts = pts @ _quat_matrix(quat).T + np.asarray(pos)
    return pts + (2 * 0.0 * rs.random_sample(pts.shape) - 0.0)


def sample(problem: dict, per_object: int) -> np.ndarray:
    """Every cylinder's and box's surface, `per_object` points each."""
    rs = np.random.RandomState(0)
    clouds = []
    for c in problem["cylinder"]:
        clouds.append(_cylinder(rs, c["position"], _euler_quat(*c["orientation_euler_xyz"]),
                                c["radius"], c["length"], per_object))
    for b in problem["box"]:
        clouds.append(_cuboid(rs, b["position"], _euler_quat(*b["orientation_euler_xyz"]),
                              np.asarray(b["half_extents"]) * 2, per_object))
    return np.vstack(clouds) if clouds else np.zeros((0, 3))


def _morton(c: np.ndarray) -> np.ndarray:
    out = np.zeros(len(c), dtype=np.uint32)
    for bit in range(10):
        for k in range(3):
            out |= ((c[:, k] >> bit) & 1).astype(np.uint32) << (3 * bit + k)
    return out


def scdf(pc, min_dist: float, max_range: float, origin, ws_min, ws_max) -> np.ndarray:
    """The SCDF filter with culling: the kept subset of pc (N, 3), float32."""
    pc = np.asarray(pc, dtype=np.float32)
    if pc.shape[0] == 0:
        return pc
    origin = np.asarray(origin, dtype=np.float32)
    sqdist = np.float32(min_dist * min_dist)
    lo = np.float32(min(origin - max_range))
    hi = np.float32(min(origin + max_range))
    keep = ((np.sum((pc - origin) ** 2, axis=1) < max_range * max_range)
            & np.all(pc >= np.asarray(ws_min, dtype=np.float32), axis=1)
            & np.all(pc <= np.asarray(ws_max, dtype=np.float32), axis=1))
    idx = np.flatnonzero(keep).astype(np.uint32)
    for coords in itertools.permutations(range(3)):
        pts = pc[idx]
        c = ((pts[:, coords] - lo) / (hi - lo) * MORTON_FACTOR).astype(np.uint32)
        new_lo = min(np.float32(pts.min()), hi)
        new_hi = max(np.float32(pts.max()), lo)
        idx = idx[np.argsort(_morton(c), kind="stable")]
        idx = idx[_chain(pc[idx], sqdist)]
        hi = np.float32((new_hi + hi) / 2.0)
        lo = np.float32((new_lo + lo) / 2.0)
    return pc[idx]


def _chain(pts: np.ndarray, sqdist) -> np.ndarray:
    """Indices kept by the sequential rule: keep a point when its float32
    squared distance to the last kept point exceeds sqdist."""
    x, y, z = (pts[:, k].tolist() for k in range(3))
    f32 = np.float32
    kept = [0]
    lx, ly, lz = f32(x[0]), f32(y[0]), f32(z[0])
    thr = float(sqdist)
    for i in range(1, len(x)):
        dx, dy, dz = f32(x[i]) - lx, f32(y[i]) - ly, f32(z[i]) - lz
        # a cheap float64 screen first; only near the threshold the float32 sum decides
        d64 = float(dx) * float(dx) + float(dy) * float(dy) + float(dz) * float(dz)
        if d64 > thr * 1.001 or (d64 > thr * 0.999 and dx * dx + dy * dy + dz * dz > sqdist):
            kept.append(i)
            lx, ly, lz = f32(x[i]), f32(y[i]), f32(z[i])
    return np.asarray(kept)


def problem_cloud(problem: dict, per_object: int, filter_radius: float, reach: float,
                  origin) -> np.ndarray:
    """The filtered cloud of one problem (P, 3) float32, culled to the box of
    half side `reach` around `origin` and to the ball of that radius."""
    origin = np.asarray(origin, float)
    return scdf(sample(problem, per_object), filter_radius, reach, origin,
                origin - reach, origin + reach)
