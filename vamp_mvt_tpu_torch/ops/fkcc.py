"""Fused forward kinematics + collision checking (the reference's `fkcc`).

Port of `vamp_mvt_tpu/ops/fkcc.py`, plain PyTorch:

  fkcc(spec, env, q (..., d)) -> valid (...) bool   (True = collision-free)
  fkcc_vmin(spec, env, q)     -> (...) float32, the minimum signed value over
                                 every check; valid iff vmin >= 0

Self-collision is an elementwise float32 test over the robot's exact pair
table.  No `torch.cdist` and no matrix-product form: cdist switches to a
matmul expansion on large inputs, and that rounding flips borderline contacts.

Heightfields contribute z - r - (sz * h + z0) of the cell under each sphere
(`primitives.sphere_heightfield`, with the JAX package's XLA index rule).
An end-effector attachment (`env.attachment`) poses its payload spheres
from the EE frame and checks them against every environment table and
against the robot's attachment-check spheres (`attachment_vmin`).

Pointclouds: an MVT or CAPT structure (the JAX package's lockstep path)
contributes -1 where a sphere hits the cloud; the kernel-resident form
(`env.pck`) contributes `pc_vmin_plain`, the exact minimum over every live
point of d^2 - (r + r_point)^2.  All three decide alike except where a point
lies exactly at d^2 == (r + r_point)^2: MVT and CAPT call that a hit, the
kernel's rule (valid iff vmin >= 0) does not.

`fkcc` dispatches through `ops/kernels/fkcc_cuda.py`: a CUDA tensor goes to
the hand-written kernel, a CPU tensor to the plain version below, and so does
a CUDA tensor where the tables hold an MVT or CAPT pointcloud without its
kernel form (`fkcc_cuda.supports`; on the tensor's own device).
"""

from __future__ import annotations

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision import primitives
from vamp_mvt_tpu_torch.collision.capt import capt_collides
from vamp_mvt_tpu_torch.collision.environment import (  # noqa: F401
    Attachment, Environment, make_attachment)
from vamp_mvt_tpu_torch.collision.mvt import batch_index, mvt_collides, rows
from vamp_mvt_tpu_torch.collision.pc_kernel import CS
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.ops.fk import eefk, link_poses, sphere_positions
from vamp_mvt_tpu_torch.robots.spec import RobotSpec

_PRIMITIVES = (
    ("spheres", primitives.sphere_sphere),
    ("capsules", primitives.sphere_capsule),
    ("z_capsules", primitives.sphere_z_capsule),
    ("cuboids", primitives.sphere_cuboid),
    ("z_cuboids", primitives.sphere_z_cuboid),
)


def pair_thresholds(spec: RobotSpec) -> np.ndarray:
    """(P,) float32 (r_i + r_j)^2 per checked self-collision pair."""
    r = spec.sphere_radius
    return np.asarray(
        [(r[i] + r[j]) ** 2 for i, j in spec.self_collision_pairs], np.float32
    ).reshape(-1)


def self_vmin(spec: RobotSpec, centers: torch.Tensor) -> torch.Tensor:
    """centers (..., S, 3) -> (...) min over checked pairs of d^2 - (ri+rj)^2."""
    pairs = spec.self_collision_pairs
    if not len(pairs):
        return torch.full(centers.shape[:-2], float("inf"), device=centers.device)
    i = torch.as_tensor(pairs[:, 0], dtype=torch.long, device=centers.device)
    j = torch.as_tensor(pairs[:, 1], dtype=torch.long, device=centers.device)
    thr = torch.as_tensor(pair_thresholds(spec), device=centers.device)
    # (S, 3, ...) layout: each pair gathers whole contiguous rows
    c = centers.movedim((-2, -1), (0, 1)).contiguous()
    d = torch.index_select(c, 0, i) - torch.index_select(c, 0, j)   # (P, 3, ...)
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    thr = thr.reshape((-1,) + (1,) * (d2.dim() - 1))
    return torch.amin(d2 - thr, dim=0)


# elements of the largest (queries, S, points) intermediate of pc_vmin_plain
_PC_ELEMS = {"cuda": 1 << 27, "cpu": 1 << 22}


def pc_vmin_plain(pck, centers: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """centers (..., S, 3), radii (S,) or broadcastable to (..., S) -> (...)
    minimum over every sphere and every live point of the cloud of
    d^2 - (r + r_point)^2, with
    d^2 summed x, y, z in that order (the kernel's); +inf for an empty cloud.
    `pck`'s leading dims broadcast against the centers' first dims.

    min over points of (d^2 - t) is computed as (min over points of d^2) - t,
    which is the same float: rounding a subtraction is monotonic."""
    dev = centers.device
    S = centers.shape[-2]
    lead = tuple(pck.meta.shape[:-2])
    qshape = tuple(centers.shape[:-2])
    c = centers.reshape(-1, S, 3)
    rad = radii.expand(centers.shape[:-1]).reshape(-1, S)
    out = torch.full((c.shape[0],), float("inf"), device=dev)
    bi = batch_index(lead, qshape, dev).reshape(-1)
    meta = rows(pck.meta, 2)[:, 0].tolist()                   # (L, 8)
    pts = rows(pck.points, 2)                                 # (L, NCH, 3 * CS)
    for l, m in enumerate(meta):
        nlive = int(m[6])
        if nlive == 0:
            continue
        sel = (bi == l).nonzero()[:, 0] if len(meta) > 1 else None
        q = c if sel is None else c[sel]
        thr = (rad if sel is None else rad[sel]) + torch.tensor(m[5], dtype=torch.float32,
                                                                device=dev)
        thr2 = thr * thr
        p = pts[l, :nlive]
        px, py, pz = (p[:, k * CS:(k + 1) * CS].reshape(-1) for k in range(3))
        step = max(_PC_ELEMS.get(dev.type, 1 << 22) // (S * px.shape[0]), 1)
        parts = []
        for i in range(0, q.shape[0], step):
            qi = q[i : i + step]
            d2 = qi[..., 0, None] - px
            d2 = d2 * d2
            t = qi[..., 1, None] - py
            d2 += t * t
            t = qi[..., 2, None] - pz
            d2 += t * t
            parts.append(torch.amin(torch.amin(d2, dim=-1) - thr2[i : i + step], dim=-1))
        v = torch.cat(parts)
        if sel is None:
            out = v
        else:
            out[sel] = v
    return out.reshape(qshape)


def env_vmin(env: Environment, centers: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """centers (..., S, 3), radii (S,) or broadcastable to (..., S) -> (...)
    min signed value over every sphere against every shape row, heightfield
    and pointcloud.  The environment's tables carry the same leading dims as
    the centers' batch, or broadcast against them."""
    out = torch.full(centers.shape[:-2], float("inf"), device=centers.device)
    for name, fn in _PRIMITIVES:
        table = getattr(env, name)
        if table.shape[-2]:
            out = torch.minimum(out, torch.amin(fn(table, centers, radii), dim=(-2, -1)))
    if env.hf_meta.shape[-2]:
        hf = primitives.sphere_heightfield(env.hf_meta, env.hf_data, centers, radii)
        out = torch.minimum(out, torch.amin(hf, dim=(-2, -1)))
    rr = radii.expand(centers.shape[:-1])
    for st, query in ((env.mvt, mvt_collides), (env.capt, capt_collides)):
        if st is not None:
            hit = query(st, centers, rr).any(-1)
            out = torch.where(hit, torch.clamp_max(out, -1.0), out)
    if env.pck is not None:
        out = torch.minimum(out, pc_vmin_plain(env.pck, centers, radii))
    return out


def self_collision(spec: RobotSpec, centers: torch.Tensor) -> torch.Tensor:
    """centers (..., S, 3) -> (...) bool, True = some checked pair collides."""
    return self_vmin(spec, centers) < 0.0


def env_collision(env: Environment, centers: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """centers (..., S, 3), radii (S,) -> (...) bool, True = env collision."""
    return env_vmin(env, centers, radii) < 0.0


def attachment_rows(att: Attachment) -> torch.Tensor:
    """(..., A, 4): each payload sphere's centre in the EE frame, tf_rot @ xyz
    + tf_pos summed in index order, and its radius.  The CUDA kernels take
    these rows (ops/kernels/fkcc_cuda.py), as the Pallas kernel takes the
    same composition (fkcc_pallas.py:655-669)."""
    rot, pos, sp = att.tf_rot, att.tf_pos, att.spheres
    xyz = [((rot[..., i, None, 0] * sp[..., 0] + rot[..., i, None, 1] * sp[..., 1])
            + rot[..., i, None, 2] * sp[..., 2]) + pos[..., i, None] for i in range(3)]
    return torch.stack(xyz + [sp[..., 3]], dim=-1)


def payload_centers(spec: RobotSpec, att: Attachment, q: torch.Tensor, poses=None):
    """The payload spheres of `att` posed from the EE frame at q: world
    centres (..., A, 3), summed in index order, and radii (L..., A).  The
    attachment carries the tables' leading dims."""
    lx, ly, lz, ar = attachment_rows(att).unbind(-1)  # (L..., A)
    R, t = eefk(spec, q, poses)                       # (..., 3, 3), (..., 3)
    posed = torch.stack(
        [((R[..., i, 0, None] * lx + R[..., i, 1, None] * ly) + R[..., i, 2, None] * lz)
         + t[..., i, None] for i in range(3)], dim=-1)
    return posed, ar


def staged_centers(spec: RobotSpec, env: Environment, q: torch.Tensor) -> torch.Tensor:
    """(..., S + A, 3): the robot's sphere centres at q, then its payload's:
    the sphere set the heightfield and pointcloud branches check."""
    poses = link_poses(spec, q)
    centers = sphere_positions(spec, q, poses)
    if env.attachment is None:
        return centers
    posed = payload_centers(spec, env.attachment, q, poses)[0]
    return torch.cat([centers, posed.expand(centers.shape[:-2] + posed.shape[-2:])], dim=-2)


def attachment_vmin(spec: RobotSpec, env: Environment, q: torch.Tensor,
                    centers: torch.Tensor, poses=None) -> torch.Tensor:
    """(...) min signed value of the payload spheres of `env.attachment`
    (reference fkcc_attach, panda.hh:15309-15345; JAX ops/fkcc.py::
    attachment_collision): posed from the EE frame at q, against every
    environment table and against the robot's attachment-check spheres
    (`centers` (..., S, 3) at q).  The attachment carries the tables'
    leading dims."""
    posed, ar = payload_centers(spec, env.attachment, q, poses)
    out = env_vmin(env, posed, ar)
    idx = torch.as_tensor(spec.attachment_check_spheres, dtype=torch.long, device=q.device)
    if idx.numel():
        rob = centers[..., idx, :]                    # (..., Sc, 3)
        rob_r = torch.as_tensor(spec.sphere_radius, device=q.device)[idx]
        diff = posed[..., :, None, :] - rob[..., None, :, :]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
        rs = ar[..., :, None] + rob_r
        out = torch.minimum(out, torch.amin(d2 - rs * rs, dim=(-2, -1)))
    return out


def attachment_collision(spec: RobotSpec, env: Environment, q: torch.Tensor,
                         centers: torch.Tensor) -> torch.Tensor:
    """(...) bool, True = a payload sphere of `env.attachment` hits the
    environment or the robot's attachment-check spheres (JAX ops/fkcc.py::
    attachment_collision)."""
    return attachment_vmin(spec, env, q, centers) < 0.0


def fkcc_vmin(spec: RobotSpec, env: Environment, q: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (...) minimum signed value; valid iff >= 0.

    Environment tables need one more (broadcast) dim than the result's batch:
    for q (B, N, d) pass tables shaped (B, 1, n, f)."""
    poses = link_poses(spec, q)
    centers = sphere_positions(spec, q, poses)
    radii = torch.as_tensor(spec.sphere_radius, device=q.device)
    out = torch.minimum(env_vmin(env, centers, radii), self_vmin(spec, centers))
    if env.attachment is not None:
        out = torch.minimum(out, attachment_vmin(spec, env, q, centers, poses))
    return out


def fkcc(spec: RobotSpec, env: Environment, q: torch.Tensor, device=None) -> torch.Tensor:
    """(..., d) configurations, one environment -> (...) bool validity.

    Runs on `device` (default: the GPU, through the CUDA kernel where it
    reads every table: `planning/validate.py::fkcc_valid`)."""
    from vamp_mvt_tpu_torch.planning import validate

    dev = resolve_device(device)
    batch = q.shape[:-1]
    q = q.to(dev).reshape(1, -1, spec.dimension)
    envs = env.to(dev).map(lambda t: t.unsqueeze(0))
    return validate.fkcc_valid(spec, envs, q).reshape(batch)
