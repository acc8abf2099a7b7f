"""Batched forward kinematics over a RobotSpec kinematic tree.

Port of `vamp_mvt_tpu/ops/fk.py`: configurations of any batch shape (..., d)
map to sphere centers (..., S, 3).  The chain is unrolled in Python over the
frames; every emitted operation is elementwise over the batch.
"""

from __future__ import annotations

import torch

from vamp_mvt_tpu_torch.ops import smat
from vamp_mvt_tpu_torch.robots.spec import PRISMATIC, REVOLUTE, RobotSpec


def link_poses(spec: RobotSpec, q: torch.Tensor):
    """Per-frame poses: a list over frames of (R, t), where R is a 3x3 nested
    list and t a length-3 list of entries that are Python floats or (...,)
    tensors."""
    qc = [q[..., i] for i in range(spec.dimension)]
    trig = [(torch.cos(x), torch.sin(x)) for x in qc]

    poses = []
    for f in spec.frames:
        if f.parent < 0:
            R = smat.const_mat(f.origin_rot)
            t = smat.const_vec(f.origin_xyz)
        else:
            Rp, tp = poses[f.parent]
            R = smat.matmul(Rp, smat.const_mat(f.origin_rot))
            t = smat.vecadd(smat.matvec(Rp, smat.const_vec(f.origin_xyz)), tp)
        if f.joint_type == REVOLUTE:
            c, s = trig[f.q_index]
            R = smat.matmul(R, smat.axis_rotation(f.axis, c, s))
        elif f.joint_type == PRISMATIC:
            t = smat.vecadd(
                t, smat.vecscale(smat.matvec(R, smat.const_vec(f.axis)), qc[f.q_index])
            )
        poses.append((R, t))
    return poses


def _broadcast(e, q: torch.Tensor):
    shape = q.shape[:-1]
    if smat.is_const(e):
        return torch.full(shape, e, dtype=torch.float32, device=q.device)
    return torch.broadcast_to(e, shape).to(torch.float32)


def sphere_positions(spec: RobotSpec, q: torch.Tensor, poses=None) -> torch.Tensor:
    """Sphere centers for every collision sphere: (..., d) -> (..., S, 3).
    `poses`: link_poses(spec, q), where the caller has them already."""
    poses = link_poses(spec, q) if poses is None else poses
    cols = []
    for k in range(spec.n_spheres):
        R, t = poses[int(spec.sphere_frame[k])]
        p = smat.vecadd(smat.matvec(R, smat.const_vec(spec.sphere_local[k])), t)
        cols.append(torch.stack([_broadcast(pi, q) for pi in p], dim=-1))
    return torch.stack(cols, dim=-2)


def eefk(spec: RobotSpec, q: torch.Tensor, poses=None):
    """End-effector pose: (..., d) -> (R (..., 3, 3), t (..., 3))."""
    R, t = (link_poses(spec, q) if poses is None else poses)[spec.ee_frame]
    Rt = torch.stack(
        [torch.stack([_broadcast(R[i][j], q) for j in range(3)], dim=-1) for i in range(3)],
        dim=-2,
    )
    tt = torch.stack([_broadcast(ti, q) for ti in t], dim=-1)
    return Rt, tt
