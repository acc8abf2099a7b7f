"""State carried across from the JAX package: robot specs and environments.

The JAX package's state is the robot spec, the environment arrays, the
pointcloud structures and MPNet's network parameters.  These helpers take
them as numpy arrays and Python scalars (what `np.asarray` gives for each
JAX leaf) and return the port's objects, so both packages can be fed the
same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.capt import CAPTData
from vamp_mvt_tpu_torch.collision.environment import (
    TABLES, Attachment, Environment, check_live_prefix, tree_map)
from vamp_mvt_tpu_torch.collision.mvt import MVTData
from vamp_mvt_tpu_torch.collision.pc_kernel import PCKernelData
from vamp_mvt_tpu_torch.robots.spec import Frame, RobotSpec


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def spec_from_numpy(d: dict) -> RobotSpec:
    """A RobotSpec from the fields of one: numpy arrays and Python scalars;
    `frames` is a sequence of mappings or objects with Frame's fields."""
    frames = tuple(
        Frame(
            name=str(_field(f, "name")),
            parent=int(_field(f, "parent")),
            joint_type=int(_field(f, "joint_type")),
            q_index=int(_field(f, "q_index")),
            origin_rot=np.asarray(_field(f, "origin_rot"), np.float64).reshape(3, 3),
            origin_xyz=np.asarray(_field(f, "origin_xyz"), np.float64),
            axis=np.asarray(_field(f, "axis"), np.float64),
        )
        for f in d["frames"]
    )
    n_spheres = len(d["sphere_radius"])
    acs = d.get("attachment_check_spheres")
    return RobotSpec(
        name=str(d["name"]),
        dimension=int(d["dimension"]),
        resolution=int(d["resolution"]),
        frames=frames,
        sphere_frame=np.asarray(d["sphere_frame"], np.int32),
        sphere_local=np.asarray(d["sphere_local"], np.float32).reshape(-1, 3),
        sphere_radius=np.asarray(d["sphere_radius"], np.float32),
        limits_low=np.asarray(d["limits_low"], np.float32),
        limits_high=np.asarray(d["limits_high"], np.float32),
        self_collision_pairs=np.asarray(d["self_collision_pairs"], np.int32).reshape(-1, 2),
        attachment_check_spheres=np.asarray(
            np.arange(n_spheres) if acs is None else acs, np.int32
        ),
        joint_names=tuple(d.get("joint_names", ())),
        end_effector=str(d.get("end_effector", "")),
        ee_frame=int(d.get("ee_frame", -1)),
    )


def mvt_from_numpy(m) -> MVTData:
    """The port's MVTData from the JAX package's (its fields as numpy)."""
    return MVTData(*(np.asarray(_field(m, f)) for f in MVTData._fields))


def capt_from_numpy(c) -> CAPTData:
    """The port's CAPTData from the JAX package's (its fields as numpy)."""
    return CAPTData(*(np.asarray(_field(c, f)) for f in CAPTData._fields))


def pck_from_numpy(k) -> PCKernelData:
    """The port's PCKernelData from the JAX package's: bitmap, chunks, points
    and meta (its `supers` and `radii` have no reader in the port)."""
    return PCKernelData(*(np.asarray(_field(k, f)) for f in PCKernelData._fields))


def attachment_from_numpy(a) -> Attachment:
    """The port's Attachment from the JAX package's (`tf_rot`, `tf_pos`,
    `spheres` as numpy)."""
    return Attachment(*(np.asarray(_field(a, f), np.float32) for f in Attachment._fields))


_STRUCT_FROM = {"mvt": mvt_from_numpy, "capt": capt_from_numpy, "pck": pck_from_numpy,
                "attachment": attachment_from_numpy}


def environment_from_numpy(leaves: dict, device) -> Environment:
    """The port's Environment from the JAX package's leaves (`spheres`,
    `capsules`, `z_capsules`, `cuboids`, `z_cuboids`, `hf_meta`, `hf_data`,
    and optionally `mvt`, `capt`, `pck`, `attachment`), with any leading
    batch dims, on `device`."""
    for name in TABLES:
        check_live_prefix(name, leaves[name])
    tables = {
        name: torch.as_tensor(np.array(leaves[name], np.float32), device=device)
        for name in Environment._fields if name not in _STRUCT_FROM
    }
    structs = {
        name: tree_map(lambda a: torch.as_tensor(np.array(a), device=device),
                       _STRUCT_FROM[name](leaves[name]))
        for name in _STRUCT_FROM if leaves.get(name) is not None
    }
    return Environment(**tables, **structs)


def mpnet_params_from_numpy(params, device=None):
    """The port's `planning/mpnet.py::MLP` from MPNet parameters as the JAX
    package holds them: (W (a, b), b (b,), alpha) a layer, `x @ W + b`,
    numpy arrays or scalars."""
    from vamp_mvt_tpu_torch.planning.mpnet import MLP

    params = [(np.asarray(W, np.float32), np.asarray(b, np.float32),
               np.asarray(a, np.float32).reshape(())) for W, b, a in params]
    mlp = MLP((params[0][0].shape[0],) + tuple(W.shape[1] for W, _, _ in params))
    with torch.no_grad():
        for (W, b, a), lin, act in zip(params, mlp.linears, mlp.prelus):
            lin.weight.copy_(torch.tensor(W.T))
            lin.bias.copy_(torch.tensor(b))
            act.weight.fill_(float(a))
    return mlp.to(device)


def mpnet_params_to_numpy(mlp) -> list[tuple]:
    """The inverse of `mpnet_params_from_numpy`: a port `MLP` as the JAX
    package holds MPNet parameters, (W (a, b), b (b,), alpha ()) numpy
    float32 arrays a layer."""
    return [(W.detach().cpu().numpy().copy(), b.detach().cpu().numpy().copy(),
             a.detach().cpu().numpy().astype(np.float32).reshape(()))
            for W, b, a in mlp.params()]
