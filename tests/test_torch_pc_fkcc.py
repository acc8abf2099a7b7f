"""Port parity: FK + collision against pointclouds.

Five validities of the same seeded configurations must agree exactly:

- the port's plain version on the kernel form (`env.pck`, `pc_vmin_plain`:
  the exact minimum over every live point of d^2 - (r + r_point)^2);
- the port's plain version on an MVT and on a CAPT structure;
- the JAX package's Pallas kernel on `pck` (interpret mode on the CPU, as
  tests/test_kernel_branches.py runs it);
- the JAX package's XLA path on MVT (and on CAPT).

Scenes: the sphere-robot wall and the Panda wall of
tests/test_kernel_branches.py, and its two radius-class soundness cases
rebuilt with robot spheres only (attachments are not ported yet): a robot
with more distinct radii than the bitmap has classes, so that one small
sphere shares its class with larger ones and must not inherit their
certain-hit bits; and a sphere of the largest class near the cloud, which
the certain-free gate must send to the exact scan.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.collision.pc_kernel import radius_classes as jradius_classes
from vamp_mvt_tpu.ops import fkcc as jfkcc
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.collision import pc_kernel
from vamp_mvt_tpu_torch.ops import fkcc
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

WMIN, WMAX = (-3.0, -3.0, 0.0), (3.0, 3.0, 6.0)
R_POINT = 0.0025


def wall_points(n_side=9):
    """tests/test_kernel_branches.py's thin wall of points at x = 0 with a gap
    around (y, z) = (0, 2.6)."""
    ys = np.linspace(-2.0, 2.0, n_side)
    zs = np.linspace(0.5, 3.0, n_side)
    return np.asarray([[0.0, y, z] for y in ys for z in zs
                       if not (abs(y) < 0.7 and z > 2.2)], np.float32)


def port_envs(spec, pts, r_min, r_max, max_radius):
    """The port's environments with the cloud as pck, MVT and CAPT."""
    out = {}
    b = envmod.EnvironmentBuilder()
    b.add_kernel_pointcloud(pts, pc_kernel.radius_classes(spec.sphere_radius), WMIN, WMAX,
                            R_POINT, max_radius)
    out["pck"] = b.build(device="cpu")
    b = envmod.EnvironmentBuilder()
    b.add_mvt_pointcloud(pts, r_min, r_max, WMIN, WMAX, R_POINT)
    out["mvt"] = b.build(device="cpu")
    b = envmod.EnvironmentBuilder()
    b.add_capt_pointcloud(pts, r_min, r_max, R_POINT)
    out["capt"] = b.build(device="cpu")
    return out


def jax_envs(jspec, pts, r_min, r_max, max_radius):
    """The JAX package's environments: MVT + pck (as its kernel-branch tests
    build them) and CAPT."""
    b = jenvmod.EnvironmentBuilder()
    b.add_mvt_pointcloud(pts, r_min, r_max, WMIN, WMAX, R_POINT)
    b.add_kernel_pointcloud(pts, jradius_classes(jspec.sphere_radius), WMIN, WMAX, R_POINT,
                            max_radius)
    mvt_pck = b.build()
    b = jenvmod.EnvironmentBuilder()
    b.add_capt_pointcloud(pts, r_min, r_max, R_POINT)
    return mvt_pck, b.build()


def all_validities(spec, jspec, pts, q, r_min, r_max, max_radius):
    envs = port_envs(spec, pts, r_min, r_max, max_radius)
    j_mvt_pck, j_capt = jax_envs(jspec, pts, r_min, r_max, max_radius)
    qt, qj = torch.as_tensor(q), jnp.asarray(q)
    out = {f"port_{k}": fkcc.fkcc(spec, e, qt, device="cpu").numpy() for k, e in envs.items()}
    out["jax_pallas_pck"] = np.asarray(jfkcc.fkcc(jspec, j_mvt_pck, qj, use_pallas=True))
    out["jax_xla_mvt"] = np.asarray(jfkcc.fkcc(jspec, j_mvt_pck, qj, use_pallas=False))
    out["jax_xla_capt"] = np.asarray(jfkcc.fkcc(jspec, j_capt, qj, use_pallas=False))
    return out


def assert_all_equal(vals):
    ref = vals["port_pck"]
    for k, v in vals.items():
        np.testing.assert_array_equal(v, ref, err_msg=k)
    return ref


def test_sphere_wall():
    radius = 0.25
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=radius)
    jspec = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=radius)
    rng = np.random.default_rng(3)
    q = rng.uniform(np.asarray(WMIN) - 0.5, np.asarray(WMAX) + 0.5, (1024, 3)).astype(np.float32)
    q[:300, 0] = rng.normal(0.0, 0.3, 300)  # a band near the wall
    ok = assert_all_equal(all_validities(spec, jspec, wall_points(), q, radius, radius, radius))
    assert 0 < ok.sum() < len(q)


def test_panda_wall():
    spec, jspec = registry.load("panda"), jregistry.load("panda")
    pts = wall_points()
    pts = pts[pts[:, 2] < 1.5] * np.float32(0.4) + np.float32([0.45, 0, 0.2])
    q = np.random.default_rng(5).uniform(spec.limits_low, spec.limits_high,
                                         (1024, 7)).astype(np.float32)
    ok = assert_all_equal(all_validities(spec, jspec, pts, q, spec.min_radius, spec.max_radius,
                                         spec.max_radius))
    assert 0 < ok.sum() < len(q)


# radii of the 13-sphere point robot: more than MAX_CLASSES distinct values,
# so radius_classes buckets sphere 5 (0.02) with 0.25
CLASS_RADII = np.float32([0.01, 0.012, 0.014, 0.016, 0.018, 0.02,
                          0.25, 0.251, 0.252, 0.253, 0.254, 0.255, 0.256])
SMALL = 5
DROP = 2.0  # the larger spheres hang this far below the small one


def class_robot(base):
    """The point robot with CLASS_RADII: sphere SMALL at the frame origin,
    the others DROP below it; no self-collision pairs."""
    local = np.zeros((len(CLASS_RADII), 3), np.float32)
    local[6:, 2] = -DROP
    return dataclasses.replace(
        base, sphere_frame=np.full(len(CLASS_RADII), 3, np.int32), sphere_local=local,
        sphere_radius=CLASS_RADII.copy(), self_collision_pairs=np.zeros((0, 2), np.int32),
        attachment_check_spheres=np.zeros(0, np.int32))


@pytest.mark.parametrize("case", ["small_sphere_no_certain_hit", "largest_class_gate"])
def test_radius_class_soundness(case):
    base = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    jbase = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    spec, jspec = class_robot(base), class_robot(jbase)
    tab = pc_kernel.sphere_table(spec.sphere_radius)
    classes = pc_kernel.radius_classes(spec.sphere_radius)
    assert classes[int(tab[SMALL, 1])] == np.float32(0.25) and tab[SMALL, 2] == 0.0
    assert tab[:, 3].all()  # every robot sphere has a sound gate
    # one point on a voxel centre of the kernel form's grid
    W = int(np.floor((WMAX[0] - WMIN[0]) / CLASS_RADII.max()))
    cell = (WMAX[0] - WMIN[0]) / W
    half_diag = cell * np.sqrt(3.0) / 2.0
    assert 0.25 + R_POINT - half_diag > 0.0  # class 0.25 has certain-hit bits
    point = np.float32([WMIN[0] + 12.5 * cell, WMIN[1] + 12.5 * cell, WMIN[2] + 12.5 * cell])
    pts = point[None]
    if case == "small_sphere_no_certain_hit":
        # the small sphere 0.06 from the point, in its voxel: the class's
        # certain-hit bit is set, but 0.06 > 0.02 + r_point, so it is free
        special = [point + np.float32([0.06, 0.0, 0.0]),
                   point + np.float32([0.02, 0.0, 0.0])]
        expect = [True, False]
    else:
        # the larger spheres 0.25 from the point (they collide) and 0.262
        # (free): neither is decided by the gate
        special = [point + np.float32([0.25, 0.0, DROP]),
                   point + np.float32([0.262, 0.0, DROP])]
        expect = [False, True]
    rng = np.random.default_rng(13)
    large = case == "largest_class_gate"
    around = point + np.float32([0.0, 0.0, DROP if large else 0.0])
    spread = 0.35 if large else 0.05
    q = np.concatenate([np.stack(special),
                        around + rng.uniform(-spread, spread, (256, 3)).astype(np.float32)])
    ok = assert_all_equal(all_validities(spec, jspec, pts, q, float(CLASS_RADII.min()),
                                         float(CLASS_RADII.max()), float(CLASS_RADII.max())))
    assert ok[:2].tolist() == expect
    assert 0 < ok[2:].sum() < 256


def test_pc_vmin_plain_value():
    """pc_vmin_plain is the exact minimum of d^2 - (r + r_point)^2 over the
    live points, the kernel's rule (valid iff >= 0), and ignores padding."""
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    pts = wall_points()
    envs = port_envs(spec, pts, 0.25, 0.25, 0.25)
    e = envmod.stack_environments([envs["pck"]])
    padded = e._replace(pck=e.pck._replace(
        chunks=torch.cat([e.pck.chunks, torch.zeros((1, 3, 8))], 1),
        points=torch.cat([e.pck.points, torch.zeros((1, 3, 3 * pc_kernel.CS))], 1)))
    q = torch.as_tensor(np.random.default_rng(17).uniform(
        WMIN, WMAX, (1, 200, 3)).astype(np.float32))
    centers = q[:, :, None, :]
    radii = torch.as_tensor(spec.sphere_radius)
    pck = envmod.tree_map(lambda t: t[:, None], padded.pck)  # (1, 1, ...): q's dims
    got = fkcc.pc_vmin_plain(pck, centers, radii)
    d = q[0][:, None, :] - torch.as_tensor(pts)[None]
    want = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]).amin(1) \
        - (radii[0] + R_POINT) ** 2
    torch.testing.assert_close(got[0], want, rtol=0, atol=0)


def test_converted_jax_environments():
    """convert.environment_from_numpy carries the JAX package's pointcloud
    structures (pck, MVT, CAPT) over unchanged: the port's plain version on
    the converted environments decides as the JAX package does."""
    from vamp_mvt_tpu_torch import convert

    spec = registry.load("panda")
    jspec = jregistry.load("panda")
    pts = wall_points()
    pts = pts[pts[:, 2] < 1.5] * np.float32(0.4) + np.float32([0.45, 0, 0.2])
    j_mvt_pck, j_capt = jax_envs(jspec, pts, spec.min_radius, spec.max_radius, spec.max_radius)
    q = np.random.default_rng(19).uniform(spec.limits_low, spec.limits_high,
                                          (512, 7)).astype(np.float32)
    want = np.asarray(jfkcc.fkcc(jspec, j_mvt_pck, jnp.asarray(q), use_pallas=False))
    assert 0 < want.sum() < len(q)
    for env in (j_mvt_pck, j_capt):
        leaves = env._asdict()
        for only in ("pck", "mvt", "capt"):
            if leaves.get(only) is None:
                continue
            port = convert.environment_from_numpy(
                {k: v for k, v in leaves.items() if k not in ("pck", "mvt", "capt") or k == only},
                "cpu")
            assert [getattr(port, k) is not None for k in ("mvt", "capt", "pck")] == [
                k == only for k in ("mvt", "capt", "pck")]
            got = fkcc.fkcc(spec, port, torch.as_tensor(q), device="cpu").numpy()
            np.testing.assert_array_equal(got, want, err_msg=only)


@pytest.mark.parametrize("kinds", [(), ("mvt",), ("capt",), ("pck",), ("mvt", "pck")])
def test_supports_matches_jax(kinds):
    """fkcc_cuda.supports is the JAX package's fkcc_pallas.supports: false
    only for an MVT or CAPT cloud without its kernel form, which the
    callers' dispatch (validate.fkcc_valid) sends to the plain version."""
    from vamp_mvt_tpu.ops.kernels import fkcc_pallas as jfp
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import validate

    radius = 0.25
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=radius)
    jspec = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=radius)
    pts = wall_points()
    tb, jb = envmod.EnvironmentBuilder(), jenvmod.EnvironmentBuilder()
    for b, classes in ((tb, pc_kernel.radius_classes(spec.sphere_radius)),
                       (jb, jradius_classes(jspec.sphere_radius))):
        b.add_sphere([0.0, 0.0, 5.0], 0.1)
        if "mvt" in kinds:
            b.add_mvt_pointcloud(pts, radius, radius, WMIN, WMAX, R_POINT)
        if "capt" in kinds:
            b.add_capt_pointcloud(pts, radius, radius, R_POINT)
        if "pck" in kinds:
            b.add_kernel_pointcloud(pts, classes, WMIN, WMAX, R_POINT, radius)
    env = tb.build(device="cpu")
    assert fkcc_cuda.supports(env) == jfp.supports(jb.build())
    assert fkcc_cuda.supports(env) == (kinds not in (("mvt",), ("capt",)))
    q = torch.as_tensor(np.random.default_rng(4).uniform(WMIN, WMAX, (1, 256, 3)),
                        dtype=torch.float32)
    envs = env.map(lambda t: t[None])
    assert torch.equal(validate.fkcc_valid(spec, envs, q),
                       fkcc_cuda.fkcc_batched_plain(spec, envs, q))
