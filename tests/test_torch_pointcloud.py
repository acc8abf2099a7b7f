"""Port parity: pointcloud sampling, filters and structures.

The same seeded inputs go through the JAX package and the port:

- sampling of cylinder and box surfaces: bit-identical clouds (the legacy
  `np.random.seed(0)` call order);
- the SCDF and center-voxel filters, native (the C++ library) and numpy
  routes: identical kept points;
- `build_mvt`, `build_capt` (native and numpy) and `build_pc_kernel`
  (native and numpy): every array equal (NaN where both have NaN);
- `mvt_collides` / `capt_collides`: identical decisions on seeded spheres,
  including the MVT radius clamp and CAPT clouds of 1-100 points;
- `problem_to_pointcloud_env`: the same clouds, timings aside, and the same
  structures, for MVT and CAPT;
- stacking pointcloud environments pads the kernel form's chunks to the
  batch's largest and keeps each problem's live chunk count.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.collision import capt as jcapt
from vamp_mvt_tpu.collision import mvt as jmvt
from vamp_mvt_tpu.collision import pc_kernel as jpck
from vamp_mvt_tpu.pointcloud import filters as jfilters
from vamp_mvt_tpu.pointcloud import pipeline as jpipeline
from vamp_mvt_tpu.pointcloud import sampling as jsampling
from vamp_mvt_tpu_torch import native
from vamp_mvt_tpu_torch.collision import capt, mvt, pc_kernel
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.pointcloud import filters, pipeline, sampling
from vamp_mvt_tpu_torch.robots import registry

R_POINT = 0.0025
ORIGIN, LO, HI = [0.0, 0.0, 0.0], [-1.19] * 3, [1.19] * 3


def scene(seed: int) -> dict:
    """A small MBM-shaped problem: cylinders (euler and quaternion poses) and
    boxes around the Panda's workspace."""
    rng = np.random.default_rng(seed)
    p = {"sphere": [], "cylinder": [], "box": []}
    for j in range(3):
        pose = ({"orientation_euler_xyz": rng.uniform(-np.pi, np.pi, 3).tolist()} if j % 2
                else {"orientation_quat_xyzw": [0.0, 0.0, 0.0, 1.0]})
        p["cylinder"].append({"position": rng.uniform([0.2, -0.6, 0.0], [0.9, 0.6, 1.2]).tolist(),
                              "radius": float(rng.uniform(0.02, 0.06)),
                              "length": float(rng.uniform(0.1, 0.4)), **pose})
    for j in range(4):
        e = rng.uniform(-np.pi, np.pi, 3) if j % 2 else np.array([0.0, 0.0, 1.0])
        p["box"].append({"position": rng.uniform([0.2, -0.6, 0.0], [0.9, 0.6, 1.2]).tolist(),
                         "orientation_euler_xyz": e.tolist(),
                         "half_extents": rng.uniform(0.02, 0.3, 3).tolist()})
    return p


def assert_same_struct(jax_st, port_st):
    for f in port_st._fields:
        a, b = np.asarray(getattr(jax_st, f)), np.asarray(getattr(port_st, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_sampling_bit_identical(seed):
    p = scene(seed)
    want = jsampling.problem_to_pointcloud(p, 1500)
    got = sampling.problem_to_pointcloud(p, 1500)
    assert got.shape == want.shape == (7 * 1500, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["scdf", "centervox"])
@pytest.mark.parametrize("use_native", [True, False])
def test_filters_match_jax(kind, use_native):
    cloud = sampling.problem_to_pointcloud(scene(2), 1500)
    if kind == "scdf":
        args = (cloud, 0.02, 1.19, ORIGIN, LO, HI)
        want = jfilters.filter_scdf(*args, True, use_native=use_native)
        got = filters.filter_scdf(*args, True, use_native=use_native)
    else:
        args = (cloud, 0.0308, 1.19, ORIGIN, LO, HI)
        want = jfilters.filter_centervox(*args, use_native=use_native)
        got = filters.filter_centervox(*args, use_native=use_native)
    assert 0 < len(got) < len(cloud)
    np.testing.assert_array_equal(got, want)


def test_filter_routes_agree():
    cloud = sampling.problem_to_pointcloud(scene(3), 1500)
    args = (cloud, 0.02, 1.19, ORIGIN, LO, HI, True)
    np.testing.assert_array_equal(filters.filter_scdf(*args, use_native=True),
                                  filters.filter_scdf(*args, use_native=False))


def _filtered(seed=4, n=1500):
    cloud = sampling.problem_to_pointcloud(scene(seed), n)
    return filters.filter_scdf(cloud, 0.02, 1.19, ORIGIN, LO, HI, True, use_native=True)


def test_build_mvt_matches_jax():
    pts = _filtered()
    spec = registry.load("panda")
    args = (pts, spec.min_radius, spec.max_radius, LO, HI, R_POINT)
    assert_same_struct(jmvt.build_mvt(*args), mvt.build_mvt(*args))
    assert_same_struct(jmvt.build_mvt(*args, pad_voxels=900, pad_capacity=40),
                       mvt.build_mvt(*args, pad_voxels=900, pad_capacity=40))


@pytest.mark.parametrize("use_native", [True, False])
def test_build_capt_matches_jax(use_native):
    pts = _filtered()
    spec = registry.load("panda")
    args = (pts, spec.min_radius, spec.max_radius, R_POINT)
    want = jcapt.build_capt(*args, use_native=use_native)
    got = capt.build_capt(*args, use_native=use_native)
    assert_same_struct(want, got)


@pytest.mark.parametrize("use_native", [True, False])
def test_build_pc_kernel_matches_jax(use_native, monkeypatch):
    pts = _filtered()
    spec = registry.load("panda")
    classes = pc_kernel.radius_classes(spec.sphere_radius)
    np.testing.assert_array_equal(classes, jpck.radius_classes(spec.sphere_radius))
    if not use_native:
        # the JAX package takes its scipy route only without the library
        from vamp_mvt_tpu import native as jnative

        monkeypatch.setattr(jnative, "voxel_mindist2", lambda *a: None)
    want = jpck.build_pc_kernel(pts, classes, LO, HI, R_POINT, spec.max_radius,
                                pad_chunks=300)
    got = pc_kernel.build_pc_kernel(pts, classes, LO, HI, R_POINT, spec.max_radius,
                                    pad_chunks=300, use_native=use_native)
    assert_same_struct(want, got)
    assert int(got.meta[0, 6]) == (len(pts) + pc_kernel.CS - 1) // pc_kernel.CS
    assert got.chunks.shape == (300, 8) and got.bitmap.shape[1] == 128
    # both halves of the bitmap hold set bits
    half = got.bitmap.shape[0] // 2
    assert got.bitmap[:half].any() and got.bitmap[half:].any()


def test_sphere_table_matches_jax():
    from vamp_mvt_tpu.ops.kernels import fkcc_pallas
    from vamp_mvt_tpu.robots import registry as jregistry

    for robot in ("panda", "fetch", "baxter", "sphere"):
        np.testing.assert_array_equal(
            pc_kernel.sphere_table(registry.load(robot).sphere_radius),
            fkcc_pallas._sphere_table(jregistry.load(robot)))


def _spheres(rng, n, lo, hi, r_lo, r_hi):
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.uniform(r_lo, r_hi, n).astype(np.float32))


def _port_query(fn, st, p, r):
    st_t = envmod.tree_map(torch.as_tensor, st)
    return fn(st_t, torch.as_tensor(p), torch.as_tensor(r)).numpy()


@pytest.mark.parametrize("case", ["brute", "clamp"])
def test_mvt_collides_matches_jax(case):
    rng = np.random.default_rng(3 if case == "brute" else 4)
    points = rng.uniform(-1.0, 1.0, (2000 if case == "brute" else 500, 3)).astype(np.float32)
    if case == "brute":
        st = mvt.build_mvt(points, 0.01, 0.08, [-1, -1, -1], [1, 1, 1], R_POINT)
        p, r = _spheres(rng, 500, -1.2, 1.2, 0.005, 0.075)
    else:  # queries above max_radius: the window is clamped to one cell
        st = mvt.build_mvt(points, 0.01, 0.1, [-1, -1, -1], [1, 1, 1], R_POINT)
        p = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
        r = np.full(100, 0.05, np.float32)
    jst = jmvt.MVTData(*(jnp.asarray(a) for a in st))
    want = np.asarray(jmvt.mvt_collides(jst, jnp.asarray(p), jnp.asarray(r)))
    got = _port_query(mvt.mvt_collides, st, p, r)
    assert 0 < want.sum() < len(p)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 1000])
def test_capt_collides_matches_jax(n):
    rng = np.random.default_rng(6 + n)
    points = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    st = capt.build_capt(points, 0.01, 0.1, R_POINT)
    jst = jcapt.build_capt(points, 0.01, 0.1, R_POINT)
    assert_same_struct(jst, st)
    p, r = _spheres(rng, 400, -1.2, 1.2, 0.01, 0.09)
    if n < 100:  # make sure some queries touch a point
        p[:n] = points
    want = np.asarray(jcapt.capt_collides(jst, jnp.asarray(p), jnp.asarray(r)))
    got = _port_query(capt.capt_collides, st, p, r)
    assert want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pc_repr", ["mvt", "capt"])
def test_pipeline_matches_jax(pc_repr):
    p = scene(5)
    jb, jo, jf, _, _ = jpipeline.problem_to_pointcloud_env(
        "panda", p, pc_repr=pc_repr, samples_per_object=1500)
    tb, to, tf, f_ns, b_ns = pipeline.problem_to_pointcloud_env(
        "panda", p, pc_repr=pc_repr, samples_per_object=1500)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tf, jf)
    assert f_ns > 0 and b_ns > 0
    assert_same_struct(getattr(jb, pc_repr), getattr(tb, pc_repr))
    assert_same_struct(jb.pck, tb.pck)


def test_native_raises_when_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "missing.so")
    cloud = sampling.problem_to_pointcloud(scene(6), 200)
    with pytest.raises(RuntimeError, match="use_native=False"):
        filters.filter_scdf(cloud, 0.02, 1.19, ORIGIN, LO, HI, True, use_native=True)
    # the numpy route needs no library
    assert len(filters.filter_scdf(cloud, 0.02, 1.19, ORIGIN, LO, HI, True,
                                   use_native=False)) > 0


def test_stack_pads_kernel_pointclouds():
    spec = registry.load("panda")
    classes = pc_kernel.radius_classes(spec.sphere_radius)
    envs = []
    for seed, n in ((7, 400), (8, 1500)):
        b = envmod.EnvironmentBuilder()
        b.add_kernel_pointcloud(_filtered(seed, n), classes, LO, HI, R_POINT, spec.max_radius)
        envs.append(b.build(device="cpu"))
    live = [int(e.pck.meta[0, 6]) for e in envs]
    nch = [e.pck.chunks.shape[0] for e in envs]
    stacked = envmod.stack_environments(envs)
    assert stacked.pck.chunks.shape == (2, max(nch), 8)
    assert stacked.pck.points.shape == (2, max(nch), 3 * pc_kernel.CS)
    assert stacked.pck.meta[:, 0, 6].tolist() == live
    small = int(np.argmin(nch))
    torch.testing.assert_close(stacked.pck.chunks[small, :nch[small]], envs[small].pck.chunks)
    assert bool((stacked.pck.chunks[small, nch[small]:, :3] >= 1e7).all())
    # indexing and device moves walk the structures
    one = stacked.map(lambda t: t[1:])
    assert one.pck.bitmap.shape[0] == 1 and one.mvt is None
    # another voxel grid (W) cannot share a batch
    b = envmod.EnvironmentBuilder()
    b.add_kernel_pointcloud(_filtered(7, 400), classes, LO, HI, R_POINT, 0.5)
    with pytest.raises(ValueError, match="voxel grid"):
        envmod.stack_environments([envs[0], b.build(device="cpu")])
