"""Port parity: public functions of modules ported before, on the CPU.

`validate.validate_vector`, `mvt.empty_mvt`, `native.available`,
`smat.identity`, `fkcc.attachment_collision`, `registry.spec_to_dict`,
`spec.rpy_matrix`, `spec.parse_urdf` (on a small spherized URDF written
here) and `spec.load_reference_data`, each against the JAX package's
function on the same inputs.  Exact, except collision decisions, which may
differ only within 1e-5 of contact (the fkcc tolerance of the other tests).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vamp_mvt_tpu import native as jnative
from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.collision import mvt as jmvt
from vamp_mvt_tpu.ops import fk as jfk
from vamp_mvt_tpu.ops import fkcc as jfkcc
from vamp_mvt_tpu.ops import smat as jsmat
from vamp_mvt_tpu.planning import validate as jvalidate
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu.robots import spec as jspec_mod
from vamp_mvt_tpu_torch import native
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.collision import mvt
from vamp_mvt_tpu_torch.ops import fk, fkcc, smat
from vamp_mvt_tpu_torch.planning import validate
from vamp_mvt_tpu_torch.robots import registry
from vamp_mvt_tpu_torch.robots import spec as spec_mod

BAND = 1e-5
CAGE = ((0.55, 0, 0.25), (0.35, 0.35, 0.25), (0, 0.55, 0.25), (-0.55, 0, 0.25),
        (-0.35, -0.35, 0.25), (0, -0.55, 0.25), (0.35, -0.35, 0.25), (0.35, 0.35, 0.8),
        (0, 0.55, 0.8), (-0.35, 0.35, 0.8), (-0.55, 0, 0.8), (-0.35, -0.35, 0.8),
        (0, -0.55, 0.8), (0.35, -0.35, 0.8))
PAYLOAD = [[0.0, 0.0, 0.12, 0.06], [0.0, 0.05, 0.2, 0.04]]


def _cage(mod, payload=False):
    b = mod.EnvironmentBuilder()
    for c in CAGE:
        b.add_sphere(c, 0.2)
    if payload:
        b.attach((envmod if mod is envmod else jfkcc).make_attachment(PAYLOAD))
    return b.build(device="cpu") if mod is envmod else b.build()


def _configs(spec, n, seed):
    return np.random.default_rng(seed).uniform(spec.limits_low, spec.limits_high,
                                               (n, spec.dimension)).astype(np.float32)


def test_validate_vector_matches_jax():
    spec, jspec = registry.load("panda"), jregistry.load("panda")
    env, jenv = _cage(envmod), _cage(jenvmod)
    a, b = _configs(spec, 48, 1), _configs(spec, 48, 2)
    b = a + 0.3 * (b - a)  # short segments, some free and some not
    v = b - a
    dist = np.linalg.norm(v, axis=1).astype(np.float32)
    num = validate.n_points_bound(spec, float(dist.max()))
    got = validate.validate_vector(spec, env.map(lambda t: t[None]), torch.from_numpy(a),
                                   torch.from_numpy(v), torch.from_numpy(dist), num).numpy()
    want = np.array([bool(jvalidate.validate_vector(jspec, jenv, jnp.asarray(a[i]),
                                                    jnp.asarray(v[i]), jnp.asarray(dist[i]), num))
                     for i in range(len(a))])
    assert got.any() and not got.all()
    # a segment whose points all lie off contact must be decided alike
    frac = validate.interpolation_fractions(spec, torch.from_numpy(dist), num)
    q = torch.from_numpy(a)[:, None] + torch.from_numpy(v)[:, None] * frac[..., None]
    vmin = fkcc.fkcc_vmin(spec, env.map(lambda t: t[None]), q)
    clear = (vmin.abs() > BAND).all(1).numpy()
    assert clear.sum() >= 40 and np.array_equal(got[clear], want[clear])


def test_empty_mvt_matches_jax():
    got, want = mvt.empty_mvt(), jmvt.empty_mvt()
    for f in mvt.MVTData._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f


def test_native_available_and_identity():
    assert native.available() is True and jnative.available() is True
    assert smat.identity() == jsmat.identity()


def test_native_available_false_without_the_library(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "missing.so")
    assert native.available() is False


def test_attachment_collision_matches_jax():
    spec, jspec = registry.load("panda"), jregistry.load("panda")
    env, jenv = _cage(envmod, True), _cage(jenvmod, True)
    q = _configs(spec, 512, 3)
    qt = torch.from_numpy(q)
    centers = fk.sphere_positions(spec, qt)
    got = fkcc.attachment_collision(spec, env, qt, centers).numpy()
    want = np.asarray(jfkcc.attachment_collision(
        jspec, jenv, jnp.asarray(q), jfk.sphere_positions(jspec, jnp.asarray(q))))
    clear = (fkcc.attachment_vmin(spec, env, qt, centers).abs() > BAND).numpy()
    assert got.any() and not got.all() and clear.sum() >= 500
    assert np.array_equal(got[clear], want[clear])


@pytest.mark.parametrize("robot", registry.ROBOTS)
def test_spec_to_dict_matches_jax(robot):
    d = registry.spec_to_dict(registry.load(robot))
    assert d == jregistry.spec_to_dict(jregistry.load(robot))
    back = registry.spec_from_dict(d)
    assert registry.spec_to_dict(back) == d


def test_rpy_matrix_matches_jax():
    for rpy in ((0, 0, 0), (0.3, -1.2, 2.5), (np.pi, np.pi / 2, -np.pi / 3)):
        assert np.array_equal(spec_mod.rpy_matrix(*rpy), jspec_mod.rpy_matrix(*rpy))


URDF = """<robot name="toy">
  <link name="base"><collision><geometry><sphere radius="0.1"/></geometry></collision></link>
  <link name="upper">
    <collision><origin xyz="0 0 0.1"/><geometry><sphere radius="0.05"/></geometry></collision>
    <collision><origin xyz="0 0 0.2"/><geometry><sphere radius="0.04"/></geometry></collision>
  </link>
  <link name="slider"><collision><geometry><sphere radius="0.03"/></geometry></collision></link>
  <link name="tool"/>
  <joint name="j2" type="prismatic"><parent link="upper"/><child link="slider"/>
    <origin xyz="0 0 0.3" rpy="0.1 0.2 0.3"/><axis xyz="0 0 1"/>
    <limit lower="0" upper="0.2"/></joint>
  <joint name="j1" type="revolute"><parent link="base"/><child link="upper"/>
    <origin xyz="0 0 0.05"/><axis xyz="0 1 0"/><limit lower="-1.5" upper="1.5"/></joint>
  <joint name="fixed_tool" type="fixed"><parent link="slider"/><child link="tool"/>
    <origin xyz="0.01 0 0"/></joint>
</robot>
"""


def _spec_fields(s):
    d = registry.spec_to_dict(s)
    d["frames"] = [tuple((k, np.asarray(v).tolist()) for k, v in f.items()) for f in d["frames"]]
    return d


@pytest.mark.parametrize("order", [None, ["j2", "j1"]])
def test_parse_urdf_matches_jax(tmp_path, order):
    path = tmp_path / "toy.urdf"
    path.write_text(URDF)
    kw = dict(self_collision_pairs=[[0, 3]], joint_order=order)
    got = spec_mod.parse_urdf(path, "toy", 16, "tool", **kw)
    want = jspec_mod.parse_urdf(path, "toy", 16, "tool", **kw)
    assert got.dimension == 2 and got.n_spheres == 4 and got.ee_frame == 3
    assert _spec_fields(got) == _spec_fields(want)
    with pytest.raises(ValueError, match="unsupported joint type"):
        bad = tmp_path / "bad.urdf"
        bad.write_text(URDF.replace('type="fixed"', 'type="floating"'))
        spec_mod.parse_urdf(bad, "toy", 16, "tool")


def test_load_reference_data_matches_jax():
    assert spec_mod.load_reference_data() == jspec_mod.load_reference_data()
