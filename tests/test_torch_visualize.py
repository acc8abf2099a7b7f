"""Headless smoke tests of the port's matplotlib plots (`visualize.py`).

Mirrors tests/test_visualize.py through the port: render an MBM problem with
a solved path and a pointcloud to a png, plot joint trajectories and a
roadmap, plot a workspace with a heightfield.  The plots take tensors as
well as arrays; the ones that compute run on the GPU unless the caller
passes device="cpu", as here; the end-effector traces come from the port's FK, held
against the JAX package's here.  The result records equal the JAX
package's on the same numbers.  PyBullet is not installed: the visualizer
raises its ImportError.
"""

import numpy as np
import pytest
import torch

from vamp_mvt_tpu import visualize as jvisualize
from vamp_mvt_tpu_torch import visualize
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.planning import rrtc
from vamp_mvt_tpu_torch.robots import registry

from test_visualize import _toy_problem

CPU = "cpu"


def test_render_problem_writes_png(tmp_path):
    problem = _toy_problem()
    path = torch.tensor(np.stack([problem["start"], problem["goals"][0]]), dtype=torch.float32)
    pc = np.random.default_rng(0).uniform(-0.5, 0.5, (50, 3)).astype(np.float32)
    out = visualize.render_problem(
        "panda", problem, path=path, path_length=torch.tensor(2), pointcloud=pc,
        out_path=str(tmp_path / "scene.png"), device=CPU,
    )
    f = tmp_path / "scene.png"
    assert str(out) == str(f) and f.exists() and f.stat().st_size > 1000


def test_plot_joint_trajectories_and_roadmap(tmp_path):
    path = np.cumsum(np.random.default_rng(1).normal(0, 0.1, (7, 5)), axis=0).astype(np.float32)
    visualize.plot_joint_trajectories(torch.from_numpy(path), path_length=7,
                                      out_path=str(tmp_path / "traj.png"))
    assert (tmp_path / "traj.png").exists()

    class RM:
        vertices = np.random.default_rng(2).uniform(-1, 1, (20, 3)).astype(np.float32)
        edges = [(i, (i + 1) % 20) for i in range(20)]

    visualize.plot_roadmap(RM(), out_path=str(tmp_path / "rm.png"))
    assert (tmp_path / "rm.png").stat().st_size > 1000


def test_plot_workspace_heightfield(tmp_path):
    spec = registry.sphere_spec(lows=(-2, -2, 0), highs=(2, 2, 4), radius=0.2)
    grid = np.abs(np.random.default_rng(3).normal(0.5, 0.2, (8, 8))).astype(np.float32)
    meta, data = envmod.make_heightfield((0, 0, 0), (0.4, 0.4, 1.0), grid)
    b = envmod.EnvironmentBuilder().add_heightfield(meta, data)
    b.add_capsule(envmod.make_capsule_center([0.5, 0.5, 1.0], [0.2, 0.1, 0.0], 0.1, 0.5))
    visualize.plot_workspace(spec, b, paths=[torch.zeros(3, 3)], out_path=str(tmp_path / "ws.png"),
                             device=CPU)
    assert (tmp_path / "ws.png").exists()


def test_workspace_traces_match_jax(monkeypatch):
    """The end-effector points plot_workspace draws for a Panda path equal
    the JAX package's (FK within 1e-5)."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.axes3d import Axes3D

    from vamp_mvt_tpu.robots import registry as jregistry

    drawn = {}

    def record(mod):
        def plot(self, *args, **kw):
            if kw.get("markersize") == 2:
                drawn[mod] = np.stack(args[:3], -1)
            return []
        return plot

    path = np.stack([_toy_problem()["start"], _toy_problem()["goals"][0]]).astype(np.float32)
    for mod, s in ((visualize, registry.load("panda")), (jvisualize, jregistry.load("panda"))):
        monkeypatch.setattr(Axes3D, "plot", record(mod))
        kw = {"device": CPU} if mod is visualize else {}
        plt.close(mod.plot_workspace(s, None, paths=[path], n_samples=12, **kw))
    assert drawn[visualize].shape == (12, 3)
    np.testing.assert_allclose(drawn[visualize], drawn[jvisualize], atol=1e-5)


def test_results_records_match_jax():
    res = rrtc.RRTCResult(
        solved=torch.tensor(True), path=torch.zeros(4, 3), path_length=torch.tensor(3),
        cost=torch.tensor(2.5), iterations=torch.tensor(17), size_start=torch.tensor(5),
        size_goal=torch.tensor(6), sample_count=torch.tensor(17))
    as_np = type(res)(*(t.numpy() for t in res))
    assert visualize.results_to_dict(res) == jvisualize.results_to_dict(as_np)
    res = res._replace(solved=torch.tensor(False))
    rec = visualize.results_to_dict(res)
    assert rec["initial_path_cost"] == float("inf") and rec["planning_graph_size"] == 11

    class Suite:
        names = [("cage", 0), ("cage", 1)]
        valid = np.array([True, True])
        plan = rrtc.RRTCResult(*(torch.stack([t, t]) for t in res))
        simplified = plan

    df = visualize.results_dataframe(Suite())
    assert list(df.columns) == list(jvisualize.results_dataframe(Suite()).columns)
    assert df["planning_graph_size"].tolist() == [11, 11]


def test_entry_points_default_to_the_gpu(tmp_path):
    """plot_workspace and render_problem build the environment and run FK
    on the GPU unless the caller names a device: without one they raise
    rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    spec = registry.sphere_spec(lows=(-2, -2, 0), highs=(2, 2, 4), radius=0.2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualize.plot_workspace(spec, envmod.EnvironmentBuilder(), paths=[torch.zeros(3, 3)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualize.render_problem("panda", _toy_problem(), out_path=str(tmp_path / "x.png"))
    assert not (tmp_path / "x.png").exists()


def test_pybullet_visualizer_needs_pybullet():
    try:
        import pybullet  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="pybullet is not installed"):
            visualize.PyBulletVisualizer()
    else:
        pytest.skip("pybullet is installed")
