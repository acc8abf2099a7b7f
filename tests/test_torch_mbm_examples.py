"""The port's other MBM-file examples against the JAX scripts on the CPU:
`prepare_query_dataset` and `visualize_mbm` (`evaluate_mbm_mpnet` is in
test_torch_evaluate_mbm_mpnet.py, so that xdist runs the two side by side).

Both packages read the synthetic MBM tarball (`bench/scenes.py::
write_mbm_tarball`, both RESOURCES pointed at it).

- `prepare_query_dataset`: the same files; clouds, radii and `collides`
  equal, query centres (the port's FK against JAX's) within 1e-5.
- `visualize_mbm`: the arrays each script draws, read from every figure as
  it is saved (each line's points, each scatter's points), equal within
  1e-5 (the planned paths and the end-effector traces come from each
  package's planner and FK), in the same order, with the same titles and
  the same printed lines but for the timings.
"""

import json
import re

import matplotlib
import numpy as np
import pytest
import torch
from matplotlib.figure import Figure

from vamp_mvt_tpu_torch.bench import scenes
from vamp_mvt_tpu_torch.examples import prepare_query_dataset, visualize_mbm

from test_torch_evaluate_mbm import point_caches, run_jax_script

matplotlib.use("Agg")
torch.set_num_threads(2)
ATOL = 1e-5


@pytest.fixture
def tarball(monkeypatch, tmp_path):
    scenes.write_mbm_tarball(tmp_path / "res")
    point_caches(monkeypatch, tmp_path, resources=tmp_path / "res")
    return tmp_path


def test_prepare_query_dataset_matches_jax(monkeypatch, capsys, tarball):
    args = ["--problem", "box", "--count", "2"]
    got = prepare_query_dataset.main([*args, "--out", str(tarball / "port")], device="cpu")
    capsys.readouterr()
    jout = run_jax_script(monkeypatch, capsys, "prepare_query_dataset",
                          [*args, "--out", str(tarball / "jax")])
    assert json.loads(jout.strip().splitlines()[-1])["written"] == got["written"] == 2
    for i in range(2):
        a = np.load(tarball / "port" / f"box_{i}.npz")
        b = np.load(tarball / "jax" / f"box_{i}.npz")
        assert set(a.files) == set(b.files)
        for k in ("pointcloud", "query_radii", "collides"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["query_centers"], b["query_centers"], atol=ATOL)
        assert 0 < int(a["collides"].sum()) < a["collides"].size  # both outcomes


def _drawn(fig) -> dict:
    """What a figure draws: each axis's title, line points and scatter
    points, in drawing order."""
    out = []
    for ax in fig.axes:
        lines = [np.column_stack(l.get_data_3d()) if hasattr(l, "get_data_3d")
                 else np.asarray(l.get_xydata()) for l in ax.lines]
        scat = [np.column_stack(c._offsets3d) if hasattr(c, "_offsets3d")
                else np.asarray(c.get_offsets()) for c in ax.collections]
        out.append({"title": ax.get_title(), "lines": lines, "scatter": scat})
    return out


@pytest.fixture
def drawn(monkeypatch):
    figs = []
    save = Figure.savefig

    def capture(fig, *a, **k):
        figs.append(_drawn(fig))
        return save(fig, *a, **k)

    monkeypatch.setattr(Figure, "savefig", capture)
    return figs


@pytest.mark.parametrize("extra", [[], ["--pointcloud", "--samples_per_object", "500"]],
                         ids=["primitives", "pointcloud"])
def test_visualize_mbm_matches_jax(monkeypatch, capsys, tarball, drawn, extra):
    args = ["--problem", "cage", "--index", "2", *extra]
    got = visualize_mbm.main([*args, "--out", str(tarball / "port")], device="cpu")
    out = capsys.readouterr().out
    port_figs = list(drawn)
    drawn.clear()
    jout = run_jax_script(monkeypatch, capsys, "visualize_mbm",
                          [*args, "--out", str(tarball / "jax")])
    assert got["solved"] and len(got["path"]) >= 2
    for f in got["images"]:
        assert (tarball / f).stat().st_size > 1000
    strip = lambda s: re.sub(r"\d+\.\d+ ms", "", s).replace(str(tarball / "jax"), "P")
    assert strip(out.replace(str(tarball / "port"), "P")) == strip(jout)
    assert len(port_figs) == len(drawn) == 2
    for pf, jf in zip(port_figs, drawn):
        assert [a["title"] for a in pf] == [a["title"] for a in jf]
        for pa, ja in zip(pf, jf):
            assert len(pa["lines"]) > 0
            for kind in ("lines", "scatter"):
                assert len(pa[kind]) == len(ja[kind]), kind
                for x, y in zip(pa[kind], ja[kind]):
                    assert x.shape == y.shape
                    np.testing.assert_allclose(x, y, atol=ATOL)
