"""The port's API examples (`vamp_mvt_tpu_torch/examples/`) on the CPU,
against the JAX package's scripts (`examples/`), with the rules and
tolerances of test_torch_examples.py: the random dance and the payload demo
through the user API, the flying sphere's PRM and roadmap at the JAX
script's sizes (the obstacle row: the maze file is absent).
"""

import re

import numpy as np
import torch

import vamp_mvt_tpu_torch as vmt
from vamp_mvt_tpu_torch.examples import attachments, flying_sphere, random_dance
from vamp_mvt_tpu_torch.examples import sphere_cage_example

from test_torch_examples import CPU, ROUNDED, RTOL, _jax_stdout

torch.set_num_threads(2)


def test_random_dance(capsys):
    out = random_dance.main(2, device=CPU)
    assert len(out) == 2 and all(r["solved"] for r in out)

    rounds = re.findall(r"round (\d+): (ok|FAILED) cost=(\S+)", _jax_stdout(capsys, "random_dance", 2))
    assert [int(i) for i, _, _ in rounds] == [0, 1]
    for r, (_, status, cost) in zip(out, rounds):
        assert r["solved"] == (status == "ok")
        assert abs(r["cost"] - float(cost)) <= ROUNDED


def test_attachments(capsys):
    out = attachments.main(device=CPU)
    assert out["solved"] and out["simplified_cost"] <= out["cost"] + 1e-6
    env = vmt.Environment()
    for c in sphere_cage_example.CAGE:
        env.add_sphere(vmt.Sphere(c, 0.2))
    env.attach(vmt.Attachment(spheres=[[0.0, 0.0, 0.12, 0.06]]))
    path = out["path"]
    assert np.allclose(path[0], sphere_cage_example.A) and np.allclose(path[-1],
                                                                       sphere_cage_example.B)
    for a, b in zip(path[:-1], path[1:]):
        assert vmt.panda.validate_motion(a, b, env, device=CPU)

    text = _jax_stdout(capsys, "attachments")
    solved, cost = re.search(r"solved: (\w+) cost: (\S+)", text).groups()
    simp_cost, vertices = re.search(r"simplified cost: (\S+) vertices: (\d+)", text).groups()
    assert out["solved"] == (solved == "True")
    np.testing.assert_allclose(out["cost"], float(cost), rtol=RTOL)
    np.testing.assert_allclose(out["simplified_cost"], float(simp_cost), rtol=RTOL)
    assert out["simplified_vertices"] == int(vertices)


def test_flying_sphere(capsys):
    out = flying_sphere.main(device=CPU)  # the JAX script's sizes: 2048 samples, 512
    assert out["solved"] and out["cost"] >= np.sqrt(128.0) - 1e-4  # the straight line
    assert out["roadmap_vertices"] >= 2 and out["roadmap_edges"] > 0

    text = _jax_stdout(capsys, "flying_sphere")
    solved, cost, nodes = re.search(r"solved: (\w+) cost: (\S+) nodes: (\d+)", text).groups()
    vertices, edges = map(int, re.search(r"roadmap: (\d+) vertices, (\d+) edges", text).groups())
    assert out["solved"] == (solved == "True") and out["nodes"] == int(nodes)
    np.testing.assert_allclose(out["cost"], float(cost), rtol=RTOL)
    assert (out["roadmap_vertices"], out["roadmap_edges"]) == (vertices, edges)
