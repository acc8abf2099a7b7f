"""A configuration, a traffic mix, a cell and a metric dropped into their
folders are found by name, with no edit to the harness; a configuration of
another robot places its own scenes."""

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from planbench import generator, harness
from planbench.reference import check, geometry
from planbench.reference import robot as ref_robot

HERE = Path(__file__).resolve().parents[1]


def _tree(tmp: Path) -> dict:
    """A copy of the benchmark's data folders under tmp, with one new file of
    each kind, and a manifest that names them."""
    for sub in ("configs", "traffic", "cells", "drivers", "metrics"):
        shutil.copytree(HERE / sub, tmp / "planbench" / sub)
    b = tmp / "planbench"
    (b / "configs" / "panda_new.json").write_text(json.dumps(
        {"name": "panda_new", "robot": "panda", "obstacles": "primitives"}))
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"driver": "tiny_driver", "problems": 3, "pool": 1}))
    (b / "cells" / "panda_new.tiny.json").write_text(json.dumps(
        {"check": {"requests": 1}, "limits": {"verdict_gap_m2": 1e-6}}))
    (b / "drivers" / "tiny_driver.py").write_text(
        "class Driver:\n    KIND = 'tiny'\n\n    def __init__(self, run):\n        pass\n")
    (b / "metrics" / "tiny_count.py").write_text(
        "def read(run):\n    return len(run.items)\n")
    manifest = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "panda_new", "source": "https://example.org",
                                "file": "planbench/configs/panda_new.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": "panda_new.tiny", "config": "panda_new",
                                  "traffic": "tiny_mix", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "tiny_count", "unit": "items", "better": "higher",
                                  "source": "program_counter", "layer": "suite runner",
                                  "moves": "setup_s", "workloads": ["panda_new.tiny"]})
    return manifest


def test_new_files_are_found_by_name(tmp_path):
    manifest = _tree(tmp_path)
    cell = harness.Cell("panda_new.tiny", manifest, root=tmp_path)
    assert cell.config["name"] == "panda_new"
    assert cell.traffic["driver"] == "tiny_driver"
    assert cell.limits["limits"] == {"verdict_gap_m2": 1e-6}
    assert cell.driver().Driver.KIND == "tiny"
    names = [m["name"] for m in cell.metrics(trace=True)]
    assert names == ["tiny_count"]
    assert "setup_s" in [m["name"] for m in cell.metrics(trace=False)]

    class _Run:
        items = [1, 2, 3]

    assert harness.reader("tiny_count", tmp_path)(_Run()) == 3


def test_a_fetch_cell_is_new_files_only(tmp_path, monkeypatch):
    """A Fetch suite cell from new files alone: a configuration naming the
    robot and its scene box, a traffic mix and a cell file.  The harness finds
    them, the generator places the scenes in the box with 8-joint endpoints
    that the reference finds free, and the suite driver hands the runner
    suites of the Fetch."""
    manifest = _tree(tmp_path)
    b = tmp_path / "planbench"
    box = [[0.55, -0.6, 0.3], [1.25, 0.6, 1.5]]
    (b / "configs" / "fetch_new.json").write_text(json.dumps(
        {"name": "fetch_new", "robot": "fetch", "obstacles": "primitives", "planner": "mega",
         "settings": {}, "scene_box": box}))
    (b / "traffic" / "fetch_tiny.json").write_text(json.dumps(
        {"driver": "suite", "problems": 5, "pool": 2}))
    (b / "cells" / "fetch_new.suite.json").write_text(json.dumps(
        {"check": {"problems": 10}, "limits": {"verdict_gap_m2": 1e-5}}))
    manifest["configs"].append({"name": "fetch_new", "source": "https://example.org",
                                "file": "planbench/configs/fetch_new.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": "fetch_new.suite", "config": "fetch_new",
                                  "traffic": "fetch_tiny", "chips": 1, "why": "test"})
    cell = harness.Cell("fetch_new.suite", manifest, root=tmp_path)
    assert cell.config["scene_box"] == box and cell.traffic["driver"] == "suite"
    assert cell.limits["check"] == {"problems": 10}
    assert "setup_s" in [m["name"] for m in cell.metrics(trace=False)]

    robot = ref_robot.load(cell.config["robot"])
    assert robot.name == "fetch" and robot.dimension == 8
    pool = generator.pool(robot, cell.traffic, cell.config, 2**31 + 9, "cpu")
    lo, hi = np.asarray(box)
    for probs in pool:
        assert len(probs) == 5
        starts, goals = [p["start"] for p in probs], [p["goals"][0] for p in probs]
        assert np.asarray(starts).shape == np.asarray(goals).shape == (5, 8)
        scene = ("obstacles", [geometry.obstacles(p) for p in probs])
        assert check.reference_valid(robot, starts, goals, scene, "cpu").all()
        centres = np.asarray([o["position"] for p in probs
                              for kind in ("sphere", "cylinder", "box") for o in p[kind]])
        assert ((centres >= lo) & (centres <= hi)).all()

    run = harness.Run(cell, 2**31 + 9, 0.0, False, torch.device("cpu"), 0.0)
    run.robot = robot
    drv = cell.driver().Driver(run)
    sent = []
    monkeypatch.setattr(drv, "_call", lambda data, **kw: sent.append(data))
    drv.setup(run)
    assert [s["robot"] for s in sent] == ["fetch"]
    assert [data["robot"] for data, _ in drv.suites] == ["fetch", "fetch"]
    assert sorted(p["start"] for p in drv.suites[0][1]) == sorted(p["start"] for p in pool[0])


def test_every_metric_of_the_manifest_has_a_reader():
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for w in manifest["workloads"]:
        cell = harness.Cell(w["name"], manifest)
        assert cell.metrics(False) and cell.metrics(True)
        assert "setup_s" in [m["name"] for m in cell.metrics(False)]
        assert hasattr(cell.driver(), "Driver")


def test_forbidden_names_compare_the_whole_top_level_name():
    mods = ["jax.numpy", "vamp_mvt_tpu.api", "vamp_mvt_tpu_torch.api", "jaxtyping", "flax",
            "numpy"]
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy", "vamp_mvt_tpu.api"]
    assert np.all([harness.forbidden_modules(["vamp_mvt_tpu_torch"]) == []])
