"""A configuration, a traffic mix, a cell and a metric dropped into their
folders are found by name, with no edit to the harness."""

import json
import shutil
from pathlib import Path

import numpy as np

from planbench import harness

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
