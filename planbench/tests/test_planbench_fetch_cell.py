"""The `fetch_prim_suite` cell is found by name from `BENCHMARK.json`: its
configuration (the Fetch, its scene box, the port's own settings), its
traffic, its cell file, and a reader for every metric it reports."""

import json

from planbench import harness
from planbench.reference import robot as ref_robot

CELL = "fetch_prim_suite"


def test_the_fetch_cell_finds_its_files():
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(CELL, manifest)
    assert cell.workload["config"] == "fetch_mbm_prim" and cell.chips == 1
    entry = {c["name"]: c for c in manifest["configs"]}["fetch_mbm_prim"]
    assert entry["file"] == "planbench/configs/fetch_mbm_prim.json" and entry["reduced"] == []
    # a deployment of its own: no other configuration has its source and cuts
    assert all((c["source"], c["reduced"]) != (entry["source"], entry["reduced"])
               for c in manifest["configs"] if c["name"] != "fetch_mbm_prim")
    c = cell.config
    assert (c["robot"], c["obstacles"], c["planner"], c["retry_factor"]) == (
        "fetch", "primitives", "mega", 32)
    assert c["settings"] == {} and c["reduced"] == []
    assert c["scene_box"] == [[0.55, -0.6, 0.3], [1.25, 0.6, 1.5]]
    assert ref_robot.load(c["robot"]).dimension == 8
    assert cell.traffic == json.loads((harness.PLANBENCH / "traffic" / "mbm_suite.json")
                                      .read_text())
    assert cell.driver().Driver is not None
    assert set(cell.limits["limits"]) == {"verdict_gap_m2", "cost_rel_gap",
                                          "unsolved_valid_pct"}
    assert cell.limits["check"]["problems"] > 0


def test_the_fetch_cell_reports_the_suite_metrics():
    cell = harness.Cell(CELL)
    e2e = [m["name"] for m in cell.metrics(trace=False)]
    assert e2e == ["problems_per_s", "path_cost", "setup_s"]
    layer = {m["name"] for m in cell.metrics(trace=True)}
    panda = {m["name"] for m in harness.Cell("panda_prim_suite").metrics(trace=True)}
    assert layer == panda
    assert {"planner_fkcc_pct.suite", "planner_nn_pct.suite", "retry_live.suite",
            "planner_fill_pct.suite"} <= layer
    for name in layer | set(e2e):
        assert callable(harness.reader(name))
