"""The port's profiling utilities (`utils/profiling.py`) on the CPU.

`trace` writes a Chrome trace of a plain fkcc call (the fkcc kernel's plain
version: the port's wrapper on a CPU tensor) and `op_breakdown` sums its
complete events by name, as the JAX package's `op_breakdown` sums a
profiler trace: on the same events both give the same rows.  `device_timer`
measures the block in ns.

The port's spans and counts: with no recorder a span records nothing and
opens no profiler range; under one, spans nest with their parents and share
the call's id, appear under `torch.profiler` as `vmt.*` host ranges inside
the caller's, and counts stay tensors until `read_counts` copies them once.
`run_suite_pointcloud` on two CPU problems: its five pc_* spans cover the
pointcloud phase within 5%.  The benchmark's readers of the new keys read
them, and read nothing where a runner has none.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from vamp_mvt_tpu.utils import profiling as jprofiling
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.robots import registry
from vamp_mvt_tpu_torch.utils import profiling


def test_trace_and_op_breakdown_of_a_plain_fkcc_call(tmp_path):
    spec = registry.load("panda")
    b = envmod.EnvironmentBuilder()
    b.add_sphere([0.5, 0.0, 0.5], 0.2)
    envs = b.build(device="cpu").map(lambda t: t[None])
    q = torch.as_tensor(np.random.default_rng(0).uniform(
        spec.limits_low, spec.limits_high, (1, 32, 7)), dtype=torch.float32)
    timed = {}
    with profiling.device_timer(timed, device="cpu"):
        with profiling.trace(str(tmp_path)):
            ok = fkcc_cuda.fkcc_batched(spec, envs, q)
    assert ok.shape == (1, 32) and timed["nanoseconds"] > 0
    rows = profiling.op_breakdown(str(tmp_path), top=10)
    assert 0 < len(rows) <= 10
    names = [r[0] for r in rows]
    assert "aten::mul" in names  # the plain version's FK products
    assert all(r[1] >= 0 and r[2] >= 1 for r in rows)
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)


def test_op_breakdown_sums_as_the_jax_function(tmp_path):
    rng = np.random.default_rng(1)
    events = [{"ph": "X", "name": f"op{rng.integers(5)}", "dur": float(rng.uniform(1, 50)),
               "ts": i} for i in range(200)]
    events += [{"ph": "B", "name": "op0", "ts": 0}, {"ph": "X", "name": "nodur"}]
    run = tmp_path / "jax" / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    with gzip.open(run / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    (tmp_path / "port").mkdir()
    (tmp_path / "port" / "trace.json").write_text(json.dumps({"traceEvents": events}))
    want = jprofiling.op_breakdown(str(tmp_path / "jax"), top=3)
    got = profiling.op_breakdown(str(tmp_path / "port"), top=3)
    assert got == want and len(got) == 3


def test_device_timer_defaults_to_the_gpu():
    if torch.cuda.is_available():
        return
    try:
        with profiling.device_timer({}):
            pass
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("device_timer ran without a device")


# --- the port's spans and counts (utils/profiling.py: recording, span, count)


def _vmt_events(prof):
    return [e for e in prof.events() if e.name.startswith("vmt.")]


def test_span_without_a_recorder_records_nothing():
    from torch.profiler import ProfilerActivity, profile

    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    into = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording(None):
            with profiling.span("plan"):
                torch.ones(4).sum()
            profiling.count("n", torch.ones(3).sum())
            profiling.read_counts()
        with profiling.span("plan"):
            torch.ones(4).sum()
    assert not _vmt_events(prof) and into == {}
    assert not profiling.counting()


def test_spans_nest_and_share_the_call_id():
    into = {}
    with profiling.recording(into) as rec:
        with profiling.span("pointcloud"):
            with profiling.span("pc_sample"):
                assert rec.stack == ["pointcloud", "pc_sample"]
            for _ in range(2):
                with profiling.span("pc_stage"):
                    pass
        with profiling.span("plan"):
            pass
    spans = into["spans"]
    assert [(s[1], s[2]) for s in spans] == [
        ("pc_sample", "pointcloud"), ("pc_stage", "pointcloud"), ("pc_stage", "pointcloud"),
        ("pointcloud", None), ("plan", None)]
    assert {s[0] for s in spans} == {rec.request_id}
    assert all(s[3] <= s[4] for s in spans)
    outer = spans[3]
    assert all(outer[3] <= s[3] and s[4] <= outer[4] for s in spans[:3])
    assert into["pc_stage"] == pytest.approx(sum(s[4] - s[3] for s in spans[1:3]))
    assert into["pointcloud"] >= into["pc_sample"] + into["pc_stage"]
    other = {}
    with profiling.recording(other):
        with profiling.span("plan"):
            pass
    assert other["spans"][0][0] != rec.request_id
    assert not profiling.counting()


def test_spans_are_host_ranges_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    into = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("pb:run_suite"):
            with profiling.recording(into):
                with profiling.span("build_batch"):
                    with profiling.span("batch_assemble"):
                        torch.ones(8).cumsum(0)
                with profiling.span("plan"):
                    torch.ones(8).sum()
    got = _vmt_events(prof)
    assert sorted(e.name for e in got) == ["vmt.batch_assemble", "vmt.build_batch", "vmt.plan"]
    outer = [e for e in prof.events() if e.name == "pb:run_suite"][0].time_range
    for e in got:
        assert outer.start <= e.time_range.start <= e.time_range.end <= outer.end
    build = [e for e in got if e.name == "vmt.build_batch"][0].time_range
    inner = [e for e in got if e.name == "vmt.batch_assemble"][0].time_range
    assert build.start <= inner.start <= inner.end <= build.end


def test_count_sums_tensors_and_reads_them_once(monkeypatch):
    into = {}
    with profiling.recording(into) as rec:
        for k in range(3):
            profiling.count("retry_live", torch.tensor(k + 1))
        profiling.count("planner_block_ns", torch.tensor(7, dtype=torch.int64))
        profiling.count("planner_block_ns", 5)
        profiling.count("lockstep", 2)
        assert isinstance(rec.counts["retry_live"], torch.Tensor)
        assert "retry_live" not in into and "planner_block_ns" not in into
        reads = []
        orig = torch.Tensor.tolist
        monkeypatch.setattr(torch.Tensor, "tolist", lambda t: reads.append(1) or orig(t))
        profiling.read_counts()
        assert len(reads) == 1  # one copy to the host for every tensor count
        assert rec.counts == {}
        profiling.count("retry_live", torch.tensor(4))
    assert into["retry_live"] == 10.0 and into["planner_block_ns"] == 12.0
    assert into["lockstep"] == 2.0


def test_a_recorder_without_counts_keeps_its_spans():
    into = {}
    with profiling.recording(into, counts=False):
        assert not profiling.counting()
        with profiling.span("plan"):
            profiling.count("retry_live", torch.tensor(3))
        profiling.read_counts()
    assert "retry_live" not in into and into["plan"] >= 0.0
    assert [x[1] for x in into["spans"]] == ["plan"]
    with profiling.recording({}):
        assert profiling.counting()


def test_mega_solver_counts_the_retry_launch_only():
    """The mega path's solve_batch under a recorder counts retry_live and
    asks plan_fn (plan_batch_mega) to count retry_iter_us and retry_blocks
    for the retry launch alone, which plans the unsolved rows alone (a
    stand-in plan_fn on the CPU that returns as many rows as it is given
    and counts its blocks as a launch at cluster size 2 would)."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.planning import rrtc

    B, d = 4, 7
    calls = []

    def plan_fn(e, s_, g, m, budget, iter_count=None, block_count=None):
        n = s_.shape[0]
        retry = bool(calls)
        calls.append((n, budget, iter_count, block_count))
        if block_count is not None:
            profiling.count(block_count, 2 * n)
        ones = torch.ones(n, dtype=torch.int32)
        solved = torch.tensor([True, False, True, False]) | retry
        return rrtc.RRTCResult(solved[:n], s_[:, None].expand(n, 2, d).clone(), 2 * ones,
                               torch.zeros(n), (100 + 900 * retry) * ones, ones, ones, ones)

    settings = mbm.default_settings("panda", "mega")
    solve = mbm._mega_solver(plan_fn, settings, 32, lambda: None)
    s_ = torch.arange(B, dtype=torch.float32)[:, None].expand(B, d).contiguous()
    g, m = torch.ones(B, 1, d), torch.ones(B, 1, dtype=torch.bool)
    e = envmod.broadcast_environment(envmod.EnvironmentBuilder().build(device="cpu"), B)
    into = {}
    with profiling.recording(into):
        got = solve(e, s_, g, m)
    assert bool(got.solved.all())
    assert got.iterations.tolist() == [100, 1000, 100, 1000]
    assert torch.equal(got.path[:, 0], s_)  # each retried row written back to its place
    budget = settings.max_iterations
    assert calls == [(B, budget, None, None), (2, 32 * budget, "retry_iter_us", "retry_blocks")]
    assert into["retry_live"] == 2.0 and into["retry_blocks"] == 4.0
    assert _reader("retry_cluster_k.suite")(_Run([{"timings": into}])) == 2.0


def test_slowest_iter_us_reads_the_slowest_block():
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc_mega

    t = rrtc_mega_cuda.WORK + len(rrtc_mega_cuda.PHASES)
    work = torch.zeros((3, rrtc_mega_cuda.WORK_COLS), dtype=torch.int64)
    work[:, t] = torch.tensor([5, 7, 9])
    work[:, t + 1] = torch.tensor([5 + 23_000, 7 + 9_000_000, 9 + 4_000_000])
    iters = torch.tensor([0, 4096, 1024], dtype=torch.int32)
    got = rrtc_mega.slowest_iter_us(work, iters)
    assert got.dim() == 0 and got.dtype == torch.float64
    assert float(got) == pytest.approx(9_000_000 / 4096 / 1e3)
    # a block that ran no iteration counts as one
    assert float(rrtc_mega.slowest_iter_us(work[:1], iters[:1])) == pytest.approx(23.0)


def test_count_blocks_sums_the_phase_clocks(monkeypatch):
    """Under a recorder, a planner launch's counts: its blocks' time and
    slots from the %globaltimer columns, and from rank 0's phase clocks,
    planner_cyc (every phase), planner_fkcc_cyc (the FK + collision pass)
    and planner_nn_cyc (both nearest-neighbour scans), equal to
    fkcc_cuda.phase_split of the same work; a second launch adds to them."""
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc_mega

    monkeypatch.setattr(rrtc_mega, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(rrtc_mega_cuda, "LAST_LAUNCH", {"blocks_per_sm": 1})
    first = rrtc_mega_cuda.WORK
    t = first + len(rrtc_mega_cuda.PHASES)
    work = torch.zeros((3, rrtc_mega_cuda.WORK_COLS), dtype=torch.int64)
    work[:, first:t] = torch.arange(21).reshape(3, 7) * 1000 + 7
    work[:, t] = torch.tensor([10, 20, 30])
    work[:, t + 1] = torch.tensor([110, 70, 90])
    work[:, t + 2] = torch.tensor([100, 50, 60])
    split = fkcc_cuda.phase_split(work, first, rrtc_mega_cuda.PHASES)["cycles"]
    into = {}
    with profiling.recording(into):
        rrtc_mega._count_blocks(work)
        rrtc_mega._count_blocks(work[:1])
    once = {n: float(work[0, first + i]) for i, n in enumerate(rrtc_mega_cuda.PHASES)}
    assert into["planner_cyc"] == sum(split.values()) + sum(once.values())
    assert into["planner_fkcc_cyc"] == split["fkcc"] + once["fkcc"]
    assert into["planner_nn_cyc"] == (split["nn_a"] + split["nn_b"]
                                      + once["nn_a"] + once["nn_b"])
    assert into["planner_block_ns"] == 210 + 100
    assert into["planner_slot_ns"] == (110 - 10) * 132 + (110 - 10) * 132


def test_run_suite_pointcloud_spans_add_up(monkeypatch):
    """The five pc_* spans inside pointcloud on two CPU problems (the kernel
    form, built on the card's path only, built here too) cover the phase."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.planning import rrtc
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    orig = pipeline.problem_to_pointcloud_env
    monkeypatch.setattr(pipeline, "problem_to_pointcloud_env",
                        lambda *a, **k: orig(*a, **{**k, "kernel_pc": True}))
    rng = np.random.default_rng(0)
    problems = [{"problem": "cage", "index": i, "sphere": [], "cylinder": [],
                 "box": [{"position": (np.asarray(c) + rng.uniform(-0.01, 0.01, 3)).tolist(),
                          "orientation_quat_xyzw": [0, 0, 0, 1],
                          "half_extents": [0.14, 0.14, 0.14]} for c in mbm.CAGE_CENTERS[7:]],
                 "start": list(mbm.PANDA_START), "goals": [list(mbm.PANDA_START)]}
                for i in range(2)]
    s = rrtc.RRTCSettings(range=1.0, max_iterations=64, max_samples=256, max_path=32,
                          samples_per_step=4, connect_segments=2, sample_window=2)
    res, tm = mbm.run_suite_pointcloud("panda", pc_repr="capt", settings=s, batch_size=2,
                                       samples_per_object=2000, warmup=False,
                                       data={"problems": {"cage": problems}}, device="cpu")
    ph = tm["phases"]
    kids = ("pc_sample", "pc_filter", "pc_build_capt", "pc_build_kernel", "pc_stage")
    assert all(ph[k] >= 0 for k in kids)
    assert sum(ph[k] for k in kids) == pytest.approx(ph["pointcloud"], rel=0.05)
    parents = {(s[1], s[2]) for s in ph["spans"]}
    assert {(k, "pointcloud") for k in kids} <= parents
    assert len({s[0] for s in ph["spans"]}) == 1
    assert "retry_live" not in ph and bool(res.plan.solved.all())  # spans alone


NEW_READERS = {  # metric -> (the key it reads, the value of the items below)
    "retry_live.suite": ("retry_live", 48.0),
    "retry_iter_us.suite": ("retry_iter_us", 66.0),
    "pc_sample_ms.cloud": ("pc_sample", 25.0),
    "pc_filter_ms.cloud": ("pc_filter", 8.0),
    "capt_build_ms.cloud": ("pc_build_capt", 50.0),
    "pck_build_ms.cloud": ("pc_build_kernel", 6.0),
    "pc_stage_ms.cloud": ("pc_stage", 0.75),
}


def _reader(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "planbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, items):
        self.items = items


@pytest.mark.parametrize("name", sorted(NEW_READERS) + ["planner_fill_pct.suite",
                                                         "retry_cluster_k.suite",
                                                         "planner_fkcc_pct.suite",
                                                         "planner_nn_pct.suite"])
def test_span_readers_read_the_runner_keys_or_nothing(name):
    """The benchmark's readers of these spans and counts: the mean over the
    window's items of the key they read (ms for a span), and nothing from a
    runner that has no such key, as a parent without them."""
    read = _reader(name)
    old = _Run([{"timings": {"plan": 1.0, "pointcloud": 0.1}}, {"error": "refused"}])
    assert read(old) is None and read(_Run([])) is None
    if name == "planner_fill_pct.suite":
        tms = [{"planner_block_ns": 3.0e9, "planner_slot_ns": 12.0e9},
               {"planner_block_ns": 1.0e9, "planner_slot_ns": 4.0e9}]
        assert read(_Run([{"timings": t} for t in tms])) == pytest.approx(25.0)
        return
    if name == "retry_cluster_k.suite":  # the rows' blocks over the rows, summed
        tms = [{"retry_live": 49.0, "retry_blocks": 98.0},
               {"retry_live": 1.0, "retry_blocks": 8.0}, {"retry_live": 0.0}]
        assert read(_Run([{"timings": t} for t in tms])) == pytest.approx(106.0 / 50.0)
        return
    if name in ("planner_fkcc_pct.suite", "planner_nn_pct.suite"):
        # a phase's cycles over all phases' cycles, summed over the window
        tms = [{"planner_cyc": 100.0, "planner_fkcc_cyc": 30.0, "planner_nn_cyc": 60.0},
               {"planner_cyc": 300.0, "planner_fkcc_cyc": 90.0, "planner_nn_cyc": 150.0},
               {"plan": 1.0}]
        want = 30.0 if name == "planner_fkcc_pct.suite" else 52.5
        assert read(_Run([{"timings": t} for t in tms])) == pytest.approx(want)
        assert read(_Run([{"timings": {"planner_cyc": 0.0, "planner_fkcc_cyc": 0.0,
                                       "planner_nn_cyc": 0.0}}])) is None
        return
    key, mean = NEW_READERS[name]
    scale = 1e-3 if name.endswith(".cloud") else 1.0
    items = [{"timings": {key: (mean - 1.0) * scale}}, {"timings": {key: (mean + 1.0) * scale}},
             {"error": "refused"}]
    assert read(_Run(items)) == pytest.approx(mean)
