"""The metric arithmetic: a rate over the whole window, the 95th percentile
over every request, device idle as the union of intervals."""

import numpy as np
import pytest

from planbench import readers, stats, tracing


def test_rate_is_all_work_over_all_time():
    assert stats.rate(1400, 2.0) == 700.0


def test_p95_over_every_value():
    vals = list(range(1, 101))
    assert stats.p95(vals) == pytest.approx(np.percentile(vals, 95))
    assert stats.p95([5.0] * 19 + [100.0]) == pytest.approx(5.0 + 0.05 * 95.0)


def test_union_of_overlapping_intervals():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert stats.union_length([]) == 0.0
    assert stats.union_length([(0, 10), (2, 3)]) == 10.0


def test_gaps_and_idle_share():
    g = stats.gaps([(1, 2), (1.5, 3), (6, 7)], 0, 10)
    assert g == [(0, 1), (3, 6), (7, 10)]
    busy = stats.union_length([(1, 2), (1.5, 3), (6, 7)])
    assert stats.idle_pct(busy, 10) == pytest.approx(100 * (1 - 3 / 10))


class _Run:
    def __init__(self, items, t0, t1, trace=None):
        self.items, self.t_window, self.t_end, self.device_trace = items, t0, t1, trace
        self.setup_s = 3.0

    @property
    def window_s(self):
        return self.t_end - self.t_window


def test_readers_take_the_whole_window():
    suites = [{"t0": 0.0, "t1": 1.0, "problems": 700, "cost": np.array([4.0, 6.0]),
               "timings": {"plan": 0.2, "retry": 0.6, "build_batch": 0.05, "validity": 0.01,
                           "gather": 0.04, "simplify": 0.1}},
              {"t0": 1.0, "t1": 2.5, "problems": 700, "cost": np.array([5.0]),
               "timings": {"plan": 0.2, "retry": 1.0, "build_batch": 0.05, "validity": 0.01,
                           "gather": 0.04, "simplify": 0.1}}]
    run = _Run(suites, 0.0, 2.5)
    assert readers.problems_per_s(run) == pytest.approx(1400 / 2.5)
    assert readers.request_ms(run) is None
    assert readers.path_cost(run) == 5.0
    assert readers.phase_ms(run, "build_batch", "validity", "gather") == pytest.approx(100.0)
    assert readers.phase_share_pct(run, ("retry",), ("plan", "retry")) == pytest.approx(
        100 * 1.6 / 2.0)
    reqs = [{"t0": i, "t1": i + (10.0 if i == 19 else 1.0), "solved": True, "cost": 2.0}
            for i in range(20)]
    run = _Run(reqs, 0.0, 29.0)
    assert readers.request_ms(run) == pytest.approx(1e3 * 29.0 / 20)
    assert readers.request_ms_p95(run) == pytest.approx(1e3 * stats.p95([1.0] * 19 + [10.0]))
    assert readers.problems_per_s(run) is None


def test_idle_reader_and_breakdown():
    dev = [("k1", 0.0, 2e6), ("k2", 1e6, 3e6), ("copy", 6e6, 7e6)]
    host = [("pb:slice", 0.0, 10e6), ("pb:api.rrtc", 2.5e6, 9e6), ("aten::add", 4e6, 5e6)]
    b = tracing.breakdown(dev, host, 0.0, 10e6)
    assert b["device_ops"][0] == ["k1", 2.0]
    assert b["idle_gaps"][0] == ["api.rrtc / aten::add", 3.0]
    trace = {"busy_s": stats.union_length([(s, e) for _, s, e in dev]) / 1e6, "window_s": 10.0,
             "items": 2, "kernels": {"rrtc_mega_kernel<4>": 0.5, "fkcc_kernel": 0.1}}
    run = _Run([], 0, 1, trace)
    assert readers.device_idle_pct(run) == pytest.approx(60.0)
    assert readers.kernel_ms(run, "rrtc_mega") == pytest.approx(250.0)
    assert readers.device_idle_pct(_Run([], 0, 1, dict(trace, busy_s=0.0))) is None


def test_summarize_leaves_out_the_harness_ranges_on_the_device():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    ev = lambda name, dev, s, e: NS(name=name, device_type=dev, time_range=NS(start=s, end=e))
    events = [ev("pb:slice", DeviceType.CPU, 0, 10e6),
              ev("pb:api.rrtc", DeviceType.CPU, 1e6, 9e6),
              ev("pb:api.rrtc", DeviceType.CUDA, 1e6, 9e6),
              ev("fkcc_kernel<32>", DeviceType.CUDA, 2e6, 3e6)]
    t = tracing.summarize(events, 10.0, 1)
    assert t["busy_s"] == pytest.approx(1.0)
    assert t["kernels"] == {"fkcc_kernel<32>": pytest.approx(1.0)}
    assert t["breakdown"]["idle_gaps"][0] == ["api.rrtc", pytest.approx(7.0)]
