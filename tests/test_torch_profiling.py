"""The port's profiling utilities (`utils/profiling.py`) on the CPU.

`trace` writes a Chrome trace of a plain fkcc call (the fkcc kernel's plain
version: the port's wrapper on a CPU tensor) and `op_breakdown` sums its
complete events by name, as the JAX package's `op_breakdown` sums a
profiler trace: on the same events both give the same rows.  `device_timer`
measures the block in ns.
"""

import gzip
import json

import numpy as np
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
