"""Port parity: the whole lockstep suite runner, end to end on the CPU.

The port's `run_suite(data=..., planner="xla", device="cpu")` on four seeded
Panda-cage problems must give the same `summary()` solved and valid counts
as the JAX package's `run_suite` on the same data.  The JAX runner caches
assembled batches under `CACHE_DIR`; the test points that at a temporary
directory.
"""

import numpy as np
import pytest
import torch

from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import simplify as jsimplify
from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.planning import rrtc, simplify, validate
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

PLAN = dict(range=1.0, max_iterations=2048, max_samples=512, max_path=96,
            samples_per_step=16, connect_segments=8, sample_window=4)
SIMP = dict(pair_cap_first=512, pair_cap_rest=256, shortcut_jobs_first=8192,
            shortcut_jobs_rest=4096, bspline_jobs=2048)


def test_run_suite_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jmbm, "CACHE_DIR", tmp_path)
    data = mbm.cage_suite(4, seed=0)
    ref = jmbm.run_suite(
        "panda", data=data, planner="xla", batch_size=4, warmup=False,
        settings=jrrtc.RRTCSettings(**PLAN), simp_settings=jsimplify.SimplifySettings(**SIMP),
    )
    timings = {}
    got = mbm.run_suite(
        "panda", data=data, planner="xla", batch_size=4, warmup=False,
        settings=rrtc.RRTCSettings(**PLAN), simp_settings=simplify.SimplifySettings(**SIMP),
        timings=timings, device="cpu",
    )
    rs, gs = ref.summary(), got.summary()
    for k in ("total_problems", "valid_problems", "solved_problems"):
        assert gs[k] == rs[k], k
    assert gs["solved_problems"] == 4
    assert {"build_batch", "validity", "plan", "retry", "simplify", "gather"} <= set(timings)
    assert "Solved 4 / Valid 4 / Total 4" in got.percentile_table()

    # every simplified path is collision-free, segment by segment
    spec = registry.load("panda")
    envs = mbm.build_batch(data["problems"]["cage"], device="cpu")[0]
    paths = torch.as_tensor(got.simplified.path)
    num = validate.n_points_bound(
        spec, float(np.linalg.norm(spec.limits_high - spec.limits_low))
    )
    ok = validate.validate_motion_batch(spec, envs, paths[:, :-1], paths[:, 1:], num)
    k = torch.arange(1, paths.shape[1])
    assert bool((ok | (k[None] >= torch.as_tensor(got.simplified.path_length)[:, None])).all())


def test_run_suite_without_device_needs_gpu_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mbm.run_suite("panda", data=mbm.cage_suite(1), batch_size=1)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        mbm.run_suite("panda", data=mbm.cage_suite(1), planner="mega", device="cpu")
