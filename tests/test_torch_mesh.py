"""Port parity: problem-batch sharding (`parallel/mesh.py`) on the CPU.

Mirrors tests/test_sharding.py.  The sphere robot's wall with a centre hole,
B = 8 problems (`bench/scenes.py::center_wall`, test_sharding's batch):

- in one process, over a mesh of two CPU devices: the sharded megakernel
  planner equals the unsharded one and the JAX package's `plan_batch_mega`
  (Pallas interpret mode): solved flags, iterations and path lengths exact,
  costs within rtol 1e-6;
- a real two-rank `torch.distributed` group (gloo over localhost, two
  subprocesses joined through `init_distributed`, each rank its slice, the
  batch assembled by all_gather): `plan_batch_mega_sharded`,
  `plan_batch_sharded` and `simplify_batch_sharded` equal the unsharded
  port and the JAX package (same tolerances; simplified costs rtol 1e-5),
  and `aorrtc_restarts_sharded` at rounds=2 gives the JAX function's history
  on `make_mesh(2)` within rtol 1e-5, with the all_reduce(MIN) checked
  against the host minimum inside the function.  The restarts run on the
  wall with a corner gap (tests/test_planners.py's AORRTC problem; through
  the centre hole the straight line would answer every round): at
  base_offset 7 rank 0 wins the first round and rank 1 the second.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.parallel import mesh as jmesh
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import rrtc_mega as jrrtc_mega
from vamp_mvt_tpu.planning import simplify as jsimplify
from vamp_mvt_tpu_torch.bench import scenes
from vamp_mvt_tpu_torch.parallel import mesh
from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify

from test_sharding import _wall_problem
from test_torch_suite_robots import _JAX_ID_CACHES

torch.set_num_threads(1)

CPU = "cpu"
B = 8
SETTINGS = dict(range=1.0, max_iterations=384, max_samples=512, max_path=64,
                samples_per_step=4, connect_segments=2, sample_window=2)
RESTART = dict(range=1.0, max_iterations=512, max_samples=512, max_path=64)
ROUNDS = 2
BASE_OFFSET = 7
REPO = str(Path(__file__).resolve().parent.parent)


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    for mod, name in _JAX_ID_CACHES:
        monkeypatch.setattr(mod, name, {})


def _same_plan(got, want):
    for f in ("solved", "iterations", "path_length"):
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(want.cost), rtol=1e-6)


def _jax_mega():
    spec, envs, starts, goals, masks = _wall_problem(B)
    return jrrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks,
                                      jrrtc.RRTCSettings(**SETTINGS))


def test_make_mesh_and_shards():
    m = mesh.make_mesh(2, device=CPU)
    assert m.size == 2 and m.devices == (torch.device(CPU),) * 2
    _, envs, starts, goals, _ = scenes.center_wall(B, CPU)
    parts = mesh.shard_batch(m, (envs, starts, goals))
    assert len(parts) == 2 and all(p[1].shape == (4, 3) for p in parts)
    assert torch.equal(torch.cat([p[2] for p in parts]), goals)
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_batch(mesh.make_mesh(3, device=CPU), (starts,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
    assert mesh.init_distributed(device=CPU) == 1  # no group asked for


def test_plan_batch_mega_sharded_matches_unsharded_and_jax():
    spec, envs, starts, goals, masks = scenes.center_wall(B, CPU)
    s = rrtc.RRTCSettings(**SETTINGS)
    sh = mesh.plan_batch_mega_sharded(spec, mesh.make_mesh(2, device=CPU), envs, starts,
                                      goals, masks, s)
    lo = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, device=CPU)
    assert bool(lo.solved.any())
    _same_plan(sh, lo)
    _same_plan(sh, _jax_mega())


_WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from vamp_mvt_tpu_torch.bench import scenes
    from vamp_mvt_tpu_torch.parallel import mesh
    from vamp_mvt_tpu_torch.planning import rrtc, simplify

    rank = int(sys.argv[1])
    n = mesh.init_distributed(device="cpu", init_method={addr!r}, world_size=2, rank=rank)
    assert n == 2, n
    m = mesh.make_mesh(device="cpu")
    spec, envs, starts, goals, masks = scenes.center_wall({B}, "cpu")
    s = rrtc.RRTCSettings(**{settings!r})
    mega = mesh.plan_batch_mega_sharded(spec, m, envs, starts, goals, masks, s)
    lock = mesh.plan_batch_sharded(spec, m, envs, starts, goals, masks, s)
    simp = mesh.simplify_batch_sharded(spec, m, envs, lock.path, lock.path_length,
                                       simplify.SimplifySettings())
    from vamp_mvt_tpu_torch.collision import environment as envmod

    b = envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                b.add_sphere([0.0, y, z], 0.3)
    path, length, cost, hist = mesh.aorrtc_restarts_sharded(
        spec, m, b.build(device="cpu"), starts[0], goals[0], rrtc.RRTCSettings(**{restart!r}),
        rounds={rounds}, base_offset={base})
    out = {{}}
    for tag, res in (("mega", mega), ("lock", lock), ("simp", simp)):
        for f in res._fields:
            out[tag + "_" + f] = getattr(res, f).numpy()
    out.update(restart_path=path, restart_length=length, restart_cost=cost,
               restart_history=np.asarray(hist))
    np.savez(sys.argv[2], **out)
    torch.distributed.destroy_process_group()
    print("rank", rank, "OK", flush=True)
    """
)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the worker as ranks 0 and 1 of a gloo group; each rank's results
    (every rank holds the assembled batch)."""
    tmp = tmp_path_factory.mktemp("ranks")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(repo=REPO, addr=f"tcp://127.0.0.1:{port}", B=B,
                                     settings=SETTINGS, restart=RESTART, rounds=ROUNDS,
                                     base=BASE_OFFSET))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "MASTER_", "RANK", "WORLD_SIZE", "LOCAL_RANK"))}
    outs = [tmp / f"rank{i}.npz" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(outs[i])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for i in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {i} OK" in log, log
    return [dict(np.load(o)) for o in outs]


def _result(d, tag, cls):
    return cls(*(d[f"{tag}_{f}"] for f in cls._fields))


def test_two_rank_sharded_planners_match_unsharded_and_jax(two_ranks):
    spec, envs, starts, goals, masks = scenes.center_wall(B, CPU)
    s = rrtc.RRTCSettings(**SETTINGS)
    lo_mega = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, device=CPU)
    lo_lock = rrtc.plan_batch(spec, envs, starts, goals, masks, s)
    lo_simp = simplify.simplify_batch(spec, envs, lo_lock.path, lo_lock.path_length,
                                      simplify.SimplifySettings())
    jspec, jenvs, jst, jgl, jmk = _wall_problem(B)
    j_lock = jax.jit(lambda e, a, g, m: jrrtc.plan_batch(jspec, e, a, g, m,
                                                         jrrtc.RRTCSettings(**SETTINGS)))(
        jenvs, jst, jgl, jmk)
    j_simp = jsimplify.simplify_batch(jspec, jenvs, j_lock.path, j_lock.path_length,
                                      jsimplify.SimplifySettings())
    j_mega = _jax_mega()
    for d in two_ranks:
        mega = _result(d, "mega", rrtc.RRTCResult)
        lock = _result(d, "lock", rrtc.RRTCResult)
        simp = _result(d, "simp", simplify.SimplifyResult)
        _same_plan(mega, lo_mega)
        _same_plan(mega, j_mega)
        _same_plan(lock, lo_lock)
        _same_plan(lock, j_lock)
        np.testing.assert_allclose(lock.path, lo_lock.path.numpy(), atol=1e-6)
        assert np.array_equal(simp.path_length, lo_simp.path_length.numpy())
        assert np.array_equal(simp.path_length, np.asarray(j_simp.path_length))
        np.testing.assert_allclose(simp.cost, np.asarray(j_simp.cost), rtol=1e-5)
        np.testing.assert_allclose(simp.cost, lo_simp.cost.numpy(), rtol=1e-5)


def test_two_rank_aorrtc_restarts_match_jax(two_ranks):
    jspec, _, jst, jgl, _ = _wall_problem(1)
    b = jenvmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                b.add_sphere([0.0, y, z], 0.3)
    jpath, jlen, jcost, jhist = jmesh.aorrtc_restarts_sharded(
        jspec, jmesh.make_mesh(2), b.build(), jst[0], jgl[0], jrrtc.RRTCSettings(**RESTART),
        rounds=ROUNDS, base_offset=BASE_OFFSET)
    assert len(jhist) == ROUNDS + 1 and jhist[0] > jhist[1] > jhist[2]
    for d in two_ranks:
        np.testing.assert_allclose(d["restart_history"], np.asarray(jhist), rtol=1e-5)
        assert int(d["restart_length"]) == int(jlen)
        np.testing.assert_allclose(float(d["restart_cost"]), float(jcost), rtol=1e-5)
        L = int(jlen)
        np.testing.assert_allclose(d["restart_path"][:L], np.asarray(jpath)[:L], atol=1e-5)
    assert np.array_equal(two_ranks[0]["restart_history"], two_ranks[1]["restart_history"])
