"""The port stands alone: nothing in vamp_mvt_tpu_torch/ or chip_smoke.py
imports `jax` or the JAX package, and the port's entry points refuse to run
on the CPU unless asked to."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "vamp_mvt_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
    import vamp_mvt_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        vamp_mvt_tpu_torch.__path__, "vamp_mvt_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print(" ".join(names))
    """
)


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + _BLOCKED_IMPORT],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 30
    assert {f"vamp_mvt_tpu_torch.{m}" for m in (
        "native", "collision.mvt", "collision.capt", "collision.pc_kernel",
        "pointcloud.sampling", "pointcloud.filters", "pointcloud.pipeline",
        "probes.gather", "probes.mosaic", "planning.prm", "planning.fcit", "api")} <= names


def test_mbm_entry_points_import_without_jax():
    """The MBM command line, the MPNet demonstrations and trainer and the
    other MBM-file examples are among the modules imported with JAX and
    the JAX package blocked."""
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + _BLOCKED_IMPORT],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert {f"vamp_mvt_tpu_torch.{m}" for m in (
        "examples.evaluate_mbm", "examples.prepare_mpnet_dataset",
        "examples.evaluate_mbm_mpnet", "examples.prepare_query_dataset",
        "examples.visualize_mbm", "tools", "tools.train_mpnet")} <= names


def test_port_sources_name_no_jax():
    files = list((ROOT / "vamp_mvt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            code = line.split("#")[0].strip()
            if code.startswith(("import ", "from ")):
                mod = code.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "vamp_mvt_tpu"), f"{f}: {line}"


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops import fkcc
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega
    from vamp_mvt_tpu_torch.robots import registry

    spec = registry.sphere_spec()
    envs = envmod.broadcast_environment(envmod.empty_environment(), 1)
    q = torch.zeros((1, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fkcc.fkcc(spec, envmod.empty_environment(), q)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rrtc.plan_batch_compact(spec, envs, q, q[:, None], torch.ones((1, 1), dtype=torch.bool),
                                rrtc.RRTCSettings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simplify.simplify_batch_compact(spec, envs, torch.zeros((1, 4, 3)), torch.tensor([2]),
                                        simplify.SimplifySettings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rrtc_mega.plan_batch_mega(spec, envs, q, q[:, None], torch.ones((1, 1), dtype=torch.bool),
                                  rrtc.RRTCSettings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simplify_mega.simplify_batch_mega(spec, envs, torch.zeros((1, 4, 3)), torch.tensor([2]),
                                          simplify.SimplifySettings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mbm.run_suite("panda", data=mbm.cage_suite(1), batch_size=1, planner="mega")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mbm.run_suite_pointcloud("panda", data=mbm.cage_suite(1), batch_size=1)
    assert bool(fkcc.fkcc(spec, envmod.empty_environment(), q, device="cpu").all())
    res = rrtc_mega.plan_batch_mega(spec, envs, q, q[:, None] + 0.5,
                                    torch.ones((1, 1), dtype=torch.bool),
                                    rrtc.RRTCSettings(max_path=8), device="cpu")
    assert bool(res.solved[0]) and int(res.path_length[0]) == 2


def test_build_key_covers_every_source(tmp_path):
    """The kernels' build key hashes every csrc/*.cu and *.cuh file and the
    nvcc flags, so a change to a shared header rebuilds every library."""
    from vamp_mvt_tpu_torch.ops.kernels import build

    names = sorted(p.name for p in build.CSRC.iterdir())
    assert {"fkcc.cu", "fkcc_device.cuh", "rrtc_mega.cu", "simplify_mega.cu",
            "probe_gather.cu", "probe_mosaic.cu"} <= set(names)
    for name in names:
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    key = build.source_key(tmp_path)
    assert key == build.source_key(build.CSRC)
    for name in names:
        f = tmp_path / name
        data = f.read_bytes()
        f.write_bytes(data + b"\n")
        assert build.source_key(tmp_path) != key, name
        f.write_bytes(data)
    assert build.source_key(tmp_path) == key
    assert build.source_key(tmp_path, build.NVCC_FLAGS + ("-G",)) != key
