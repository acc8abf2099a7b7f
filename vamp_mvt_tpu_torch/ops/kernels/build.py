"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/<name>.cu` is compiled for sm_90a into a shared library with a
plain C interface, `build/<name>_<key>.so`, at first use.  The key hashes
the bytes of every `csrc/*.cu` and `*.cuh` file and the nvcc flags, so a
change to a shared header rebuilds every library.  The first `library()`
call starts one nvcc per source, all at once, and waits for them.  There is
no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# What the build reported for each library: seconds, whether it came from
# the cache, nvcc's output (registers, shared memory and spills per kernel)
# and its path.
BUILD_INFO: dict[str, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source_key(csrc: Path = CSRC, flags=NVCC_FLAGS) -> str:
    """Hash of every CUDA source and header in `csrc` and of the flags."""
    h = hashlib.sha256()
    for f in sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_all() -> None:
    """Compile every csrc/*.cu not yet in build/, one nvcc each, in parallel."""
    key = source_key()
    t0 = time.perf_counter()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        name = src.stem
        so = BUILD_DIR / f"{name}_{key}.so"
        BUILD_INFO[name] = dict(path=str(so), cached=so.exists(), log="", seconds=0.0)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        BUILD_INFO[name].update(log=log, seconds=time.perf_counter() - t0)
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {CSRC / (name + '.cu')}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """Load `build/<name>_<key>.so`, building every library first if needed."""
    with _LOCK:
        if name not in _LIBS:
            if name not in BUILD_INFO:
                _build_all()
            if name not in BUILD_INFO:
                raise ValueError(f"no CUDA source {CSRC / (name + '.cu')}")
            _LIBS[name] = ctypes.CDLL(BUILD_INFO[name]["path"])
        return _LIBS[name]


def ptxas_lines(name: str) -> list[str]:
    """nvcc's register, shared-memory and spill lines for library `name`."""
    return [line.strip() for line in BUILD_INFO[name]["log"].splitlines()
            if "registers" in line or "spill" in line or "smem" in line]
