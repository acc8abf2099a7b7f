"""ctypes bindings for the repository's host-side C++ library.

The port's own wrapper of `native/libvamp_native.so` (built from
`native/vamp_native.cpp` by `make -C native`): the SCDF and center-voxel
pointcloud filters, the windowed per-voxel distance grid of the kernel
pointcloud build and the CAPT build.  The JAX package's wrapper builds the
library on first import and falls back to numpy without a word; here every
caller chooses its route with `use_native`, and a native call raises when the
library cannot be loaded.  Numpy only.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[1] / "native" / "libvamp_native.so"

_LIB = None
_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """Load the library and declare its functions; raise if it cannot load."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(str(LIB_PATH))
            except OSError as e:
                raise RuntimeError(
                    f"cannot load {LIB_PATH} ({e}); build it with `make -C native` "
                    "or pass use_native=False") from e
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            I, F = ctypes.c_int, ctypes.c_float
            lib.vamp_scdf_filter.restype = I
            lib.vamp_scdf_filter.argtypes = [f32p, I, F, F, f32p, f32p, f32p, I, i32p]
            lib.vamp_centervox_filter.restype = I
            lib.vamp_centervox_filter.argtypes = [f32p, I, F, F, f32p, f32p, f32p, i32p]
            lib.vamp_capt_build.restype = I
            lib.vamp_capt_build.argtypes = [f32p, I, F, F, F, f32p, f32p, f32p, I, i32p, f32p]
            lib.vamp_voxel_mindist2.restype = None
            lib.vamp_voxel_mindist2.argtypes = [f32p, I, f32p, F, I, I, f32p]
            _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the library loads (it is never built here: `make -C native`)."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def scdf_filter(pc, min_dist, max_range, origin, wmin, wmax, cull=True) -> np.ndarray:
    """SCDF filter (native/vamp_native.cpp::vamp_scdf_filter): the kept points."""
    pc = _f32(pc).reshape(-1, 3)
    out = np.empty(len(pc), np.int32)
    cnt = library().vamp_scdf_filter(
        pc, len(pc), min_dist, max_range, _f32(origin), _f32(wmin), _f32(wmax), int(cull), out)
    return pc[out[:cnt]]


def centervox_filter(pc, voxel_size, max_range, origin, wmin, wmax) -> np.ndarray:
    """Center-selective voxel filter (vamp_centervox_filter): the kept points."""
    pc = _f32(pc).reshape(-1, 3)
    out = np.empty(len(pc), np.int32)
    cnt = library().vamp_centervox_filter(
        pc, len(pc), voxel_size, max_range, _f32(origin), _f32(wmin), _f32(wmax), out)
    return pc[out[:cnt]]


def voxel_mindist2(points, wmin, cell, W: int, win: int) -> np.ndarray:
    """(W, W, W) float32 per-voxel minimum squared centre distance to a point,
    +inf beyond every point's window of `win` cells (vamp_voxel_mindist2)."""
    points = _f32(points).reshape(-1, 3)
    out = np.empty(W * W * W, np.float32)
    library().vamp_voxel_mindist2(points, len(points), _f32(wmin), np.float32(cell),
                                  int(W), int(win), out)
    return out.reshape(W, W, W)


def capt_build_arrays(points, r_min, r_max, r_point):
    """CAPT build (vamp_capt_build): (tests, leaf_aabb, aff_flat, aff_start,
    top_aabb)."""
    lib = library()
    points = _f32(points).reshape(-1, 3)
    n = len(points)
    nlog2 = 0
    while (1 << nlog2) < n:
        nlog2 += 1
    size = 1 << nlog2
    tests = np.empty(max(size - 1, 1), np.float32)
    leaf_aabb = np.empty((size, 6), np.float32)
    aff_start = np.empty(size + 1, np.int32)
    top_aabb = np.empty(6, np.float32)
    cap = max(size * 64, 4096)
    while True:
        aff_flat = np.empty((cap, 3), np.float32)
        total = lib.vamp_capt_build(points, n, r_min, r_max, r_point, tests,
                                    leaf_aabb.reshape(-1), aff_flat.reshape(-1), cap,
                                    aff_start, top_aabb)
        if total >= 0:
            return tests[: size - 1], leaf_aabb, aff_flat[:total], aff_start, top_aabb
        cap *= 4
