"""Per-lane gather probes: the kernels of `csrc/probe_gather.cu` and their
plain versions.

Port of the TPU probes `tools/probe_gather.py`, which tested Mosaic's per-lane
gathers from (8, 128) tables, the construct of the pointcloud bitmap lookup.
Indices come as (tiles, 8, 128) int32 tiles; every tile reads the same table.

  gather(name, table, idx, idx2=None) -> (tiles, 8, 128) output

name       table               index range            output
lane       (8, 128) float32    idx < 128              t[r, idx]
row        (1, 128) float32    idx < 128              t[0, idx]
bits       (1, 128) int32      idx < 128 * 32         bit idx & 31 of word idx >> 5
two_level  (16, 128) float32   idx < 16, idx2 < 128   t[idx, idx2]
sublane    (8, 128) float32    idx < 8                t[idx, c]
timing     (1, 128) float32    idx < 128              sum over k < 64 of t[0, (idx + k) & 127]

A CUDA tensor launches the kernel, a CPU tensor takes the plain version.
A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vamp_mvt_tpu_torch.ops.kernels import build

PROBES = ("lane", "row", "bits", "two_level", "sublane", "timing")
_TABLE_ROWS = {"lane": 8, "row": 1, "bits": 1, "two_level": 16, "sublane": 8, "timing": 1}
_IDX_RANGE = {"lane": 128, "row": 128, "bits": 128 * 32, "two_level": 16, "sublane": 8,
              "timing": 128}
TIMING_GATHERS = 64  # gathers an element of the timing probe

# Kernel launches made by this process; callers reset it to 0 around a run.
LAUNCHES = 0
_LIB = None


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.library("probe_gather")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.probe_gather_launch.argtypes = [I, P, P, P, P, I, P]
        lib.probe_gather_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def inputs(name: str, tiles: int, seed: int, device=None):
    """Seeded (table, idx, idx2) of probe `name` over `tiles` tiles (idx2 is
    None except for two_level)."""
    rng = np.random.default_rng(seed)
    rows = _TABLE_ROWS[name]
    if name == "bits":
        table = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64).astype(np.int32)
    else:
        table = rng.standard_normal((rows, 128)).astype(np.float32)
    idx = rng.integers(0, _IDX_RANGE[name], (tiles, 8, 128)).astype(np.int32)
    idx2 = (rng.integers(0, 128, (tiles, 8, 128)).astype(np.int32)
            if name == "two_level" else None)
    as_t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    return as_t(table), as_t(idx), as_t(idx2)


def plain(name: str, table: torch.Tensor, idx: torch.Tensor, idx2=None) -> torch.Tensor:
    """The probe's plain PyTorch version."""
    tiles = idx.shape[0]
    i = idx.long()
    if name == "lane":
        return torch.gather(table.expand(tiles, 8, 128), 2, i)
    if name == "row":
        return table[0][i]
    if name == "bits":
        return (table[0][i >> 5] >> (idx & 31)) & 1
    if name == "two_level":
        return table[i, idx2.long()]
    if name == "sublane":
        return torch.gather(table.expand(tiles, 8, 128), 1, i)
    if name == "timing":
        acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
        for k in range(TIMING_GATHERS):
            acc = acc + table[0][(i + k) & 127]
        return acc
    raise ValueError(f"unknown probe {name!r}")


def reference(name: str, table: np.ndarray, idx: np.ndarray, idx2=None) -> np.ndarray:
    """The probe in numpy: tools/probe_gather.py's expected values."""
    if name == "lane":
        return np.take_along_axis(np.broadcast_to(table, idx.shape), idx, 2)
    if name == "row":
        return table[0][idx]
    if name == "bits":
        return (table[0][idx >> 5] >> (idx & 31)) & 1
    if name == "two_level":
        return table[idx, idx2]
    if name == "sublane":
        return np.take_along_axis(np.broadcast_to(table, idx.shape), idx, 1)
    acc = np.zeros(idx.shape, np.float32)
    for k in range(TIMING_GATHERS):
        acc = acc + table[0][(idx + k) & 127]
    return acc


def _check(name, table, idx, idx2):
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}")
    dtype = torch.int32 if name == "bits" else torch.float32
    if table.dtype != dtype or tuple(table.shape) != (_TABLE_ROWS[name], 128):
        raise ValueError(f"probe {name}: table must be {dtype} ({_TABLE_ROWS[name]}, 128)")
    for t, hi in ((idx, _IDX_RANGE[name]), (idx2, 128)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 3 or tuple(t.shape[1:]) != (8, 128):
            raise ValueError(f"probe {name}: indices must be int32 (tiles, 8, 128)")
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= hi):
            raise ValueError(f"probe {name}: index outside [0, {hi})")
    if (idx2 is None) != (name != "two_level") or (idx2 is not None and idx2.shape != idx.shape):
        raise ValueError(f"probe {name}: idx2 is two_level's column tile, of idx's shape")


def gather(name: str, table: torch.Tensor, idx: torch.Tensor, idx2=None) -> torch.Tensor:
    """Run probe `name` (see the module doc): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    _check(name, table, idx, idx2)
    if not idx.is_cuda:
        return plain(name, table, idx, idx2)
    if not table.is_cuda or (idx2 is not None and not idx2.is_cuda):
        raise ValueError(f"probe {name}: table, idx and idx2 must share idx's device")
    return launch(name, table, idx, idx2)


def launch(name: str, table: torch.Tensor, idx: torch.Tensor, idx2=None) -> torch.Tensor:
    """Launch the kernel of probe `name` on CUDA tensors that `gather` has
    checked (the range check reads the indices back to the host, so timing
    loops call this)."""
    global LAUNCHES
    table, idx = build.aligned(table), build.aligned(idx)
    idx2 = None if idx2 is None else build.aligned(idx2)
    out = torch.empty(idx.shape, dtype=table.dtype, device=idx.device)
    if idx.shape[0] == 0:
        return out
    err = library().probe_gather_launch(
        PROBES.index(name), table.data_ptr(), idx.data_ptr(),
        None if idx2 is None else idx2.data_ptr(), out.data_ptr(), idx.shape[0],
        build.stream_handle(idx.device))
    if err != 0:
        raise RuntimeError(f"probe_gather kernel launch failed with error {err}")
    LAUNCHES += 1
    return out


def work(name: str, tiles: int) -> tuple[int, int]:
    """(FP32 operations, bytes) the probe must move and compute for `tiles`
    tiles: each index read once, each output written once, the table once."""
    n = tiles * 8 * 128
    n_bytes = _TABLE_ROWS[name] * 128 * 4 + n * 4 * (2 if name == "two_level" else 1) + n * 4
    return (n * TIMING_GATHERS if name == "timing" else 0), n_bytes
