"""Megakernel-construct probes: the kernels of `csrc/probe_mosaic.cu` and
their plain versions.

Port of the TPU probes `tools/probe_mosaic.py` (P2, eight probes) and
`tools/probe_mosaic2.py` (P3, seven), which tested which constructs Mosaic
compiles for the planner megakernel.  Each probe computes its TPU probe's
function over a leading axis of tiles, in a persistent grid that strides
over units of independent work (a tile, a row, a 16-byte piece or, for
group32_sum, reduce_while and cumsum_first, a warp a tile; dot_argmin a
block a tile), reading only the input words the outputs depend on.  Tile 0 holds
the TPU probe's own input, so its outputs equal the constants the probe file
asserts (`tile0_ok`); the other tiles are seeded.

name            inputs (tiles first)            outputs
while_carry     x f32 (8, 128)                  o f32 (8, 128), s f32
dyn_sublane     x f32 (16, 128)                 o f32 (16, 128), s f32
smem_writes     off i32                         out i32
dot_argmin      a f32 (512, 8), b f32 (8, 64)   idx i32 (64,)
nested_loops    lm i32 (2,)                     o f32 (8, 128), s i32
grid_carry      x i32 (4, 8)                    out i32 (4,)
group32_sum     x f32 (8, 128)                  out f32 (8, 4)
scratch_diag    x f32 (8, 128)                  out i32
reduce_while    x f32 (8, 128)                  out i32
halton_digits   base i32                        out f32 (64, 128)
cumsum_first    x f32 (8, 128), 0 or 1          s i32, o f32 (128,)
transpose       x f32 (8, 128)                  out f32 (64, 1)
static_reads    x f32 (8, 128)                  out i32 (2,)
dyn_rows_while  x f32 (16, 128), L i32          o f32 (16, 128), s i32
smem_int_out    off i32                         out i32 (1, 512)

What each computes, per tile:
- while_carry: while i < 10 and acc < 100: o[0] += x[0], acc += x[0, 0];
  s = acc.  The TPU probe adds into an output it never initialises and
  asserts only s; here o starts at zero, so o[0] = (iterations) x[0] summed
  one add at a time, and o[1:] = 0.
- dyn_sublane: idx = int(x[0, 0]); o = 0; o[idx] = 2 x[0]; s = o[idx, 5].
- smem_writes: smem[i] = 2i + off for i < 512; out = smem[511] + smem[3].
- dot_argmin: the lowest row of each column's minimum of a @ b, the 8-term
  dots summed in index order (`validate.sum_last`'s order).
- nested_loops: with (L, m) = lm: o[c] = c for c < L, the rest 0;
  s = L * m (a counter incremented m times in each of L outer steps).
- grid_carry: the inclusive prefix sum of x[:, 0] over the 4 steps.
- group32_sum: the sums of the four 32-lane groups of each row.
- scratch_diag: the sum over i < 8 of int(3 x[i, i]) (int truncates).
- reduce_while: n = int(sum x) + 2 int(max x[0]); c = 0; while c < 10 n:
  c += n; out = c.
- halton_digits: row r, every lane: the 8 base-3 digits of base + r,
  reversed, times float32(1 / 3^8).
- cumsum_first: o = the inclusive cumsum of the 0/1 row x[0]; s = the lane
  of its third 1, or 10^9.
- transpose: out[:, 0] = x[0, :64].
- static_reads: (int(2 x[3, 5]), int(2 x[7, 127])).
- dyn_rows_while: o = 0; o[0] = x[0]; o[n] = o[n - 1] + 1 for n = 1..L;
  s = L + 1.
- smem_int_out: out[0, i] = 3i + off.

The seeded reductions (group32_sum, reduce_while, dot_argmin) take
integer-valued floats, so that every summation order gives the same float.
A CUDA tensor launches the kernel, a CPU tensor takes the plain version.
A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vamp_mvt_tpu_torch.ops.kernels import build
from vamp_mvt_tpu_torch.planning.validate import sum_last

PROBES = ("while_carry", "dyn_sublane", "smem_writes", "dot_argmin", "nested_loops",
          "grid_carry", "group32_sum", "scratch_diag", "reduce_while", "halton_digits",
          "cumsum_first", "transpose", "static_reads", "dyn_rows_while", "smem_int_out")
F32, I32 = torch.float32, torch.int32
# per probe: (dtype, shape after the tile axis) of each input, then of each output
_INPUTS = {
    "while_carry": ((F32, (8, 128)),), "dyn_sublane": ((F32, (16, 128)),),
    "smem_writes": ((I32, ()),), "dot_argmin": ((F32, (512, 8)), (F32, (8, 64))),
    "nested_loops": ((I32, (2,)),), "grid_carry": ((I32, (4, 8)),),
    "group32_sum": ((F32, (8, 128)),), "scratch_diag": ((F32, (8, 128)),),
    "reduce_while": ((F32, (8, 128)),), "halton_digits": ((I32, ()),),
    "cumsum_first": ((F32, (8, 128)),), "transpose": ((F32, (8, 128)),),
    "static_reads": ((F32, (8, 128)),), "dyn_rows_while": ((F32, (16, 128)), (I32, ())),
    "smem_int_out": ((I32, ()),),
}
_OUTPUTS = {
    "while_carry": ((F32, (8, 128)), (F32, ())), "dyn_sublane": ((F32, (16, 128)), (F32, ())),
    "smem_writes": ((I32, ()),), "dot_argmin": ((I32, (64,)),),
    "nested_loops": ((F32, (8, 128)), (I32, ())), "grid_carry": ((I32, (4,)),),
    "group32_sum": ((F32, (8, 4)),), "scratch_diag": ((I32, ()),),
    "reduce_while": ((I32, ()),), "halton_digits": ((F32, (64, 128)),),
    "cumsum_first": ((I32, ()), (F32, (128,))), "transpose": ((F32, (64, 1)),),
    "static_reads": ((I32, (2,)),), "dyn_rows_while": ((F32, (16, 128)), (I32, ())),
    "smem_int_out": ((I32, (1, 512)),),
}
_INDEX = {name: i for i, name in enumerate(PROBES)}
NONE = 10**9                # cumsum_first's "no third 1"
INV_HALTON = np.float32(1.0 / 3**8)

# Kernel launches made by this process; callers reset it to 0 around a run.
LAUNCHES = 0
_LIB = None


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.library("probe_mosaic")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.probe_mosaic_launch.argtypes = [I, P, P, P, P, I, P]
        lib.probe_mosaic_launch.restype = ctypes.c_int
        lib.probe_mosaic_empty.argtypes = [P]
        lib.probe_mosaic_empty.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Inputs: tile 0 the TPU probe's own, the others seeded
# ---------------------------------------------------------------------------


def _tile0(name: str) -> tuple[np.ndarray, ...]:
    """The TPU probe's own input (the probe file's constants)."""
    if name in ("while_carry", "group32_sum", "scratch_diag", "reduce_while"):
        return (np.ones((8, 128), np.float32),)
    if name == "dyn_sublane":
        return (np.full((16, 128), 3.0, np.float32),)
    if name == "dot_argmin":
        # randn in the probe file; integer values here, so that every order
        # of the dot's sum gives the same float and ties occur
        rng = np.random.default_rng(0)
        return (rng.integers(-8, 9, (512, 8)).astype(np.float32),
                rng.integers(-8, 9, (8, 64)).astype(np.float32))
    if name == "nested_loops":
        return (np.array([5, 3], np.int32),)
    if name == "grid_carry":
        return (np.broadcast_to(np.arange(1, 5, dtype=np.int32)[:, None], (4, 8)).copy(),)
    if name == "halton_digits":
        return (np.array(1000, np.int32),)
    if name == "cumsum_first":
        x = np.zeros((8, 128), np.float32)
        x[0, [5, 17, 40, 90]] = 1.0
        return (x,)
    if name == "transpose":
        return (np.arange(128, dtype=np.float32)[None].repeat(8, 0),)
    if name == "static_reads":
        return (np.full((8, 128), 21.0, np.float32),)
    if name == "dyn_rows_while":
        return np.zeros((16, 128), np.float32), np.array(10, np.int32)
    return (np.array(0, np.int32),)  # smem_writes, smem_int_out: no input there


def _seeded(name: str, n: int, rng) -> tuple[np.ndarray, ...]:
    """n seeded tiles of probe `name`'s inputs."""
    if name == "while_carry":
        x = rng.standard_normal((n, 8, 128)).astype(np.float32)
        x[:, 0] = rng.uniform(0.0, 25.0, (n, 128))  # acc < 100 stops some loops early
        return (x,)
    if name in ("dyn_sublane", "dyn_rows_while"):
        x = rng.standard_normal((n, 16, 128)).astype(np.float32)
        if name == "dyn_sublane":
            x[:, 0, 0] = rng.integers(0, 16, n)
            return (x,)
        return x, rng.integers(0, 16, n).astype(np.int32)
    if name in ("smem_writes", "smem_int_out"):
        return (rng.integers(-1000, 1001, n).astype(np.int32),)
    if name == "dot_argmin":
        return (rng.integers(-8, 9, (n, 512, 8)).astype(np.float32),
                rng.integers(-8, 9, (n, 8, 64)).astype(np.float32))
    if name == "nested_loops":
        return (np.stack([rng.integers(0, 9, n), rng.integers(0, 6, n)], 1).astype(np.int32),)
    if name == "grid_carry":
        return (rng.integers(-1000, 1001, (n, 4, 8)).astype(np.int32),)
    if name in ("group32_sum", "reduce_while"):
        return (rng.integers(-3, 4, (n, 8, 128)).astype(np.float32),)
    if name == "halton_digits":
        return (rng.integers(0, 1 << 24, n).astype(np.int32),)
    if name == "cumsum_first":
        p = rng.uniform(0.0, 0.05, (n, 1, 1))  # some rows hold fewer than three 1s
        return ((rng.uniform(0.0, 1.0, (n, 8, 128)) < p).astype(np.float32),)
    return (rng.uniform(-100.0, 100.0, (n, 8, 128)).astype(np.float32),)  # the rest


def inputs(name: str, tiles: int, seed: int, device=None) -> tuple[torch.Tensor, ...]:
    """Probe `name`'s inputs over `tiles` tiles: tile 0 the TPU probe's own,
    the others seeded."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}")
    rng = np.random.default_rng(seed)
    seeded = _seeded(name, max(tiles - 1, 0), rng)
    return tuple(torch.as_tensor(np.concatenate([t0[None], s])[:tiles], device=device)
                 for t0, s in zip(_tile0(name), seeded))


# ---------------------------------------------------------------------------
# Plain version (PyTorch) and numpy reference
# ---------------------------------------------------------------------------


def plain(name: str, *ins: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The probe's plain PyTorch version (no cuBLAS; sums in index order)."""
    x = ins[0]
    n, dev = x.shape[0], x.device
    if name == "while_carry":
        x0 = x[:, 0]
        o0, acc = torch.zeros_like(x0), torch.zeros(n, device=dev)
        it = torch.zeros(n, dtype=I32, device=dev)
        for _ in range(10):
            go = (it < 10) & (acc < 100.0)
            o0 = torch.where(go[:, None], o0 + x0, o0)
            acc = torch.where(go, acc + x0[:, 0], acc)
            it = it + go.to(I32)
        return torch.cat([o0[:, None], torch.zeros_like(x[:, 1:])], 1), acc
    if name == "dyn_sublane":
        idx = x[:, 0, 0].to(I32).long()
        o = torch.zeros_like(x)
        o[torch.arange(n, device=dev), idx] = x[:, 0] * 2.0
        return o, o[torch.arange(n, device=dev), idx, 5]
    if name == "smem_writes":
        return ((2 * 511 + x) + (2 * 3 + x),)
    if name == "dot_argmin":
        a, b = ins
        d2 = a[:, :, 0, None] * b[:, None, 0, :]
        for k in range(1, a.shape[2]):
            d2 = d2 + a[:, :, k, None] * b[:, None, k, :]
        rows = torch.arange(a.shape[1], dtype=I32, device=dev)[None, :, None]
        mn = torch.amin(d2, dim=1, keepdim=True)
        return (torch.amin(torch.where(d2 <= mn, rows, NONE), dim=1),)
    if name == "nested_loops":
        L, m = x[:, 0], x[:, 1]
        c = torch.arange(8, dtype=I32, device=dev)
        o = torch.where((c[None] < L[:, None])[..., None], c.to(F32)[None, :, None], 0.0)
        return o.expand(n, 8, 128).contiguous(), L * m
    if name == "grid_carry":
        acc, out = torch.zeros(n, dtype=I32, device=dev), []
        for g in range(x.shape[1]):
            acc = acc + x[:, g, 0]
            out.append(acc)
        return (torch.stack(out, 1),)
    if name == "group32_sum":
        return (sum_last(x.reshape(n, 8, 4, 32)),)
    if name == "scratch_diag":
        i = torch.arange(8, device=dev)
        d = (x * 3.0)[:, i, i].to(I32)
        return (sum_last(d),)
    if name == "reduce_while":
        nn = sum_last(x.reshape(n, -1)).to(I32) + torch.amax(x[:, 0], dim=1).to(I32) * 2
        c = torch.zeros_like(nn)
        while bool((c < 10 * nn).any()):
            c = torch.where(c < 10 * nn, c + nn, c)
        return (c,)
    if name == "halton_digits":
        i = x[:, None] + torch.arange(64, dtype=I32, device=dev)[None]
        num = torch.zeros_like(i)
        for _ in range(8):
            num = num * 3 + i % 3
            i = torch.div(i, 3, rounding_mode="floor")
        val = num.to(F32) * torch.tensor(INV_HALTON, device=dev)
        return (val[..., None].expand(n, 64, 128).contiguous(),)
    if name == "cumsum_first":
        v = x[:, 0]
        acc = torch.cumsum(v.to(I32), dim=1)  # integer counts: exact
        lanes = torch.arange(128, dtype=I32, device=dev)
        third = torch.where((v > 0) & (acc == 3), lanes, NONE)
        return torch.amin(third, dim=1), acc.to(F32)
    if name == "transpose":
        return (x[:, 0, :64, None].contiguous(),)
    if name == "static_reads":
        scr = x * 2.0
        return (torch.stack([scr[:, 3, 5], scr[:, 7, 127]], 1).to(I32),)
    if name == "dyn_rows_while":
        L = ins[1]
        o = torch.zeros_like(x)
        o[:, 0] = x[:, 0]
        for r in range(1, x.shape[1]):
            o[:, r] = torch.where((r <= L)[:, None], o[:, r - 1] + 1.0, 0.0)
        return o, L + 1
    if name == "smem_int_out":
        return ((torch.arange(512, dtype=I32, device=dev)[None] * 3 + x[:, None])[:, None],)
    raise ValueError(f"unknown probe {name!r}")


def reference(name: str, *ins: np.ndarray) -> tuple[np.ndarray, ...]:
    """The probe in numpy, tile by tile, as the probe files write it."""
    outs = []
    for t in range(ins[0].shape[0]):
        outs.append(_reference_tile(name, *(a[t] for a in ins)))
    return tuple(np.stack(o) for o in zip(*outs))


def _reference_tile(name, x, y=None):
    f32 = np.float32
    if name == "while_carry":
        o = np.zeros_like(x)
        i, acc = 0, f32(0)
        while i < 10 and acc < 100.0:
            o[0] = o[0] + x[0]
            acc = f32(acc + x[0, 0])
            i += 1
        return o, acc
    if name == "dyn_sublane":
        o = np.zeros_like(x)
        idx = int(x[0, 0])
        o[idx] = x[0] * f32(2)
        return o, o[idx, 5]
    if name == "smem_writes":
        smem = 2 * np.arange(512, dtype=np.int32) + x
        return (np.int32(smem[511] + smem[3]),)
    if name == "dot_argmin":
        d2 = x.astype(np.float64) @ y.astype(np.float64)  # exact for these integers
        return (np.argmin(d2, axis=0).astype(np.int32),)
    if name == "nested_loops":
        o, s = np.zeros((8, 128), f32), 0
        for c in range(int(x[0])):
            s += int(x[1])
            o[c] = c
        return o, np.int32(s)
    if name == "grid_carry":
        return (np.cumsum(x[:, 0]).astype(np.int32),)
    if name == "group32_sum":
        return (x.reshape(8, 4, 32).sum(-1),)
    if name == "scratch_diag":
        return (np.int32(sum(int(x[i, i] * f32(3)) for i in range(8))),)
    if name == "reduce_while":
        n = int(x.sum()) + int(x[0].max()) * 2
        c = 0
        while c < 10 * n:
            c += n
        return (np.int32(c),)
    if name == "halton_digits":
        i, nn = int(x) + np.arange(64, dtype=np.int64), np.zeros(64, np.int64)
        for _ in range(8):
            nn = nn * 3 + i % 3
            i //= 3
        return (np.repeat((nn.astype(f32) * INV_HALTON)[:, None], 128, 1),)
    if name == "cumsum_first":
        acc = np.cumsum(x[0]).astype(f32)
        hits = np.flatnonzero((x[0] > 0) & (acc == 3.0))
        return np.int32(hits[0] if len(hits) else NONE), acc
    if name == "transpose":
        return (x[0, :64, None].copy(),)
    if name == "static_reads":
        return (np.array([int(x[3, 5] * f32(2)), int(x[7, 127] * f32(2))], np.int32),)
    if name == "dyn_rows_while":
        o = np.zeros_like(x)
        o[0] = x[0]
        for r in range(1, int(y) + 1):
            o[r] = o[r - 1] + f32(1)
        return o, np.int32(int(y) + 1)
    return (np.arange(512, dtype=np.int32)[None] * 3 + x,)  # smem_int_out


def tile0_ok(name: str, outs) -> bool:
    """Tile 0's outputs equal the constants the TPU probe file asserts."""
    o = [np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)[0] for t in outs]
    if name == "while_carry":
        return float(o[1]) == 10.0
    if name == "dyn_sublane":
        return float(o[0][3, 5]) == 6.0 and float(o[1]) == 6.0
    if name == "smem_writes":
        return int(o[0]) == 1022 + 6
    if name == "dot_argmin":
        a, b = (t.astype(np.float64) for t in _tile0(name))
        return bool((o[0] == np.argmin(a @ b, axis=0)).all())
    if name == "nested_loops":
        return float(o[0][4, 3]) == 4.0 and int(o[1]) == 15
    if name == "grid_carry":
        return list(o[0]) == [1, 3, 6, 10]
    if name == "group32_sum":
        return float(o[0][2, 3]) == 32.0
    if name == "scratch_diag":
        return int(o[0]) == 24
    if name == "reduce_while":
        n = 1024 + 2
        return int(o[0]) == ((10 * n + n - 1) // n) * n
    if name == "halton_digits":
        want = []
        for k in range(64):
            i, nn = k + 1000, 0
            for _ in range(8):
                nn = nn * 3 + i % 3
                i //= 3
            want.append(np.float32(nn) / 3**8)
        return bool(np.allclose(o[0][:, 0], np.asarray(want, np.float32)))
    if name == "cumsum_first":
        return int(o[0]) == 40 and float(o[1][127]) == 4.0
    if name == "transpose":
        return list(o[0][:5, 0]) == [0, 1, 2, 3, 4]
    if name == "static_reads":
        return int(o[0][0]) == 42 and int(o[0][1]) == 42
    if name == "dyn_rows_while":
        return float(o[0][10, 0]) == 10.0 and int(o[1]) == 11
    return int(o[0][0, 511]) == 1533  # smem_int_out


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check(name, ins):
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}")
    specs = _INPUTS[name]
    if len(ins) != len(specs):
        raise ValueError(f"probe {name}: takes {len(specs)} input tensors")
    n = ins[0].shape[0] if ins[0].dim() else -1
    for t, (dtype, shape) in zip(ins, specs):
        if t.dtype != dtype or tuple(t.shape) != (n,) + shape:
            raise ValueError(f"probe {name}: inputs must be {dtype} (tiles, *{shape})")
        if t.device != ins[0].device:
            raise ValueError(f"probe {name}: inputs must share a device")
    x = ins[0]
    if name == "dyn_sublane":
        ok = bool(((x[:, 0, 0] >= 0) & (x[:, 0, 0] < 16)).all())
    elif name == "nested_loops":
        ok = bool(((x[:, 0] >= 0) & (x[:, 0] <= 8) & (x[:, 1] >= 0)).all())
    elif name == "dyn_rows_while":
        ok = bool(((ins[1] >= 0) & (ins[1] < 16)).all())
    elif name == "cumsum_first":
        ok = bool(((x[:, 0] == 0) | (x[:, 0] == 1)).all())
    elif name == "halton_digits":
        ok = bool((x >= 0).all()) and (not x.numel() or int(x.max()) + 63 < 2**31)
    else:
        ok = True
    if not ok:
        raise ValueError(f"probe {name}: an input lies outside the probe's range")


def run(name: str, *ins: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Run probe `name` (see the module doc): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    _check(name, ins)
    if not ins[0].is_cuda:
        return plain(name, *ins)
    return launch(name, *ins)


def launch(name: str, *ins: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Launch the kernel of probe `name` on CUDA tensors that `run` has
    checked (the range check reads inputs back to the host, so timing loops
    call this).  Kept to the few host calls a launch needs: its host time is
    most of a probe's time at 4096 tiles."""
    global LAUNCHES
    ins = [build.aligned(t) for t in ins]
    x = ins[0]
    n = x.shape[0]
    outs = tuple(x.new_empty((n,) + shape, dtype=dtype) for dtype, shape in _OUTPUTS[name])
    if n == 0:
        return outs
    ptrs = ([t.data_ptr() for t in ins] + [None] * (2 - len(ins))
            + [t.data_ptr() for t in outs] + [None] * (2 - len(outs)))
    err = (_LIB or library()).probe_mosaic_launch(_INDEX[name], *ptrs, n,
                                                  build.stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"probe_mosaic kernel launch failed with error {err}")
    LAUNCHES += 1
    return outs


def launch_empty(device) -> None:
    """Launch an empty kernel on `device`'s current stream: the floor of a
    launch, which `chip_smoke.py` and `bench/time_probes.py` time beside the
    probes (not counted in LAUNCHES)."""
    err = (_LIB or library()).probe_mosaic_empty(build.stream_handle(device))
    if err != 0:
        raise RuntimeError(f"probe_mosaic empty kernel launch failed with error {err}")


# ---------------------------------------------------------------------------
# Work count (the bound in chip_smoke.py)
# ---------------------------------------------------------------------------


SECTOR = 32  # bytes: the unit the card reads device memory in
_ROW = 128 * 4  # one row of a tile, 16 sectors (tiles and rows are sector-aligned)
# per probe reading part of a tile: the bytes of one tile's first input that
# its outputs depend on, in whole sectors
_TILE_READ = {
    "while_carry": _ROW,            # row 0 (x[0, 0] included)
    "dyn_sublane": _ROW,            # row 0
    "cumsum_first": _ROW,           # row 0
    "dyn_rows_while": _ROW,         # row 0
    "transpose": 64 * 4,            # x[0, :64]
    "scratch_diag": 8 * SECTOR,     # x[i, i], i < 8: one word on each of 8 rows
    "static_reads": 2 * SECTOR,     # x[3, 5] and x[7, 127]
}


def _sectors(n_bytes: int) -> int:
    return -(-n_bytes // SECTOR) * SECTOR


def work(name: str, ins) -> tuple[int, int]:
    """(32-bit operations, bytes) probe `name` must do and move on these
    inputs: the input bytes its outputs depend on, read once in 32-byte
    sectors (all of an input unless `_TILE_READ` names the part), each
    output written once; the operations of the loops that run on this data
    (integer operations counted like FP32 ones)."""
    n = ins[0].shape[0]
    read = [n * _TILE_READ[name]] if name in _TILE_READ else [
        _sectors(ins[0].numel() * ins[0].element_size())]
    read += [_sectors(t.numel() * t.element_size()) for t in ins[1:]]
    n_bytes = sum(read) + sum(n * int(np.prod(shape)) * 4 for _, shape in _OUTPUTS[name])
    x = ins[0]
    if name == "while_carry":
        ops = int(_while_iterations(x).sum()) * (128 + 3)  # a row's adds, acc, i, the test
    elif name == "dot_argmin":
        ops = n * 512 * 64 * (2 * 8 - 1 + 1)  # 8 products, 7 sums, a compare
    elif name in ("group32_sum", "reduce_while"):
        ops = n * 1024
    elif name == "halton_digits":
        ops = n * 64 * 8 * 4  # a row's digits: multiply, add, mod, div
    elif name == "cumsum_first":
        ops = n * 128
    elif name == "grid_carry":
        ops = n * 4
    elif name == "nested_loops":
        ops = int(x[:, 0].sum() + (x[:, 0] * x[:, 1]).sum())
    elif name == "dyn_rows_while":
        ops = int(ins[1].sum()) * 128
    else:
        ops = 0
    return ops, n_bytes


def _while_iterations(x: torch.Tensor) -> torch.Tensor:
    """(tiles,) iterations of while_carry's loop."""
    acc = torch.zeros(x.shape[0], device=x.device)
    it = torch.zeros(x.shape[0], dtype=I32, device=x.device)
    for _ in range(10):
        go = (it < 10) & (acc < 100.0)
        acc = torch.where(go, acc + x[:, 0, 0], acc)
        it = it + go.to(I32)
    return it
