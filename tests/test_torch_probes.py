"""The gather probes' plain versions against numpy (`gather.reference`, the
expressions of tools/probe_gather.py), and the wrapper's refusals.  The CUDA kernels are
held against these plain versions in tests/test_torch_gpu.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch

from vamp_mvt_tpu_torch.probes import gather


@pytest.mark.parametrize("name", gather.PROBES)
def test_plain_matches_numpy(name):
    table, idx, idx2 = gather.inputs(name, tiles=3, seed=7)
    got = gather.gather(name, table, idx, idx2)
    want = gather.reference(name, table.numpy(), idx.numpy(),
                            None if idx2 is None else idx2.numpy())
    assert got.shape == (3, 8, 128) and got.dtype == table.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "bits":
        assert 0 < int(got.sum()) < got.numel()


def test_probe_inputs_are_checked():
    table, idx, idx2 = gather.inputs("two_level", tiles=1, seed=0)
    with pytest.raises(ValueError, match="idx2"):
        gather.gather("two_level", table, idx)
    with pytest.raises(ValueError, match="outside"):
        gather.gather("two_level", table, idx + 16, idx2)
    with pytest.raises(ValueError, match="table"):
        gather.gather("lane", table, idx)
    with pytest.raises(ValueError, match="unknown"):
        gather.gather("scatter", table, idx)
    assert gather.work("timing", 2) == (2 * 1024 * 64, 128 * 4 + 2 * 1024 * 8)


# ---------------------------------------------------------------------------
# The megakernel-construct probes (tools/probe_mosaic.py, probe_mosaic2.py)
# ---------------------------------------------------------------------------

from vamp_mvt_tpu_torch.probes import mosaic  # noqa: E402


@pytest.mark.parametrize("name", mosaic.PROBES)
def test_mosaic_plain_matches_numpy(name):
    """Each probe's plain version against numpy on three tiles (tile 0 the
    TPU probe's own input, two seeded), and tile 0 against the constants the
    probe file asserts."""
    ins = mosaic.inputs(name, tiles=3, seed=7)
    got = mosaic.run(name, *ins)
    want = mosaic.reference(name, *(t.numpy() for t in ins))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert mosaic.tile0_ok(name, got)


def test_mosaic_seeded_tiles_reach_both_branches():
    """The seeded tiles take the probes' data-dependent branches both ways:
    while_carry stops early on acc >= 100 in some tiles, reduce_while has
    tiles with n <= 0 (no step), cumsum_first tiles without a third 1."""
    x = mosaic.inputs("while_carry", 64, seed=1)[0]
    iters = mosaic._while_iterations(x)
    assert int(iters.min()) < 10 == int(iters.max())
    s, _ = mosaic.run("cumsum_first", *mosaic.inputs("cumsum_first", 64, seed=1))
    assert (s == mosaic.NONE).any() and (s < 128).any()
    (c,) = mosaic.run("reduce_while", *mosaic.inputs("reduce_while", 64, seed=1))
    assert (c == 0).any() and (c > 0).any()


def test_mosaic_inputs_are_checked():
    x, L = mosaic.inputs("dyn_rows_while", 2, seed=0)
    with pytest.raises(ValueError, match="outside"):
        mosaic.run("dyn_rows_while", x, L + 16)
    with pytest.raises(ValueError, match="takes 2"):
        mosaic.run("dyn_rows_while", x)
    (y,) = mosaic.inputs("cumsum_first", 2, seed=0)
    with pytest.raises(ValueError, match="outside"):
        mosaic.run("cumsum_first", y * 2)
    with pytest.raises(ValueError, match="tiles"):
        mosaic.run("group32_sum", y.double())
    with pytest.raises(ValueError, match="unknown"):
        mosaic.run("scatter", y)
    # bytes: every input once, every output once
    ops, n_bytes = mosaic.work("dot_argmin", mosaic.inputs("dot_argmin", 2, seed=0))
    assert n_bytes == 2 * (512 * 8 + 8 * 64 + 64) * 4 and ops == 2 * 512 * 64 * 16


# ---------------------------------------------------------------------------
# The kernels' formulations (csrc/probe_gather.cu, csrc/probe_mosaic.cu) as
# small torch functions, held against the plain versions on the CPU
# ---------------------------------------------------------------------------

from vamp_mvt_tpu_torch.ops.kernels import build  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_timing_window_table_equals_the_64_gathers(seed):
    """probe_gather.cu's timing probe: the window table W[i], each entry
    summed from 0.0 in k order, then one lookup W[idx] an element, equals
    the 64-gather sum bit for bit at every start lane."""
    table, _, _ = gather.inputs("timing", tiles=1, seed=seed)
    idx = torch.arange(128, dtype=torch.int32).repeat(8)[None].reshape(1, 8, 128)
    t = table[0]
    w = torch.zeros(128)
    for k in range(gather.TIMING_GATHERS):
        w = w + t[(torch.arange(128) + k) & 127]
    assert torch.equal(w[idx.long()], gather.plain("timing", table, idx))


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrapping (the kernels' unsigned
    arithmetic)."""
    return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)


def _dot_argmin_groups(a, b):
    """dot_argmin_kernel's reduction: index-order dots, each warp's 64 rows
    started at their first row and replaced only by a smaller value, then
    the eight warps merged in row order, strictly."""
    d = a[:, :, 0, None] * b[:, None, 0, :]
    for k in range(1, 8):
        d = d + a[:, :, k, None] * b[:, None, k, :]
    best, arg = [], []
    for g in range(8):
        v, r = d[:, 64 * g], torch.full(d[:, 0].shape, 64 * g, dtype=torch.int32)
        for row in range(64 * g + 1, 64 * g + 64):
            less = d[:, row] < v
            v, r = torch.where(less, d[:, row], v), torch.where(less, row, r)
        best.append(v)
        arg.append(r)
    v, r = best[0], arg[0]
    for g in range(1, 8):
        less = best[g] < v
        v, r = torch.where(less, best[g], v), torch.where(less, arg[g], r)
    return (r,)


def _mirror(name, *ins):
    """What the kernel computes for probe `name`, unit by unit as
    probe_mosaic.cu does it: closed forms, chains in registers, only the
    words the outputs depend on."""
    x = ins[0]
    n = x.shape[0]
    if name == "smem_writes":
        off = x.long()
        return (_wrap32((2 * 511 + off) + (2 * 3 + off)),)
    if name == "smem_int_out":  # unit (b, j): lanes 4 (j + 32 m) .. + 3, m < 4, of tile b
        j, m = torch.arange(32)[:, None, None], torch.arange(4)[None, :, None]
        lanes = 4 * (j + 32 * m) + torch.arange(4)  # (32, 4, 4)
        out = torch.empty(n, 512, dtype=torch.int32)
        out[:, lanes.flatten()] = _wrap32(3 * lanes.flatten()[None] + x.long()[:, None])
        return (out.reshape(n, 1, 512),)
    if name == "nested_loops":
        L, m = x[:, 0].long(), x[:, 1].long()
        r = torch.arange(8)
        o = torch.where(r[None] < L[:, None], r[None].float(), 0.0)
        return o[:, :, None].expand(n, 8, 128).contiguous(), _wrap32(L * m)
    if name == "grid_carry":
        c = [x[:, 0, 0].long()]
        for g in range(1, 4):
            c.append(c[-1] + x[:, g, 0].long())
        return (_wrap32(torch.stack(c, 1)),)
    if name == "scratch_diag":  # a lane a diagonal word, summed by shuffles (1, 2, 4)
        v = (x[:, torch.arange(8), torch.arange(8)] * 3.0).to(torch.int32).long()
        for s in (1, 2, 4):
            v = v + v[:, torch.arange(8) ^ s]
        return (_wrap32(v[:, 0]),)
    if name == "static_reads":
        return (torch.stack([(x[:, 3, 5] * 2.0).to(torch.int32),
                             (x[:, 7, 127] * 2.0).to(torch.int32)], 1),)
    if name == "while_carry":  # the trip count from x[0, 0] alone, row 0 in registers
        x00, v = x[:, 0, 0], x[:, 0]
        row, acc = torch.zeros(n, 128), torch.zeros(n)
        for _ in range(10):
            go = acc < 100.0
            row = torch.where(go[:, None], row + v, row)
            acc = torch.where(go, acc + x00, acc)
        o = torch.zeros(n, 8, 128)
        o[:, 0] = row
        return o, acc
    if name == "dyn_sublane":
        idx = x[:, 0, 0].to(torch.int32).long()
        v = x[:, 0] * 2.0
        at = (torch.arange(16)[None] == idx[:, None])[..., None]
        return torch.where(at, v[:, None], 0.0), v[:, 5]
    if name == "dyn_rows_while":  # row 0 carried down its columns, one add a row
        L = ins[1]
        v, rows = x[:, 0], [x[:, 0]]
        for r in range(1, 16):
            live = (r <= L)[:, None]
            v = torch.where(live, v + 1.0, v)
            rows.append(torch.where(live, v, 0.0))
        return torch.stack(rows, 1), L + 1
    if name == "halton_digits":  # a row's digits once, broadcast over its lanes
        i = x.long()[:, None] + torch.arange(64)
        num = torch.zeros_like(i)
        for _ in range(8):
            num = num * 3 + i % 3
            i = i // 3
        val = num.to(torch.float32) * torch.tensor(mosaic.INV_HALTON)
        return (val[..., None].expand(n, 64, 128).contiguous(),)
    if name == "dot_argmin":
        return _dot_argmin_groups(*ins)
    raise ValueError(name)


# the words of a tile's first input each probe reads (the others' outputs
# depend on every word)
_READ_MASKS = {
    "while_carry": lambda m: m[0].fill_(True),
    "dyn_sublane": lambda m: m[0].fill_(True),
    "dyn_rows_while": lambda m: m[0].fill_(True),
    "cumsum_first": lambda m: m[0].fill_(True),
    "transpose": lambda m: m[0, :64].fill_(True),
    "scratch_diag": lambda m: m.diagonal()[:8].fill_(True),
    "static_reads": lambda m: (m[3, 5].fill_(True), m[7, 127].fill_(True)),
}


def _poisoned(name, ins):
    """`ins` with every word of the first input outside the probe's read
    mask set to NaN, and the mask."""
    x = ins[0]
    mask = torch.zeros(x.shape[1:], dtype=torch.bool)
    _READ_MASKS[name](mask)
    return (torch.where(mask, x, float("nan")),) + tuple(ins[1:]), mask


@pytest.mark.parametrize("name", sorted(_READ_MASKS))
def test_outputs_depend_only_on_the_words_work_counts(name):
    """The plain version's outputs are unchanged when every input word
    outside the probe's read mask is NaN, and `work` counts exactly the
    mask's 32-byte sectors a tile."""
    ins = mosaic.inputs(name, tiles=16, seed=5)
    bad, mask = _poisoned(name, ins)
    for got, want in zip(mosaic.plain(name, *bad), mosaic.plain(name, *ins)):
        assert torch.equal(got, want)
    sectors = torch.unique(torch.nonzero(mask.flatten())[:, 0] * 4 // mosaic.SECTOR)
    assert len(sectors) * mosaic.SECTOR == mosaic._TILE_READ[name]


MIRRORED = ("while_carry", "dyn_sublane", "smem_writes", "dot_argmin", "nested_loops",
            "grid_carry", "scratch_diag", "halton_digits", "static_reads", "dyn_rows_while",
            "smem_int_out")


@pytest.mark.parametrize("name", MIRRORED)
def test_kernel_formulation_equals_plain(name):
    """Each probe_kernel / dot_argmin_kernel formulation (closed forms,
    register chains, reads of only the needed words, dot_argmin's grouped
    strict-min reduction) equals the plain version on seeded tiles (tile 0
    the TPU probe's own), fed only the words it reads."""
    ins = mosaic.inputs(name, tiles=48, seed=6)
    fed = _poisoned(name, ins)[0] if name in _READ_MASKS else ins
    got, want = _mirror(name, *fed), mosaic.plain(name, *ins)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_dot_argmin_ties_keep_the_lowest_row():
    """Columns whose minimum repeats across row groups and warps (a made of
    a few repeated rows) still give the lowest row, in the grouped
    reduction and in the plain version."""
    rng = np.random.default_rng(8)
    a = torch.as_tensor(rng.integers(-1, 2, (4, 512, 8)).astype(np.float32))
    b = torch.as_tensor(rng.integers(-2, 3, (4, 8, 64)).astype(np.float32))
    (got,) = _dot_argmin_groups(a, b)
    (want,) = mosaic.plain("dot_argmin", a, b)
    d = (a.double() @ b.double()).numpy()
    assert torch.equal(got, want)
    assert (want.numpy() == np.argmin(d, axis=1)).all()
    assert (got.numpy() >= 64).any()  # some minima first appear past the first warp's rows


WORK_4096 = {  # (operations, bytes) at 4096 tiles, seed 4 (chip_smoke.py's draw)
    "while_carry": (4304398, 18890752), "dyn_sublane": (0, 35667968),
    "smem_writes": (0, 32768), "dot_argmin": (2147483648, 76546048),
    "nested_loops": (57998, 16826368), "grid_carry": (16384, 589824),
    "group32_sum": (4194304, 17301504), "scratch_diag": (0, 1064960),
    "reduce_while": (4194304, 16793600), "halton_digits": (8388608, 134234112),
    "cumsum_first": (524288, 4210688), "transpose": (0, 2097152),
    "static_reads": (0, 294912), "dyn_rows_while": (3915008, 35684352),
    "smem_int_out": (0, 8404992),
}


@pytest.mark.parametrize("name", mosaic.PROBES)
def test_mosaic_work_at_4096_tiles(name):
    """`work` on chip_smoke.py's inputs: the bytes the outputs depend on, in
    32-byte sectors, and the operations of the loops these inputs run."""
    assert mosaic.work(name, mosaic.inputs(name, 4096, seed=4)) == WORK_4096[name]


def test_aligned_copies_only_a_misaligned_tensor():
    x = torch.arange(8 * 128 + 1, dtype=torch.int32)
    view = x[1:].view(1, 8, 128)  # contiguous, 4 bytes past an aligned start
    got = build.aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    y = torch.zeros(2, 8, 128)
    assert build.aligned(y) is y
    assert build.aligned(y.transpose(1, 2)).is_contiguous()
