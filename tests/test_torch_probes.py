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
