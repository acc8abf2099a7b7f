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
