"""Port parity: Halton samples are bit-identical to the JAX package's."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.sampling import halton as jhalton
from vamp_mvt_tpu_torch.sampling import halton

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", [3, 6, 7, 8, 14, 16])
def test_halton_bit_identical_random_indices(dim):
    idx = np.random.default_rng(dim).integers(1, 1_000_001, 20000).astype(np.int32)
    ref = np.asarray(jax.jit(lambda i: jhalton.halton(i, dim))(jnp.asarray(idx)))
    got = halton.halton(torch.as_tensor(idx), dim).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_halton_bit_identical_deep_indices():
    # the deep indices of tests/test_halton.py, plus the horizon's end
    idx = np.array([1, 7, 100, 9999, 123456, 999999, 1_000_000], np.int32)
    for dim in (7, 14):
        ref = np.asarray(jhalton.halton(jnp.asarray(idx), dim))
        got = halton.halton(torch.as_tensor(idx), dim).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
        for k, i in enumerate(idx):
            np.testing.assert_allclose(got[k], halton.halton_numpy(int(i), dim), atol=2e-7)
    assert halton._digit_counts(16) == jhalton._digit_counts(16)
    assert halton.PRIMES == jhalton.PRIMES
