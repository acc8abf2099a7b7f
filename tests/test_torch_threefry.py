"""Port parity: `sampling/threefry.py` against `jax.random`, bit for bit.

The port hard-codes the partitionable threefry2x32 layout (the installed
jax's default): PRNGKey, fold_in, split, bits, uniform and randint must give
the same 32-bit words as `jax.random` on every tested key and index,
including indices past 2^31 (JAX int32 counters taken as uint32) and
negative ones.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu_torch.sampling import threefry

SEEDS = (0, 8, 17, 23, 29, 33, 12345, 2**31 - 1)
# int32 indices as the planners hold them, and uint32 ones past 2^31
INDICES = np.array([0, 1, 2, 7, 100, 4096, 2**24 + 3, 2**31 - 1, 2**31, 2**31 + 5,
                    2**32 - 1, -1, -7], np.int64)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _jkey(k: torch.Tensor):
    return jnp.asarray(k.numpy().astype(np.uint32))


def test_layout_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(threefry.prng_key(seed).numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    want = np.stack([_words(jax.random.fold_in(k, np.uint32(i & 0xFFFFFFFF))) for i in INDICES])
    got = threefry.fold_in(threefry.prng_key(seed), torch.as_tensor(INDICES))
    assert np.array_equal(got.numpy(), want)
    # an int32 counter that wrapped: its bits fold in as the same uint32
    assert np.array_equal(threefry.fold_in(threefry.prng_key(seed), -1).numpy(),
                          _words(jax.random.fold_in(k, jnp.int32(-1))))


@pytest.mark.parametrize("num", [1, 2, 3, 5, 64])
def test_split(num):
    for seed in SEEDS:
        got = threefry.split(threefry.prng_key(seed), num)
        assert np.array_equal(got.numpy(), _words(jax.random.split(jax.random.PRNGKey(seed), num)))
    # batched over keys: each row splits on its own
    keys = threefry.fold_in(threefry.prng_key(3), torch.arange(4))
    got = threefry.split(keys, num)
    for i in range(4):
        assert np.array_equal(got[i].numpy(), _words(jax.random.split(_jkey(keys[i]), num)))


@pytest.mark.parametrize("n", [1, 3, 7, 128])
def test_bits_and_uniform(n):
    keys = threefry.fold_in(threefry.prng_key(8), torch.as_tensor(INDICES))
    bits, unif = threefry.bits(keys, n), threefry.uniform(keys, n)
    assert unif.dtype == torch.float32
    for i in range(len(INDICES)):
        jk = _jkey(keys[i])
        assert np.array_equal(bits[i].numpy(), _words(jax.random.bits(jk, (n,))))
        want = np.asarray(jax.random.uniform(jk, (n,)))
        assert np.array_equal(unif[i].numpy().view(np.uint32), want.view(np.uint32))
        # the scalar draw (shape ()) is the first of the vector's
        assert unif[i, 0].item() == float(jax.random.uniform(jk))


def test_randint():
    """Spans from empty to the whole int32 range, negative bounds, and the
    path-index draws of REDUCE and PERTURB."""
    rng = np.random.default_rng(0)
    lo = rng.integers(-100, 100, 400)
    hi = lo + rng.integers(-3, 300, 400)
    hi[:40] = lo[:40] + rng.integers(2**16, 2**30, 40)   # wide spans: the 2^16 multiplier wraps
    lo[40:45], hi[40:45] = -2**31, 2**31 - 1
    lo[45:50], hi[45:50] = 5, 5                            # empty span -> minval
    keys = threefry.fold_in(threefry.prng_key(11), torch.arange(400))
    got = threefry.randint(keys, torch.as_tensor(lo), torch.as_tensor(hi)).numpy()
    want = np.array([int(jax.random.randint(_jkey(keys[i]), (), int(lo[i]), int(hi[i])))
                     for i in range(400)])
    assert np.array_equal(got, want)
    assert (got[45:50] == 5).all()
