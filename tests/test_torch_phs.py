"""Port parity: `planning/phs.py` against `vamp_mvt_tpu/planning/phs.py`.

`make_phs` builds the rotation and scaling in float64 numpy in both packages
and casts once to float32: equal bit for bit, as are AORRTC's batched
transforms (`_phs_rotations`, `_phs_batch`).  `phs_samples` is float32
arithmetic; XLA's `log` and `pow` on the CPU round differently from torch's
(11% of XLA's logs and 1% of its `u ** (1/d)` differ by an ulp on these
inputs), so the samples are held within atol 2e-6: the largest difference
measured is 4.8e-7 at d = 3 and 7 and 9.5e-7 at d = 14, on samples of
magnitude up to 5.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.planning import aorrtc as jaorrtc
from vamp_mvt_tpu.planning import phs as jphs
from vamp_mvt_tpu_torch.planning import aorrtc, phs

torch.set_num_threads(1)

SAMPLE_ATOL = 2e-6


def _ends(d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, d), rng.uniform(-2, 2, d)


@pytest.mark.parametrize("d", [3, 7, 14])
def test_make_phs_and_measure(d):
    s, g = _ends(d)
    td = float(np.linalg.norm(g - s)) * 1.3
    for got, want in zip(phs.make_phs(s, g, td, "cpu"), jphs.make_phs(s, g, td)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # coincident foci: the identity rotation
    got = phs.make_phs(s, s, 1.0, "cpu")
    assert np.array_equal(got.tf.numpy(), np.asarray(jphs.make_phs(s, s, 1.0).tf))
    assert phs.phs_measure(d, 1.0, 1.7) == jphs.phs_measure(d, 1.0, 1.7)
    assert phs.phs_measure(d, 2.0, 1.0) == jphs.phs_measure(d, 2.0, 1.0) == 0.0


@pytest.mark.parametrize("d", [3, 7, 14])
def test_phs_samples(d):
    s, g = _ends(d, d)
    td = float(np.linalg.norm(g - s)) * 1.2
    rng = np.random.default_rng(d)
    unit = rng.uniform(0, 1, (2048, d)).astype(np.float32)
    unit[0], unit[1] = 0.0, 1.0                    # the clip to [1e-7, 1 - 1e-7]
    ru = rng.uniform(0, 1, 2048).astype(np.float32)
    want = np.asarray(jax.jit(jphs.phs_samples)(jphs.make_phs(s, g, td), jnp.asarray(unit),
                                                jnp.asarray(ru)))
    got = phs.phs_samples(phs.make_phs(s, g, td, "cpu"), torch.as_tensor(unit),
                          torch.as_tensor(ru)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL)
    # every sample lies in the ellipsoid: |x - s| + |x - g| <= td
    foci = np.linalg.norm(got - s, axis=1) + np.linalg.norm(got - g, axis=1)
    assert (foci <= td * (1 + 1e-5)).all()


def test_batched_phs():
    """One transform a problem (leading axis B), as AORRTC's solve_batch
    builds them, against the JAX package's `_phs_batch` and against each
    problem's own transform."""
    B, d = 4, 7
    rng = np.random.default_rng(5)
    starts, goals0 = rng.uniform(-2, 2, (B, d)), rng.uniform(-2, 2, (B, d))
    diam = np.linalg.norm(goals0 - starts, axis=1) * np.array([1.0, 1.1, 1.5, 3.0])
    rots = aorrtc._phs_rotations(starts, goals0)
    assert np.array_equal(rots, jaorrtc._phs_rotations(starts, goals0))
    got = aorrtc._phs_batch(rots, starts, goals0, diam, "cpu")
    for a, b in zip(got, jaorrtc._phs_batch(rots, starts, goals0, diam)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    unit = torch.as_tensor(rng.uniform(0, 1, (B, 16, d)).astype(np.float32))
    ru = torch.as_tensor(rng.uniform(0, 1, (B, 16)).astype(np.float32))
    batched = phs.phs_samples(got, unit, ru)
    for i in range(B):
        # torch's CPU log and pow take vectorized and scalar paths by the
        # tensor's layout: the same input can round apart by an ulp
        one = phs.phs_samples(phs.PHS(*(t[i] for t in got)), unit[i], ru[i])
        torch.testing.assert_close(batched[i], one, rtol=0, atol=1e-6)
    assert math.isclose(float(got.min_td[0]), float(np.linalg.norm(goals0[0] - starts[0])),
                        rel_tol=1e-6)
