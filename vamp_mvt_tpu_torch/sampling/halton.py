"""Deterministic Halton sampling, closed-form over the sample index.

Port of `vamp_mvt_tpu/sampling/halton.py`, bit-identical to it: the radical
inverse is built from int32 digits (per-base digit caps keep every integer
below 2^24), then the float32 numerator is MULTIPLIED by the float32 constant
1/denom, exactly as the JAX package does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIMES = (3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59)

# Exactness horizon (the reference resets its generator after 1M samples).
MAX_INDEX = 1_000_000


def _digit_counts(dim: int) -> list[int]:
    counts = []
    for b in PRIMES[:dim]:
        # Largest D with b^D < 2^24 (exact float32 integers).
        D = int(math.floor(24 * math.log(2) / math.log(b)))
        if b**D > 2**24:
            D -= 1
        counts.append(D)
    return counts


def halton(indices: torch.Tensor, dim: int) -> torch.Tensor:
    """Radical-inverse samples in the unit cube.

    indices: (...,) integer sample indices, 1-based.  Returns (..., dim)
    float32 samples in [0, 1) on the indices' device.
    """
    indices = indices.to(torch.int32)
    counts = _digit_counts(dim)
    cols = []
    for j in range(dim):
        b = PRIMES[j]
        i = indices
        n = torch.zeros_like(indices)
        for _ in range(counts[j]):
            n = n * b + i % b
            i = i // b
        denom = float(b ** counts[j])
        cols.append(n.to(torch.float32) * (1.0 / denom))
    return torch.stack(cols, dim=-1)


def halton_numpy(index: int, dim: int) -> np.ndarray:
    """Host-side scalar reference implementation (for tests)."""
    out = []
    for j in range(dim):
        b = PRIMES[j]
        f, r, i = 1.0, 0.0, index
        while i > 0:
            f /= b
            r += f * (i % b)
            i //= b
        out.append(np.float32(r))
    return np.array(out, dtype=np.float32)
