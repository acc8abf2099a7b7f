"""Counter-based threefry2x32 streams, bit for bit those of `jax.random`.

The JAX package draws its random quantities (the "threefry" planner sampler,
the PHS radius and AORRTC's cost-bound uniforms, REDUCE and PERTURB) with
`jax.random` under its default, partitionable threefry layout
(`jax_threefry_partitionable`):

    PRNGKey(s)           the key (0, s)
    fold_in(k, i)        threefry(k, (0, i))
    split(k, n)[j]       threefry(k, (0, j))
    bits(k, n)[j]        y0 ^ y1 of threefry(k, (0, j))
    uniform(k, n)        ((bits >> 9) | 0x3F800000) read as float32, less 1
    randint(k, lo, hi)   k1, k2 = split(k); the high and low words' residues
                         combined modulo the span (uint32 arithmetic)

Words are int64 tensors holding values in [0, 2^32): torch's uint32 lacks
shifts and adds on CUDA.  A key is a (..., 2) int64 tensor; every function
batches over the leading axes and runs on the key's device.  Integer data
(indices, counters) are JAX int32 values taken as uint32: they are masked to
32 bits, never clamped.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x) -> torch.Tensor:
    return x & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block (20 rounds) of `key` (..., 2) on the counter
    words (x0, x1), broadcast together; returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + i + 1)
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2^32): (2,) int64."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.long, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` of `key` (..., 2) with int32 `data` (...)."""
    data = torch.as_tensor(data, device=key.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(data, dtype=torch.long),
                          _u32(data.to(torch.long)))
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` for keys (..., 2): (..., num, 2)."""
    j = torch.arange(num, dtype=torch.long, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(j), j)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,))` (uint32) for keys (..., 2): (..., n)."""
    j = torch.arange(n, dtype=torch.long, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(j), j)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))` in [0, 1) for keys (..., 2):
    (..., n) float32."""
    f = ((bits(key, n) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def randint(key: torch.Tensor, minval, maxval) -> torch.Tensor:
    """`jax.random.randint(key, (), minval, maxval)` (int32) for keys
    (..., 2) and int32 bounds broadcast to (...): (...) int64 values of the
    int32 result."""
    dev = key.device
    lo = torch.as_tensor(minval, device=dev).to(torch.long)
    hi = torch.as_tensor(maxval, device=dev).to(torch.long)
    k = split(key, 2)
    high, low = bits(k[..., 0, :], 1)[..., 0], bits(k[..., 1, :], 1)[..., 0]
    span = torch.where(hi <= lo, 1, _u32(hi - lo))
    m = 65536 % span
    mult = _u32(m * m) % span
    off = _u32(_u32((high % span) * mult) + low % span) % span
    out = _u32(lo + off)
    return torch.where(out >= 2**31, out - 2**32, out)



# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# a polynomial in w - 2.5 where w = -log1p(-x^2) < 5, else in sqrt(w) - 3.
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by XLA's polynomials, Horner steps as multiply-adds
    (`addcmul`): within 2 ulp of `jax.lax.erf_inv` on the CPU, where
    `torch.erfinv` parts from it by up to ~90 ulp in the tails."""
    w = -torch.log1p(-x * x)
    central = w < 5.0
    t = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0])
    for c, e in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.addcmul(torch.where(central, c, e), p, t)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_CHUNK = 1 << 20  # draws a pass: the int64 temporaries stay small


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal(key, shape)` (float32) for one key (2,): the
    uniforms on [nextafter(-1, 0), 1) from the same bits, bit for bit JAX's,
    then sqrt(2) * erfinv(u) (`erfinv`: within 2 ulp of XLA's)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    dev = key.device
    lo = torch.tensor(-1.0, dtype=torch.float32).nextafter(torch.tensor(0.0)).to(dev)
    root2 = torch.tensor(2.0 ** 0.5, dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for i in range(0, n, _NORMAL_CHUNK):
        j = torch.arange(i, min(i + _NORMAL_CHUNK, n), dtype=torch.long, device=dev)
        y0, y1 = threefry2x32(key, torch.zeros_like(j), j)
        f = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        out[i : i + j.shape[0]] = erfinv(torch.maximum(f * (1.0 - lo) + lo, lo)) * root2
    return out.reshape(shape)
