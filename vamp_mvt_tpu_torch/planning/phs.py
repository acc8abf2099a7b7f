"""Prolate hyperspheroid informed sampling (reference planning/phs.hh).

Port of `vamp_mvt_tpu/planning/phs.py`.  The PHS transform maps unit-ball
samples into the ellipsoid of configurations whose start -> x -> goal path
is shorter than the current best cost: the rotation solves the Wahba problem
(SVD, phs.hh:108-130), the scaling is diag(t/2, c/2, ...), the offset the
foci midpoint.  The direction is the reference's logit-normal map of the
underlying stream's unit sample (phs.hh:173-190), the radius u^(1/d).

`PHS` holds tensors with an optional leading batch axis (one transform a
problem, as the JAX package vmaps it).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vamp_mvt_tpu_torch.planning.prm import unit_ball_measure
from vamp_mvt_tpu_torch.planning.validate import sum_last


class PHS(NamedTuple):
    center: torch.Tensor   # ([B,] d)
    tf: torch.Tensor       # ([B,] d, d): rot @ diag(t/2, c/2, ...)
    min_td: torch.Tensor   # ([B]) foci distance


def wahba_rotation(start: np.ndarray, goal: np.ndarray) -> np.ndarray:
    """(d, d) float64 rotation taking the first axis to goal - start."""
    d = len(start)
    diff = np.asarray(goal, np.float64) - np.asarray(start, np.float64)
    n = float(np.linalg.norm(diff))
    if n < 1e-6:
        return np.eye(d)
    U, _, Vt = np.linalg.svd(np.outer(diff / n, np.eye(d)[0]))
    middle = np.ones(d)
    middle[-1] = np.linalg.det(U) * np.linalg.det(Vt.T)
    return U @ np.diag(middle) @ Vt


def make_phs(start, goal, transverse_diameter: float, device=None) -> PHS:
    """The transform in float64 numpy, cast to float32 on `device`."""
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    d = len(start)
    min_td = float(np.linalg.norm(goal - start))
    conj = math.sqrt(max(transverse_diameter**2 - min_td**2, 0.0))
    diag = np.full(d, 0.5 * conj)
    diag[0] = 0.5 * transverse_diameter
    tf = wahba_rotation(start, goal) @ np.diag(diag)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return PHS(center=f32(0.5 * (start + goal)), tf=f32(tf), min_td=f32(min_td))


def phs_measure(dim: int, d_foci: float, d_transverse: float) -> float:
    """Lebesgue measure of the PHS (reference phs.hh:19-31)."""
    conj = math.sqrt(max(d_transverse**2 - d_foci**2, 0.0))
    m = d_transverse / 2.0
    for _ in range(1, dim):
        m *= conj / 2.0
    return m * unit_ball_measure(dim)


def phs_samples(phs: PHS, unit: torch.Tensor, radius_u: torch.Tensor) -> torch.Tensor:
    """Map unit-cube samples (..., d) and radius uniforms (...) into the PHS
    (ProlateHyperspheroidRNG::next, phs.hh:161-194).  With a batched PHS the
    leading axis of `unit` is the batch.  Clamping to the joint limits is
    the caller's job."""
    d = unit.shape[-1]
    u = torch.clamp(unit, 1e-7, 1.0 - 1e-7)
    logit = torch.log(u / (1.0 - u)) * math.sqrt(math.pi / 8.0)
    norm = torch.sqrt(sum_last(logit * logit))[..., None]
    direction = logit / torch.clamp_min(norm, 1e-12)
    ball = direction * (radius_u ** (1.0 / d))[..., None]
    tf = phs.tf
    if tf.dim() == 3:  # one transform a problem: (B, d, d) against (B, ..., d)
        tf = tf.reshape(tf.shape[:1] + (1,) * (ball.dim() - 2) + tf.shape[1:])
    # tf @ ball summed in index order
    out = tf[..., 0] * ball[..., 0, None]
    for j in range(1, d):
        out = out + tf[..., j] * ball[..., j, None]
    center = phs.center
    if center.dim() == 2:
        center = center.reshape(center.shape[:1] + (1,) * (ball.dim() - 2) + center.shape[1:])
    return out + center
