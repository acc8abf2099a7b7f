"""Path simplification with the SHORTCUT + BSPLINE megakernel.

Port of `vamp_mvt_tpu/planning/simplify_mega.py`.  On CUDA tensors
`simplify_batch_mega` launches the kernel (`csrc/simplify_mega.cu`, one block
per path, the path in shared memory); on CPU tensors it runs the plain
version, `simplify_batch_plain`: the lockstep simplifier of
`planning/simplify.py` with pair and job capacities sized each driver
iteration so that none binds, since the kernel checks every candidate
segment exactly.  Only the default operation sequence ("shortcut",
"bspline") has a kernel (`supports`); `run_suite` sends other settings to
`simplify.simplify_batch_compact`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.ops.kernels import simplify_mega_cuda
from vamp_mvt_tpu_torch.planning import simplify
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.planning.simplify import SimplifyResult, SimplifySettings
from vamp_mvt_tpu_torch.planning.validate import norm_last
from vamp_mvt_tpu_torch.robots.spec import RobotSpec

_PLAIN_CHUNK = 64


def supports(settings: SimplifySettings) -> bool:
    return tuple(settings.operations) == ("shortcut", "bspline")


def simplify_batch_mega(
    spec: RobotSpec,
    envs: Environment,
    paths: torch.Tensor,       # (B, P, d)
    lengths: torch.Tensor,     # (B,)
    settings: SimplifySettings,
    device=None,
    shape=None,
) -> SimplifyResult:
    """Simplify a batch of paths with the megakernel, on `device` (default:
    the GPU).  Semantics are simplify_batch's for the default op sequence,
    with every candidate pair checked exactly (no capacity binds); `shape`
    overrides the kernel's launch shape (simplify_mega_cuda.simplify)."""
    if not supports(settings):
        raise ValueError("megakernel supports operations=('shortcut','bspline')")
    dev = resolve_device(device)
    envs = envs.to(dev)
    paths, lengths = paths.to(dev), lengths.to(dev)
    if dev.type != "cuda":
        return simplify_batch_plain(spec, envs, paths, lengths, settings)
    out, scal, _ = simplify_mega_cuda.simplify(
        spec, envs, paths.contiguous(), lengths.to(torch.int32).contiguous(), settings, shape
    )
    return _finalize(out, scal)


def _finalize(out: torch.Tensor, scal: torch.Tensor) -> SimplifyResult:
    length = scal[:, 0]
    path = simplify._pad_tail(out, length.long())
    return SimplifyResult(
        path=path, path_length=length, cost=simplify.path_cost(path, length.long()),
        iterations=scal[:, 1],
    )


# ---------------------------------------------------------------------------
# Plain version (CPU tensors, and the check of the kernel on the card)
# ---------------------------------------------------------------------------


def _caps(spec: RobotSpec, path: torch.Tensor, length: torch.Tensor, s: SimplifySettings):
    """Pair and job capacities no pass of one driver iteration can exceed.

    SHORTCUT checks each pair (i, j), j >= i + 2, j < length, at its exact
    point count.  A BSPLINE pass pulls vertex j of the subdivided path to
    mid_j and checks prev -> mid_j -> next, which is at most (1 + mi) times
    as long as prev -> j -> next (mi the midpoint weight, in [0, 1]); each
    subdivided half belongs to one pull, so the checked segments are at most
    (1 + mi) times the path's cost C, which neither SHORTCUT nor subdivision
    raises.  With one rounded-up point count per segment (at most P of
    them), a pass checks at most 8 * ((1 + mi) * C * res / 8 + P) points."""
    B, P, _ = path.shape
    res8 = spec.resolution / validate_mod.RAKE
    dist = norm_last(path[:, :, None] - path[:, None])                  # (B, P, P)
    k = torch.arange(P, device=path.device)
    live = (k[None, :, None] < length[:, None, None]) & (k[None, None] < length[:, None, None])
    n = torch.clamp_min(torch.ceil(dist * res8), 1.0)
    pair = live & (k[None, None] >= k[None, :, None] + 2)
    jobs = int((validate_mod.RAKE * n * pair).sum((1, 2)).max())
    L = int(length.max())
    pairs = max((L - 1) * (L - 2) // 2, 1)
    cost = float(simplify.path_cost(path, length).max())
    mi = s.bspline_midpoint_interpolation
    # 1% and P more segments above the bound absorb float32 rounding
    bspline = validate_mod.RAKE * (int(np.ceil(1.01 * (1.0 + mi) * cost * res8)) + 2 * P)
    return pairs, max(jobs, 1), bspline


def _plain_chunk(spec, envs, paths, lengths, s: SimplifySettings) -> SimplifyResult:
    lengths = lengths.to(torch.long)
    straight = simplify._straight(spec, envs, paths, lengths)
    path, length = paths, lengths
    changed = torch.ones_like(straight)
    iters = torch.zeros_like(lengths)
    keys = simplify.default_keys(paths.shape[0], paths.device)
    while True:
        act = changed & (iters < s.max_iterations) & ~straight
        if not bool(act.any()):
            break
        pairs, jobs, bspline = _caps(spec, path, length, s)
        body = simplify._driver_iteration(
            spec, envs, dataclasses.replace(s, bspline_jobs=bspline), pairs, jobs
        )
        # the kernel's ops draw no random numbers: the keys are never read
        new_path, new_len, new_changed, _ = body(path, length, keys)
        path = torch.where(act[:, None, None], new_path, path)
        length = torch.where(act, new_len, length)
        changed = torch.where(act, new_changed, changed)
        iters = torch.where(act, iters + 1, iters)
    return simplify._finish(path, length, iters, straight, paths, lengths)


def simplify_batch_plain(spec, envs, paths, lengths, settings):
    """The kernel's plain version: the lockstep simplifier (simplify.py) with
    capacities that never bind, _PLAIN_CHUNK problems at a time (a chunk's
    job lists are padded to its largest problem's)."""
    if not supports(settings):
        raise ValueError("megakernel supports operations=('shortcut','bspline')")
    mi = settings.bspline_midpoint_interpolation
    if not 0.0 <= mi <= 1.0:
        raise ValueError("the plain version bounds its capacities for a midpoint weight in [0, 1]")
    B = paths.shape[0]
    parts = []
    for i in range(0, B, _PLAIN_CHUNK):
        sl = slice(i, i + _PLAIN_CHUNK)
        e = envs.map(lambda t: t[sl] if t.shape[0] > 1 else t)
        parts.append(_plain_chunk(spec, e, paths[sl], lengths[sl], settings))
    return SimplifyResult(*(torch.cat(xs) for xs in zip(*parts)))
