"""CAPT: Collision-Affording Point Tree.

Port of `vamp_mvt_tpu/collision/capt.py`.  The build is host-side numpy or
the C++ library (`use_native`), with the arrays bit-identical to the JAX
package's; the query is plain PyTorch.  A complete binary kd-tree over the
cloud (padded to 2^n with +inf), median split on cycling axes, where each
leaf stores an affordance buffer: every point within r_max + r_point of the
leaf's cell (reference src/impl/vamp/collision/capt.hh:125-287, with the JAX
package's fix of the sibling boundary-candidate scan).

The query descends n levels on the implicit `tests` heap and scans one
leaf's buffer; a sphere hits iff d^2 <= (r + r_point)^2.  The top-AABB reject
is inflated by r_point (the JAX package's repair of the reference, which
tests the raw radius there and misses contacts within (r, r + r_point] of the
cloud's bounding box).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from vamp_mvt_tpu_torch import native
from vamp_mvt_tpu_torch.collision.mvt import batch_index, rows, sum3

_INF = np.float32(np.inf)


class CAPTData(NamedTuple):
    """Dense CAPT arrays (numpy from the build, tensors in an Environment,
    with any leading batch dims)."""

    tests: object       # (2^n - 1,) float32 implicit-heap split planes
    leaf_aabb: object   # (2^n, 6) float32 min / max (+inf for empty leaves)
    aff_points: object  # (2^n, CAP, 3) float32 per-leaf affordance buffers
    aff_count: object   # (2^n,) int32
    top_aabb: object    # (6,) float32
    meta: object        # (1,) float32: point radius


def _distsq_to(aabb_lo, aabb_hi, p):
    d = p - np.clip(p, aabb_lo, aabb_hi)
    return float(d @ d)


def build_capt(points, r_min: float, r_max: float, r_point: float,
               pad_leaves: int | None = None, pad_capacity: int | None = None,
               use_native: bool = True) -> CAPTData:
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if use_native and len(points):
        tests, leaf_aabb, aff_flat, aff_start, top_aabb = native.capt_build_arrays(
            points, r_min, r_max, r_point)
        return _pack_capt(tests, leaf_aabb, aff_flat, aff_start, top_aabb,
                          pad_leaves, pad_capacity, r_point)
    n = len(points)
    nlog2 = 0
    while (1 << nlog2) < n:
        nlog2 += 1
    size = 1 << nlog2
    pts = np.full((size, 3), _INF, dtype=np.float32)
    pts[:n] = points

    max_aff_l2 = (r_max + r_point) ** 2
    min_aff_l2 = (r_min + r_point) ** 2

    tests = np.full(size - 1, np.nan, dtype=np.float32)
    leaf_aabbs: list = [None] * size
    leaf_affs: list = [None] * size
    top = [np.full(3, _INF), np.full(3, -_INF)]
    argsort = np.arange(size)
    leaf_counter = [0]

    def subdivide(begin, count, i, afford, vol_lo, vol_hi, d):
        if count == 1:
            z = leaf_counter[0]
            leaf_counter[0] += 1
            rep = pts[argsort[begin]]
            aabb_lo = rep.copy()
            aabb_hi = rep.copy()
            aff_out = []
            if np.isfinite(rep[0]):
                top[0] = np.minimum(top[0], rep)
                top[1] = np.maximum(top[1], rep)
                aff_out.append(rep)
                # skip the affordance scan when the cell fits in the minimum
                # query ball around the representative (capt.hh:146)
                dmax = np.maximum(rep - vol_lo, vol_hi - rep)
                if not (dmax @ dmax <= min_aff_l2):
                    for idx in afford:
                        p = pts[idx]
                        if _distsq_to(vol_lo, vol_hi, p) <= max_aff_l2:
                            aabb_lo = np.minimum(aabb_lo, p)
                            aabb_hi = np.maximum(aabb_hi, p)
                            aff_out.append(p)
            else:
                aabb_lo = np.full(3, _INF)
                aabb_hi = np.full(3, _INF)
            leaf_aabbs[z] = np.concatenate([aabb_lo, aabb_hi])
            leaf_affs[z] = np.stack(aff_out) if aff_out else np.zeros((0, 3), np.float32)
            return

        seg = argsort[begin : begin + count]
        seg_sorted = seg[np.argsort(pts[seg, d], kind="stable")]
        argsort[begin : begin + count] = seg_sorted
        mid = count // 2
        test = (pts[seg_sorted[mid - 1], d] + pts[seg_sorted[mid], d]) / 2.0
        tests[i] = test

        lo_vol_hi = vol_hi.copy()
        lo_vol_hi[d] = test
        hi_vol_lo = vol_lo.copy()
        hi_vol_lo[d] = test

        afford = np.asarray(afford, dtype=np.int64)
        if len(afford):
            coords = pts[afford, d]
            lo_aff = afford[coords <= test + r_max]
            hi_aff = afford[coords >= test - r_max]
        else:
            lo_aff = hi_aff = afford

        # boundary candidates from the sibling's own sorted range
        lo_half = argsort[begin : begin + mid]
        hi_half = argsort[begin + mid : begin + count]
        lo_coords = pts[lo_half, d]
        hi_coords = pts[hi_half, d]
        new_for_hi = lo_half[(lo_coords >= test - r_max) & np.isfinite(lo_coords)]
        new_for_lo = hi_half[(hi_coords <= test + r_max) & np.isfinite(hi_coords)]

        nd = (d + 1) % 3
        subdivide(begin, mid, 2 * i + 1, np.concatenate([lo_aff, new_for_lo]),
                  vol_lo, lo_vol_hi, nd)
        subdivide(begin + mid, count - mid, 2 * i + 2, np.concatenate([hi_aff, new_for_hi]),
                  hi_vol_lo, vol_hi, nd)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10 * (nlog2 + 3)))
    try:
        subdivide(0, size, 0, np.zeros(0, np.int64), np.full(3, -_INF), np.full(3, _INF), 0)
    finally:
        sys.setrecursionlimit(old_limit)

    CAP = max(max((len(a) for a in leaf_affs), default=1), 1)
    if pad_capacity is not None:
        CAP = max(CAP, pad_capacity)
    NL = size if pad_leaves is None else max(size, pad_leaves)
    aff = np.full((NL, CAP, 3), _INF, dtype=np.float32)
    cnt = np.zeros(NL, np.int32)
    aabbs = np.full((NL, 6), _INF, dtype=np.float32)
    for z in range(size):
        a = leaf_affs[z]
        aff[z, : len(a)] = a
        cnt[z] = len(a)
        aabbs[z] = leaf_aabbs[z]
    return CAPTData(tests=tests, leaf_aabb=aabbs, aff_points=aff, aff_count=cnt,
                    top_aabb=np.concatenate(top).astype(np.float32),
                    meta=np.array([r_point], dtype=np.float32))


def _pack_capt(tests, leaf_aabb, aff_flat, aff_start, top_aabb, pad_leaves, pad_capacity,
               r_point) -> CAPTData:
    """Pack the native build's flat affordance arrays into padded per-leaf
    buffers."""
    size = leaf_aabb.shape[0]
    counts = np.diff(aff_start).astype(np.int32)
    CAP = max(int(counts.max()) if size else 1, 1)
    if pad_capacity is not None:
        CAP = max(CAP, pad_capacity)
    NL = size if pad_leaves is None else max(size, pad_leaves)
    aff = np.full((NL, CAP, 3), _INF, dtype=np.float32)
    aabbs = np.full((NL, 6), _INF, dtype=np.float32)
    aabbs[:size] = leaf_aabb
    cnt = np.zeros(NL, np.int32)
    cnt[:size] = counts
    total = int(aff_start[-1])
    if total:
        leaf_of = np.repeat(np.arange(size), counts)
        slot_of = np.arange(total) - aff_start[leaf_of]
        aff[leaf_of, slot_of] = aff_flat[:total]
    return CAPTData(tests=np.ascontiguousarray(tests), leaf_aabb=aabbs, aff_points=aff,
                    aff_count=cnt, top_aabb=top_aabb.astype(np.float32),
                    meta=np.array([r_point], dtype=np.float32))


def capt_collides(capt: CAPTData, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Query spheres (..., 3), radii (...) -> (...) bool collision.  The
    structure's leading dims broadcast against the query's first dims."""
    lead = tuple(capt.meta.shape[:-1])
    bi = batch_index(lead, tuple(p.shape[:-1]), p.device)
    tests = rows(capt.tests, 1)
    n_tests = tests.shape[1]
    nlog2 = (n_tests + 1).bit_length() - 1
    r_point = rows(capt.meta, 1)[bi, 0]
    top = rows(capt.top_aabb, 1)[bi]                                  # (..., 6)

    dtop = p - torch.minimum(torch.maximum(p, top[..., :3]), top[..., 3:])
    rt = r + r_point
    inside = sum3(dtop) <= rt * rt

    # n-level descent on the implicit heap (capt.hh:382-388), as flat gathers
    flat, base = tests.reshape(-1), bi * n_tests
    axes = [p[..., k].contiguous() for k in range(3)]
    idx = torch.zeros(p.shape[:-1], dtype=torch.long, device=p.device)
    for i in range(nlog2):
        go_right = axes[i % 3] >= flat[base + idx]
        idx = 2 * idx + 1 + go_right.long()
    z = idx - n_tests

    rq = r + r_point
    rq2 = rq * rq
    aabb = rows(capt.leaf_aabb, 2)[bi, z]                             # (..., 6)
    dlf = p - torch.minimum(torch.maximum(p, aabb[..., :3]), aabb[..., 3:])
    near = inside & (sum3(dlf) <= rq2)
    # only the queries near their leaf read its affordance points
    sel = near.nonzero(as_tuple=True)
    bs, zs = bi[sel], z[sel]
    pts = rows(capt.aff_points, 3)[bs, zs]                            # (n, CAP, 3)
    cnt = rows(capt.aff_count, 1)[bs, zs]
    d2 = sum3(pts - p[sel][:, None, :])
    kmask = torch.arange(pts.shape[-2], device=p.device) < cnt[:, None]
    hit = torch.zeros_like(near)
    hit[sel] = (kmask & (d2 <= rq2[sel][:, None])).any(-1)
    return hit
