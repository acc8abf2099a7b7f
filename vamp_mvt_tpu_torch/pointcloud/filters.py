"""Pointcloud downsampling filters: SCDF and center-selective voxel.

The port's copy of `vamp_mvt_tpu/pointcloud/filters.py`, host-side numpy (as
in the reference, where filtering is a one-shot C++ call before planning):

- SCDF, "space-filling-curve distance filter" (reference
  src/impl/vamp/collision/filter.hh:175-275): range/workspace cull, then six
  passes, one per axis permutation of the Morton ordering, each sorting by
  Morton code and dropping points whose predecessor (in the kept set) is
  within min_dist, with the remap window halving toward the data extent after
  each pass.
- Center-selective voxel filter (reference filter_centervox.hh:289-339): keep,
  per voxel, the single point nearest the voxel center; output in voxel
  first-occurrence order.

`use_native=True` calls the C++ library (`vamp_mvt_tpu_torch/native.py`),
which raises if it cannot load; `use_native=False` runs the numpy versions,
which select the same points.
"""

from __future__ import annotations

import itertools

import numpy as np

from vamp_mvt_tpu_torch import native

MORTON_FACTOR = 1000


def _morton_encode(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10-bit ints: x lowest bit (reference filter.hh morton_lut)."""
    out = np.zeros_like(x, dtype=np.uint32)
    for bit in range(10):
        out |= ((x >> bit) & 1).astype(np.uint32) << (3 * bit)
        out |= ((y >> bit) & 1).astype(np.uint32) << (3 * bit + 1)
        out |= ((z >> bit) & 1).astype(np.uint32) << (3 * bit + 2)
    return out


def filter_scdf(pc, min_dist: float, max_range: float, origin, workspace_min,
                workspace_max, cull: bool = True, use_native: bool = True) -> np.ndarray:
    """SCDF filter; returns the kept subset of pc (N, 3)."""
    pc = np.asarray(pc, dtype=np.float32)
    if pc.shape[0] == 0:
        return pc
    if use_native:
        return native.scdf_filter(pc, min_dist, max_range, origin, workspace_min,
                                  workspace_max, cull)
    origin = np.asarray(origin, dtype=np.float32)
    sqdist = np.float32(min_dist * min_dist)

    # reference filter.hh:192-193: scalar min over the per-axis window values
    lo = np.float32(min(origin - max_range))
    hi = np.float32(min(origin + max_range))

    if cull:
        keep = (
            (np.sum((pc - origin) ** 2, axis=1) < max_range * max_range)
            & np.all(pc >= np.asarray(workspace_min, dtype=np.float32), axis=1)
            & np.all(pc <= np.asarray(workspace_max, dtype=np.float32), axis=1)
        )
        idx = np.flatnonzero(keep).astype(np.uint32)
    else:
        idx = np.arange(pc.shape[0], dtype=np.uint32)

    for coords in itertools.permutations(range(3)):
        pts = pc[idx]
        c = ((pts[:, coords] - lo) / (hi - lo) * MORTON_FACTOR).astype(np.uint32)
        codes = _morton_encode(c[:, 0], c[:, 1], c[:, 2])
        new_lo = min(np.float32(pts.min()), hi)
        new_hi = max(np.float32(pts.max()), lo)
        order = np.argsort(codes, kind="stable")
        idx = idx[order]

        # sequential predecessor-distance dedup (kept-set chaining)
        pts = pc[idx]
        kept = [0]
        last = pts[0]
        for i in range(1, len(idx)):
            if np.sum((pts[i] - last) ** 2) > sqdist:
                kept.append(i)
                last = pts[i]
        idx = idx[np.asarray(kept)]

        hi = np.float32((new_hi + hi) / 2.0)
        lo = np.float32((new_lo + lo) / 2.0)

    return pc[idx]


def filter_centervox(pc, voxel_size: float, max_range: float, origin, workspace_min,
                     workspace_max, use_native: bool = True) -> np.ndarray:
    """Center-selective voxel filter; returns one point per occupied voxel."""
    pc = np.asarray(pc, dtype=np.float32)
    if pc.shape[0] == 0:
        return pc
    if use_native:
        return native.centervox_filter(pc, voxel_size, max_range, origin, workspace_min,
                                       workspace_max)
    origin = np.asarray(origin, dtype=np.float32)
    wmin = np.asarray(workspace_min, dtype=np.float32)
    wmax = np.asarray(workspace_max, dtype=np.float32)

    ww = float(np.max(wmax - wmin))
    grid_width = min(255, int(np.ceil(ww / voxel_size)))
    inv_scale = grid_width / ww

    keep = (np.sum((pc - origin) ** 2, axis=1) < max_range * max_range) & np.all(
        (pc >= wmin) & (pc <= wmax), axis=1
    )
    pts = pc[keep]
    if pts.shape[0] == 0:
        return pts

    v = np.clip(((pts - wmin) * inv_scale).astype(np.int32), 0, 254)
    # voxel centres from voxel_size, as the reference sets them
    # (filter_centervox.hh:22-26)
    centers = wmin + (v + 0.5) * voxel_size
    d2 = np.sum((pts - centers) ** 2, axis=1)

    key = (v[:, 0].astype(np.int64) << 16) | (v[:, 1].astype(np.int64) << 8) | v[:, 2]
    # winner per voxel: minimal d2, first-seen on ties (reference try_insert
    # uses strict <, filter_centervox.hh:34)
    order = np.lexsort((np.arange(len(key)), d2, key))
    _, first = np.unique(key[order], return_index=True)
    winners = order[np.sort(first)]
    # output in voxel first-occurrence order (extract_points walks the tables
    # in creation order, filter_centervox.hh:165-180)
    _, first_seen = np.unique(key, return_index=True)
    occ_keys_in_order = key[np.sort(first_seen)]
    by_key = {int(key[w]): w for w in winners}
    return np.stack([pts[by_key[int(k)]] for k in occ_keys_in_order])
