"""Voxel occupancy grids and pairwise overlap factors.

Re-implements lib/rs/intersect.h with vectorized numpy (these grids are
small — object bboxes at 0.1 m voxels — and feed the host-side greedy NMS,
so host numpy is the right home; the large scene-coverage grids used by the
arrangement energy live on device in ops/energy.py).

Semantics preserved exactly:
* grid over the union bbox fattened by 0.3 m, res = ceil(extent/voxel) + 1
  (isect_grid3d_init, intersect.h:58-75)
* transformed bbox from LEVEL 3 points (isect_get_transformed_aabbox, :111-122)
* boundary rasterization from LEVEL 1 points (:176-208)
* interior fill: per-y-slice scanline even-odd in +x and +z directions,
  a cell is INSIDE if both directional fills agree (:125-174, :210-276);
  the fill counter increments on BOUNDARY -> FREE transitions
* overlap factor = |A and B| / max(|A|, |B|) (or min) (:309-368)
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .. import config

FREE, BOUNDARY, INSIDE, OVERLAP = 0, 1, 2, 3


def transformed_bbox(points_lvl3: np.ndarray, pose: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    p = points_lvl3 @ pose[:3, :3].T + pose[:3, 3]
    return p.min(axis=0), p.max(axis=0)


def grid_shape(bmin: np.ndarray, bmax: np.ndarray, voxel: float):
    fat = config.ISECT_FAT_FACTOR
    bmin = np.asarray(bmin, np.float32) - fat
    bmax = np.asarray(bmax, np.float32) + fat
    res = (np.ceil((bmax - bmin) / np.float32(voxel)).astype(np.int64) + 1)
    return bmin, res


def rasterize_boundary(points_lvl1: np.ndarray, pose: np.ndarray,
                       origin: np.ndarray, res: np.ndarray, voxel: float,
                       pre_transformed: bool = False) -> np.ndarray:
    """Mark BOUNDARY cells; returns uint8 grid indexed [y, z, x]
    (reference layout: data[(y*x_res*z_res) + z*x_res + x], intersect.h:93).
    With ``pre_transformed`` the points are already in world space and
    ``pose`` is ignored."""
    if pre_transformed:
        p = points_lvl1
    else:
        p = points_lvl1 @ pose[:3, :3].T + pose[:3, 3]
    c = np.floor((p - origin) / np.float32(voxel)).astype(np.int64)
    c = np.clip(c, 0, res[None, :] - 1)  # reference asserts in-range
    grid = np.zeros((res[1], res[2], res[0]), dtype=np.uint8)
    grid[c[:, 1], c[:, 2], c[:, 0]] = BOUNDARY
    return grid


def _directional_fill(g: np.ndarray, axis: int) -> np.ndarray:
    """Even-odd scanline fill of all y-slices [y, z, x] along ``axis``
    (1 = z scan, 2 = x scan), vectorized over the whole grid.

    Fill counter increments at BOUNDARY -> FREE transitions; a cell is
    filled when the counter is odd, scanning both forward and backward;
    filled-both-ways non-boundary cells become INSIDE
    (isect__compute_occupancy_within_slice, intersect.h:125-174)."""
    def fill(arr):
        prev = np.zeros_like(arr)
        if axis == 2:
            prev[:, :, 1:] = arr[:, :, :-1]
        else:
            prev[:, 1:, :] = arr[:, :-1, :]
        trans = (arr == FREE) & (prev == BOUNDARY)
        cnt = np.cumsum(trans, axis=axis)
        return (cnt % 2) == 1

    fwd = fill(g)
    bwd = np.flip(fill(np.flip(g, axis=axis)), axis=axis)
    out = g.copy()
    inside = (g != BOUNDARY) & fwd & bwd
    out[inside] = INSIDE
    return out


def fill_occupancy(grid: np.ndarray) -> np.ndarray:
    """Interior fill of a boundary grid [y, z, x]: combine x-direction and
    z-direction scanline fills (intersect.h:243-262)."""
    fx = _directional_fill(grid, axis=2)   # scan along x
    fz = _directional_fill(grid, axis=1)   # scan along z
    out = np.full_like(grid, FREE)
    out[(fx == BOUNDARY) | (fz == BOUNDARY)] = BOUNDARY
    out[(fx == INSIDE) & (fz == INSIDE)] = INSIDE
    return out


def posed_points(pc, pose: np.ndarray):
    """Precompute (world lvl1 points, world bbox) for repeated
    overlap_factor calls against the same (cloud, pose)."""
    w = pc.pos(config.ISECT_RASTER_LVL) @ pose[:3, :3].T + pose[:3, 3]
    bb = transformed_bbox(pc.pos(config.ISECT_BBOX_LVL), pose)
    return w, bb


def overlap_factor(pc_a, pose_a: np.ndarray, pc_b, pose_b: np.ndarray,
                   voxel: float = config.NMS_OVERLAP_VOXEL,
                   voxelize_inside: bool = True,
                   normalize_by_smaller: bool = False,
                   cached_a=None, cached_b=None,
                   engine: str | None = None) -> float:
    """Voxel overlap of two posed clouds (isect_get_overlap_factor,
    intersect.h:309-368). ``pc_*`` are PointCloud objects. ``cached_*``
    optionally carry ``posed_points(pc, pose)`` results so repeated
    comparisons against the same posed cloud skip the transform."""
    if cached_a is None:
        cached_a = posed_points(pc_a, pose_a)
    if cached_b is None:
        cached_b = posed_points(pc_b, pose_b)
    (amin, amax) = cached_a[1]
    (bmin, bmax) = cached_b[1]
    if (amin > bmax).any() or (bmin > amax).any():
        return 0.0
    cmin = np.minimum(amin, bmin)
    cmax = np.maximum(amax, bmax)
    origin, res = grid_shape(cmin, cmax, voxel)

    if engine is None:
        engine = os.environ.get("RESCAN_ISECT_ENGINE", "native")
    if engine == "native":
        # host C++ kernel with identical semantics (NMS calls this in a
        # greedy loop on the 1-core host VM; engine agreement unit-tested)
        from ..core import native
        ca, cb, cnt = native.overlap_counts(cached_a[0], cached_b[0],
                                            origin, res, voxel,
                                            voxelize_inside)
    else:
        ga = rasterize_boundary(cached_a[0], pose_a, origin, res, voxel,
                                pre_transformed=True)
        gb = rasterize_boundary(cached_b[0], pose_b, origin, res, voxel,
                                pre_transformed=True)
        if voxelize_inside:
            ga = fill_occupancy(ga)
            gb = fill_occupancy(gb)
            ca = int((ga > FREE).sum())
            cb = int((gb > FREE).sum())
        else:
            ca = int((ga == BOUNDARY).sum())
            cb = int((gb == BOUNDARY).sum())

        both = (ga > FREE) & (gb > FREE)
        cnt = int(both.sum())
    denom = min(ca, cb) if normalize_by_smaller else max(ca, cb)
    if denom <= 0:
        return 1.0
    return cnt / denom
