"""The pipeline's point sampling, worked out again in NumPy.

A scan is a mesh; the pipeline resamples it at 0.5 x 12,800 samples per
square metre (faces from an alias-method distribution over their areas,
seed 64321; barycentric weights from PCG32, seed 12346) and builds each
level of detail by a greedy Poisson-disk pass in point order (voxel
0.005-0.08 m). These are the upstream's documented settings
(rs_pointcloud.h), written here from their description: the random
streams vectorised by jumping the generator ahead, the greedy pass as
rounds over the pairs within the voxel. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.spatial import cKDTree

SAMPLES_PER_SQM = 0.5 * 12800.0
FACE_SEED, BARY_SEED = 64321, 12346
VOXELS = (0.005, 0.01, 0.02, 0.04, 0.08)

_MUL = np.uint64(0x5851F42D4C957F2D)
_M64 = (1 << 64) - 1


def _avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _M64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _M64
    return h ^ (h >> 33)


def _pcg_u32(seed: int, n: int) -> np.ndarray:
    """The first ``n`` outputs of msh_rand seeded with ``seed`` (PCG32 with
    Gustavsson seeding)."""
    value = _avalanche((seed << 1) | 1)
    inc = ((value << 1) | 1) & _M64
    mul = int(_MUL)
    state = inc                                   # one step from state 0
    state = (state + _avalanche(value)) & _M64
    state = (state * mul + inc) & _M64            # the second step
    # state k = a^k s0 + inc (1 + a + ... + a^(k-1)), all mod 2^64
    with np.errstate(over="ignore"):
        pw = np.empty(n, np.uint64)
        pw[0] = 1
        if n > 1:
            pw[1:] = np.multiply.accumulate(np.full(n - 1, _MUL, np.uint64))
        geo = np.zeros(n, np.uint64)
        if n > 1:
            geo[1:] = np.cumsum(pw[:-1], dtype=np.uint64)
        old = pw * np.uint64(state) + np.uint64(inc) * geo
    xs = (((old >> np.uint64(18)) ^ old) >> np.uint64(27)).astype(np.uint32)
    rot = (old >> np.uint64(59)).astype(np.uint32)
    return (xs >> rot) | (xs << ((np.uint32(32) - rot) & np.uint32(31)))


def _unit_f32(u: np.ndarray) -> np.ndarray:
    bits = (np.uint32(127 << 23) | (u >> np.uint32(9))).astype(np.uint32)
    return bits.view(np.float32) - np.float32(1.0)


def _alias(areas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = len(areas)
    total = float(np.float32(np.cumsum(areas)[-1]))
    pdf = list(areas * (1.0 / total)) if total > 1e-8 else [0.0] * n
    avg = 1.0 / n
    prob = [1.0] * n
    alias = [0] * n
    small, large = [], []
    for i in range(n):
        (large if pdf[i] >= avg else small).append(i)
    while small and large:
        lo, g = small.pop(), large.pop()
        prob[lo] = pdf[lo] * n
        alias[lo] = g
        pdf[g] = (pdf[g] + pdf[lo]) - avg
        (large if pdf[g] >= avg else small).append(g)
    return np.asarray(prob), np.asarray(alias, np.int64)


def _normalize_f32(v: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        s = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
        out = v * (np.float32(1.0) / np.sqrt(s, dtype=np.float32))[:, None]
    out[~np.isfinite(out).all(axis=1)] = 0.0
    return out.astype(np.float32)


def resample(mesh: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Level 0 of a mesh: positions, normals, class and instance ids."""
    pos, faces = mesh["positions"], mesh["faces"]
    v0, v1, v2 = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    c = np.cross(v1 - v0, v2 - v0).astype(np.float32)
    areas = np.sqrt((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2],
                    dtype=np.float32).astype(np.float64)
    n = int(SAMPLES_PER_SQM * float(areas.sum()))
    prob, alias = _alias(areas)
    nf = len(faces)
    fu = _unit_f32(_pcg_u32(FACE_SEED, 2 * n))
    col = (fu[0::2] * np.float32(nf)).astype(np.int32)
    face = np.where(fu[1::2].astype(np.float64) < prob[col], col, alias[col])
    bu = _unit_f32(_pcg_u32(BARY_SEED, 2 * n)).astype(np.float64)
    s, t = bu[0::2], bu[1::2]
    flip = s + t > 1.0
    s = np.where(flip, 1.0 - s, s)
    t = np.where(flip, 1.0 - t, t)
    w = np.stack([1.0 - s - t, s, t], 1).astype(np.float32)
    vi = faces[face]

    def lerp(a):
        return (a[vi[:, 0]] * w[:, 0:1] + a[vi[:, 1]] * w[:, 1:2]
                + a[vi[:, 2]] * w[:, 2:3]).astype(np.float32)

    picked = vi[np.arange(n), np.argmin(w, axis=1)]
    return {"positions": lerp(pos),
            "normals": _normalize_f32(lerp(mesh["normals"])),
            "class_ids": mesh["class_ids"][picked].astype(np.int32),
            "instance_ids": mesh["instance_ids"][picked].astype(np.int32)}


def poisson(points: np.ndarray, voxel: float) -> np.ndarray:
    """Indices of the greedy Poisson-disk subsample: in point order, a
    point is kept when no kept point lies closer than ``voxel`` (squared
    distances in float32, as the pipeline forms them)."""
    p = np.ascontiguousarray(points, np.float32)
    n = len(p)
    pairs = cKDTree(p.astype(np.float64)).query_pairs(
        voxel * 1.001, output_type="ndarray")
    v = p[pairs[:, 0]] - p[pairs[:, 1]]
    d2 = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    pairs = pairs[d2 < np.float32(voxel) * np.float32(voxel)]
    early, late = pairs.min(1), pairs.max(1)
    state = np.zeros(n, np.int8)             # 0 open, 1 kept, 2 dropped
    while True:
        live = state[late] == 0
        early, late = early[live], late[live]
        open_ = state == 0
        if not open_.any():
            break
        # a point with no earlier neighbour still open or kept is kept
        blocking = state[early] != 2
        blocked = np.bincount(late[blocking], minlength=n) > 0
        keep = open_ & ~blocked
        state[keep] = 1
        state[late[state[early] == 1]] = 2
    return np.flatnonzero(state == 1)


def level(cloud: Dict[str, np.ndarray], lvl: int) -> Dict[str, np.ndarray]:
    idx = poisson(cloud["positions"], VOXELS[lvl])
    return {k: v[idx] for k, v in cloud.items()}
