"""Arrangement optimization: the 4-term scene-alignment energy, greedy
construction, and simulated annealing.

Mirrors apps/segment_transfer/arrangement_optimization.cpp. The TPU-native
restructuring: every candidate placement's voxel coverage footprint is
precomputed ONCE as a unique-cell array (the reference re-rasterizes the
whole arrangement into a dense grid for every single energy evaluation,
:344-373 + :1082-1106); coverage is then maintained incrementally with
per-cell counts, making each greedy round one vectorized pass over all
proposals and each SA step O(changed cells).

Energy terms (weights normalized by their sum, :376-402):
  scncov — fraction of salient scene voxels covered by the arrangement
           (:344-373)
  geom   — mean placement score (:312-342)
  isect  — 1 - max pairwise Mahalanobis-at-midpoint penalty, scale 0.39
           (:238-310; the error_count branch is compiled out so the mean
           path never runs)
  hyster — temporal persistence vs the last n_past_steps arrangements with
           volume-dependent sigma, decayed by recency, +0.4/+0.375
           existed/novel bonus, -0.25 class mismatch, -5 per duplicate
           uidx, clamped >= 0 (:84-236)

SA (:789-935): 25k iterations, actions add/remove/replace/swap/move with
likelihoods {.01,.01,.01,1,.5}, temperature 0.01 -> 1e-4 linear, random
restart p=0.01, acceptance exp(-(prev-cur)/T), PCG seed 12346 (exact msh
PRNG replica). uidx linearization after every step (:434-465).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import config
from ..core import native
from ..io.rsdb import Placement, Rsdb
from ..utils import rng as mshrng


_EMPTY_CELLS = np.zeros(0, np.int64)

# ---------------------------------------------------------------------------
# Coverage grid context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EnergyContext:
    """Precomputed scene/proposal data shared by greedy and SA."""
    origin: np.ndarray            # fattened scene-bbox min (0.05 grid)
    res: np.ndarray               # (3,) int cells
    voxel: float
    scn_valid: np.ndarray         # bool (n_cells,) salient scene cells
    n_scn_valid: int
    # cells[obj_idx][pose_idx] -> unique int32 cell ids of the proposal
    proposal_cells: List[List[np.ndarray]]
    # per (obj, pose): world centroid + inverse of rotated covariance
    proposal_centroid: List[np.ndarray]     # per obj: (K, 3)
    proposal_sigma_inv: List[np.ndarray]    # per obj: (K, 3, 3)
    obj_volume: np.ndarray        # (n_objects,) bbox volume of each object
    obj_class: np.ndarray         # (n_objects,)
    obj_static: np.ndarray        # (n_objects,) bool
    obj_cells_cache: Dict[Tuple[int, int], np.ndarray] = dataclasses.field(
        default_factory=dict)
    gauss_cache: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    # scratch for O(changed cells) coverage evaluation
    _stamp: Optional[np.ndarray] = None
    _gen: int = 0

    def world_to_cells(self, pts: np.ndarray, pose: np.ndarray) -> np.ndarray:
        """Unique in-range cell ids of posed points (world_to_cell arithmetic
        of isect_grid3d_cell_from_world_space, intersect.h:96-109)."""
        p = pts @ pose[:3, :3].T + pose[:3, 3]
        c = np.floor((p - self.origin) * np.float32(1.0 / self.voxel)).astype(np.int64)
        ok = ((c >= 0) & (c < self.res[None, :])).all(axis=1)
        c = c[ok]
        flat = (c[:, 1] * self.res[2] + c[:, 2]) * self.res[0] + c[:, 0]
        return np.unique(flat).astype(np.int64)


def build_context(db: Rsdb, scene_idx: int,
                  poses: List[Optional[np.ndarray]],
                  scores: List[Optional[np.ndarray]]) -> EnergyContext:
    scene = db.scenes[scene_idx].cloud
    bmin, bmax = scene.bbox
    fat = config.ISECT_FAT_FACTOR
    origin = (bmin - fat).astype(np.float32)
    res = (np.ceil(((bmax + fat) - origin) /
                   np.float32(config.ENERGY_GRID_VOXEL)).astype(np.int64) + 1)
    n_cells = int(res.prod())

    ctx = EnergyContext(
        origin=origin, res=res, voxel=config.ENERGY_GRID_VOXEL,
        scn_valid=np.zeros(n_cells, bool), n_scn_valid=0,
        proposal_cells=[], proposal_centroid=[], proposal_sigma_inv=[],
        obj_volume=np.zeros(len(db.objects), np.float64),
        obj_class=np.array([o.class_idx for o in db.objects], np.int64),
        obj_static=np.array([db.is_object_static(i)
                             for i in range(len(db.objects))], bool))

    # scene occupancy from level-2 salient points (rsao_rasterize_scene_to_grid,
    # arrangement_optimization.cpp:1064-1079)
    lvl = config.SCENE_RASTERIZE_LVL
    q = scene.levels[lvl]["qualities"]
    cells = ctx.world_to_cells(scene.pos(lvl)[q >= config.SCENE_RASTERIZE_QUALITY_THRESHOLD],
                               np.eye(4, dtype=np.float32))
    ctx.scn_valid[cells] = True
    ctx.n_scn_valid = int(ctx.scn_valid.sum())

    for i, obj in enumerate(db.objects):
        bminO = obj.cloud.pos(0).min(axis=0)
        bmaxO = obj.cloud.pos(0).max(axis=0)
        ctx.obj_volume[i] = float(np.prod(bmaxO - bminO))
        k = 0 if poses[i] is None else len(poses[i])
        cell_list, cents, sig_invs = [], [], []
        if k and not ctx.obj_static[i]:
            pts2 = obj.cloud.pos(config.ARRANGEMENT_RASTERIZE_LVL)
            c0 = obj.cloud.centroid(0)
            cov = obj.cloud.covariance(0).astype(np.float64)
            for p in range(k):
                T = np.asarray(poses[i][p], np.float32)
                key = (i, T.tobytes())
                cells = ctx.world_to_cells(pts2, T)
                cell_list.append(cells)
                ctx.obj_cells_cache[key] = cells
                R = T[:3, :3].astype(np.float64)
                cent = R @ c0 + T[:3, 3]
                sig_inv = np.linalg.pinv(R @ cov @ R.T)
                cents.append(cent)
                sig_invs.append(sig_inv)
                ctx.gauss_cache[key] = (cent, sig_inv)
        ctx.proposal_cells.append(cell_list)
        ctx.proposal_centroid.append(np.asarray(cents).reshape(-1, 3))
        ctx.proposal_sigma_inv.append(np.asarray(sig_invs).reshape(-1, 3, 3))
    ctx._stamp = np.zeros(n_cells, np.int64)
    return ctx


def placement_cells(ctx: EnergyContext, db: Rsdb, p: Placement) -> np.ndarray:
    """Covered cells of a placement; proposals hit the precomputed table,
    anything else (e.g. carried-over poses) is rasterized once and cached."""
    i = p.object_idx
    key = (i, np.asarray(p.pose, np.float32).tobytes())
    cached = ctx.obj_cells_cache.get(key)
    if cached is not None:
        return cached
    cells = ctx.world_to_cells(
        db.objects[i].cloud.pos(config.ARRANGEMENT_RASTERIZE_LVL), p.pose)
    ctx.obj_cells_cache[key] = cells
    return cells


def placement_gaussian(ctx: EnergyContext, db: Rsdb, p: Placement):
    """(world centroid, inverse rotated covariance) of a placement, cached."""
    key = (p.object_idx, p.pose.tobytes())
    g = ctx.gauss_cache.get(key)
    if g is None:
        obj = db.objects[p.object_idx].cloud
        R = p.pose[:3, :3].astype(np.float64)
        cent = R @ obj.centroid(0) + p.pose[:3, 3]
        sig = R @ obj.covariance(0).astype(np.float64) @ R.T
        g = (cent, np.linalg.pinv(sig))
        ctx.gauss_cache[key] = g
    return g


# ---------------------------------------------------------------------------
# Energy terms
# ---------------------------------------------------------------------------

def coverage_score(ctx: EnergyContext, db: Rsdb,
                   arrangement: Sequence[Placement]) -> float:
    """rsao__compute_scene_coverage_score (:344-373): fraction of salient
    scene cells covered by dynamic placements."""
    if ctx.n_scn_valid == 0:
        return 0.0
    # generation-stamp scratch: O(sum of placement cells) per evaluation
    ctx._gen += 1
    gen = ctx._gen
    agree = 0
    for p in arrangement:
        if ctx.obj_static[p.object_idx]:
            continue
        cells = placement_cells(ctx, db, p)
        fresh = cells[ctx._stamp[cells] != gen]
        ctx._stamp[fresh] = gen
        agree += int(ctx.scn_valid[fresh].sum())
    return agree / ctx.n_scn_valid


def geometry_score(arrangement: Sequence[Placement]) -> float:
    """rsao__compute_geometry_score (:312-342): mean placement score."""
    if not arrangement:
        return 0.0
    return float(np.mean([p.score for p in arrangement]))


def _mahalanobis_val(p, mu, sig_inv, scale=config.ISECT_MAHALANOBIS_SCALE):
    d = p - mu
    m = np.sqrt(max(float(d @ sig_inv @ d), 0.0))
    return np.exp(-(1.0 / (2 * scale * scale)) * m)


def intersection_score(ctx: EnergyContext, db: Rsdb,
                       arrangement: Sequence[Placement]) -> float:
    """rsao__compute_intersection_score (:238-310): 1 - max over placements
    of the max pairwise midpoint Mahalanobis penalty."""
    n = len(arrangement)
    if n == 0:
        return 1.0
    cents, sig_invs = [], []
    for p in arrangement:
        cent, sig_inv = placement_gaussian(ctx, db, p)
        cents.append(cent)
        sig_invs.append(sig_inv)
    error = 0.0
    for a in range(n):
        cur = 0.0
        for b in range(n):
            if a == b:
                continue
            mid = 0.5 * (cents[a] + cents[b])
            ea = _mahalanobis_val(mid, cents[a], sig_invs[a])
            eb = _mahalanobis_val(mid, cents[b], sig_invs[b])
            cur = max(cur, 0.5 * (ea + eb))
        error = max(error, cur)
    return 1.0 - error


def hysteresis_score(db: Rsdb, arrangement: Sequence[Placement],
                     n_past_steps: int) -> float:
    """rsao__compute_hysteresis_score (:116-236)."""
    n = len(arrangement)
    if n == 0:
        return 0.0
    n_arr = len(db.arrangements)
    scores = np.zeros(n)
    existed = np.zeros(n, bool)
    mismatched = np.zeros(n, bool)
    for past_idx in range(1, n_past_steps + 1):
        ai = n_arr - (past_idx + 1)
        if ai < 0:
            continue
        past = db.arrangements[ai]
        decay = config.HYSTER_DECAY_A * past_idx + config.HYSTER_DECAY_B
        for ci, cur in enumerate(arrangement):
            cur_cls = db.objects[cur.object_idx].class_idx
            vol = _bbox_volume(db.objects[cur.object_idx].cloud)
            sigma = max(config.HYSTER_SIGMA_A * np.exp(-config.HYSTER_SIGMA_B * vol)
                        + config.HYSTER_SIGMA_C, config.HYSTER_SIGMA_MIN)
            for po in past:
                po_cls = db.objects[po.object_idx].class_idx
                if po.uidx == cur.uidx and cur_cls == po_cls:
                    existed[ci] = True
                    d2 = float(np.sum((cur.pose[:3, 3] - po.pose[:3, 3]) ** 2))
                    s = np.exp(-d2 / (2 * sigma * sigma)) * config.HYSTER_BASE_SCALE
                    s *= decay
                    if s > scores[ci]:
                        scores[ci] = s
                if po.uidx == cur.uidx and cur_cls != po_cls:
                    mismatched[ci] = True
    scores[mismatched] = config.HYSTER_MISMATCH_PENALTY
    scores = scores + np.where(existed, config.HYSTER_EXISTED_BONUS,
                               config.HYSTER_NOVEL_BONUS)
    scores = np.minimum(scores, 1.0)
    uids = [p.uidx for p in arrangement]
    n_dup = sum(1 for i in range(n - 1) for j in range(i + 1, n)
                if uids[i] == uids[j])
    total = scores.sum() / n - n_dup * config.HYSTER_DUPLICATE_PENALTY
    return max(float(total), 0.0)


def _bbox_volume(cloud) -> float:
    bmin, bmax = cloud.bbox
    return float(np.prod(bmax - bmin))


def scene_alignment_score(ctx: EnergyContext, db: Rsdb,
                          arrangement: Sequence[Placement],
                          weights: Sequence[float],
                          n_past_steps: int) -> float:
    """rsao_compute_scene_alignment_score (:376-402)."""
    w_cov, w_geom, w_isect, w_hyst = weights
    s = 0.0
    if w_geom > 0:
        s += w_geom * geometry_score(arrangement)
    if w_isect > 0:
        s += w_isect * intersection_score(ctx, db, arrangement)
    if w_hyst > 0:
        s += w_hyst * hysteresis_score(db, arrangement, n_past_steps)
    if w_cov > 0:
        s += w_cov * coverage_score(ctx, db, arrangement)
    return s / sum(weights)


# ---------------------------------------------------------------------------
# Incrementally maintained energy (the fast path used by greedy and SA)
# ---------------------------------------------------------------------------

class FastEnergy:
    """Incrementally maintained 4-term scene-alignment energy.

    The reference recomputes the FULL energy for every candidate/step
    (rsao_compute_scene_alignment_score at arrangement_optimization.cpp:866,
    :1012), re-rasterizing the whole arrangement each call. Here each term
    carries state updated in O(changed placement):

    * coverage — per-cell cover counts over the salient scene cells plus a
      covered-cell counter (a placement's salient-cell footprint is
      precomputed once in the EnergyContext),
    * intersection — the symmetric pairwise midpoint-Mahalanobis penalty
      matrix; add/remove touches one row/column,
    * geometry — the placements' scores, summed on demand (n is small),
    * hysteresis — per-placement persistence values cached by
      (uidx, object, translation); past-arrangement arrays are cached and
      invalidated when ``_linearize_ids`` mutates one.

    ``score()`` equals ``scene_alignment_score`` on the same arrangement
    (same formulas, same float32/float64 promotion points); equality is
    asserted by tests/test_energy_fast.py.
    """

    _CAP0 = 64

    def __init__(self, ctx: EnergyContext, db: Rsdb, scene_idx: int,
                 weights: Sequence[float], n_past_steps: int,
                 arrangement: Sequence[Placement] = ()):
        self.ctx, self.db, self.scene_idx = ctx, db, scene_idx
        self.weights = tuple(weights)
        self.wsum = sum(weights)
        self.n_past = n_past_steps
        self.items: List[Placement] = []
        # coverage state
        self._cnt = np.zeros(len(ctx.scn_valid), np.int32)
        self._n_cov = 0
        self._sal_cache: Dict[Tuple[int, int], np.ndarray] = {}
        # intersection state (capacity-backed)
        cap = self._CAP0
        self._cents = np.zeros((cap, 3), np.float64)
        self._sig_invs = np.zeros((cap, 3, 3), np.float64)
        self._pen = np.zeros((cap, cap), np.float64)
        # hysteresis caches
        self._obj_sigma = np.array(
            [max(config.HYSTER_SIGMA_A
                 * np.exp(-config.HYSTER_SIGMA_B * _bbox_volume(o.cloud))
                 + config.HYSTER_SIGMA_C, config.HYSTER_SIGMA_MIN)
             for o in db.objects], np.float64)
        self._past_arrays: Dict[int, Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]] = {}
        self._f_cache: Dict[Tuple[int, int, bytes], Tuple[float, bool,
                                                          bool]] = {}
        self._f: List[Tuple[float, bool, bool]] = []  # per item
        for p in arrangement:
            self.add(p)

    # -- hysteresis helpers --------------------------------------------------

    def invalidate_past(self) -> None:
        """Call after db.arrangements mutates (e.g. _linearize_ids)."""
        self._past_arrays.clear()
        self._f_cache.clear()
        self._f = [self._placement_f(p) for p in self.items]

    def _past(self, ai: int):
        arrs = self._past_arrays.get(ai)
        if arrs is None:
            past = self.db.arrangements[ai]
            arrs = (np.array([p.uidx for p in past], np.int64),
                    np.array([self.db.objects[p.object_idx].class_idx
                              for p in past], np.int64),
                    np.array([p.pose[:3, 3] for p in past],
                             np.float32).reshape(-1, 3))
            self._past_arrays[ai] = arrs
        return arrs

    def _placement_f(self, p: Placement) -> Tuple[float, bool, bool]:
        """(max persistence score, existed, mismatched) of one placement vs
        the past window — the per-placement body of rsao__compute_
        hysteresis_score (:116-236), which is independent across
        placements."""
        key = (p.uidx, p.object_idx, p.pose[:3, 3].tobytes())
        hit = self._f_cache.get(key)
        if hit is not None:
            return hit
        db = self.db
        cls = db.objects[p.object_idx].class_idx
        sigma = self._obj_sigma[p.object_idx]
        pos = np.asarray(p.pose[:3, 3], np.float32)
        n_arr = len(db.arrangements)
        best, existed, mismatched = 0.0, False, False
        for past_idx in range(1, self.n_past + 1):
            ai = n_arr - (past_idx + 1)
            if ai < 0:
                continue
            pu, pc, pp = self._past(ai)
            if len(pu) == 0:
                continue
            same_u = pu == p.uidx
            match = same_u & (pc == cls)
            if (same_u & (pc != cls)).any():
                mismatched = True
            if match.any():
                existed = True
                decay = config.HYSTER_DECAY_A * past_idx + config.HYSTER_DECAY_B
                d2 = ((pos[None, :] - pp[match]) ** 2).sum(axis=1)
                # math.exp (libm), NOT np.exp: numpy's vectorized exp can
                # differ from libm by 1 ulp, which the SA accept
                # probability amplifies into the 9th digit — the native
                # engine (std::exp) must stay trace-exact with this loop
                m = max(math.exp(-float(v) / (2 * sigma * sigma))
                        * config.HYSTER_BASE_SCALE * decay
                        for v in d2.astype(np.float64))
                if m > best:
                    best = m
        out = (best, existed, mismatched)
        self._f_cache[key] = out
        return out

    def _hysteresis(self) -> float:
        n = len(self.items)
        if n == 0:
            return 0.0
        # plain Python: n is a handful; numpy array construction would
        # dominate (this runs once per SA iteration)
        total = 0.0
        seen: Dict[int, int] = {}
        n_dup = 0
        for p, (s, existed, mismatched) in zip(self.items, self._f):
            v = config.HYSTER_MISMATCH_PENALTY if mismatched else s
            v += (config.HYSTER_EXISTED_BONUS if existed
                  else config.HYSTER_NOVEL_BONUS)
            total += min(v, 1.0)
            c = seen.get(p.uidx, 0)
            n_dup += c
            seen[p.uidx] = c + 1
        out = total / n - n_dup * config.HYSTER_DUPLICATE_PENALTY
        return max(out, 0.0)

    # -- coverage helpers ----------------------------------------------------

    def _sal_cells(self, p: Placement) -> np.ndarray:
        """The placement's covered SALIENT cells (static placements are
        skipped by the coverage term, :352-356)."""
        if self.ctx.obj_static[p.object_idx]:
            return np.zeros(0, np.int64)
        key = (p.object_idx, p.pose.tobytes())
        cached = self._sal_cache.get(key)
        if cached is None:
            cells = placement_cells(self.ctx, self.db, p)
            cached = cells[self.ctx.scn_valid[cells]]
            self._sal_cache[key] = cached
        return cached

    # -- intersection helpers ------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = len(self._cents)
        while cap < need:
            cap *= 2
        if cap != len(self._cents):
            c = np.zeros((cap, 3), np.float64)
            s = np.zeros((cap, 3, 3), np.float64)
            m = np.zeros((cap, cap), np.float64)
            n = len(self.items)
            c[:n] = self._cents[:n]
            s[:n] = self._sig_invs[:n]
            m[:n, :n] = self._pen[:n, :n]
            self._cents, self._sig_invs, self._pen = c, s, m

    @staticmethod
    def _pair_penalties(cent: np.ndarray, sig_inv: np.ndarray,
                        cents: np.ndarray, sig_invs: np.ndarray
                        ) -> np.ndarray:
        """0.5*(ea+eb) of one placement vs a batch (:248-310). The 3x3
        quadratic forms are hand-expanded (d S d = S00 d0^2 + ... +
        2 S01 d0 d1 + ...). numpy ORACLE for native.pair_penalties, which
        the mutators call (at arrangement sizes numpy dispatch overhead
        was the SA wall-clock); agreement is unit-tested."""
        if len(cents) == 0:
            return np.zeros(0, np.float64)
        # mid - cent == cents - mid == 0.5 * (cents - cent): one delta
        # serves both quadratic forms
        d = 0.5 * (cents - cent[None, :])
        d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
        q_a = (sig_inv[0, 0] * d0 * d0 + sig_inv[1, 1] * d1 * d1
               + sig_inv[2, 2] * d2 * d2
               + 2.0 * (sig_inv[0, 1] * d0 * d1 + sig_inv[0, 2] * d0 * d2
                        + sig_inv[1, 2] * d1 * d2))
        q_b = (sig_invs[:, 0, 0] * d0 * d0 + sig_invs[:, 1, 1] * d1 * d1
               + sig_invs[:, 2, 2] * d2 * d2
               + 2.0 * (sig_invs[:, 0, 1] * d0 * d1
                        + sig_invs[:, 0, 2] * d0 * d2
                        + sig_invs[:, 1, 2] * d1 * d2))
        sc = config.ISECT_MAHALANOBIS_SCALE
        k = -(1.0 / (2 * sc * sc))
        ea = np.exp(k * np.sqrt(np.maximum(q_a, 0.0)))
        eb = np.exp(k * np.sqrt(np.maximum(q_b, 0.0)))
        return 0.5 * (ea + eb)

    # -- mutators --------------------------------------------------------

    def add(self, p: Placement) -> None:
        n = len(self.items)
        self._grow(n + 1)
        cells = self._sal_cells(p)
        if len(cells):
            self._n_cov += native.cov_update(self._cnt, _EMPTY_CELLS, cells)
        cent, sig_inv = placement_gaussian(self.ctx, self.db, p)
        self._cents[n] = cent
        self._sig_invs[n] = sig_inv
        pen = native.pair_penalties(cent, sig_inv, self._cents[:n],
                                    self._sig_invs[:n],
                                    config.ISECT_MAHALANOBIS_SCALE)
        self._pen[n, :n] = pen
        self._pen[:n, n] = pen
        self._f.append(self._placement_f(p))
        self.items.append(p)

    def remove_swap(self, idx: int) -> Placement:
        """Swap-remove: items[idx] <- items[-1], pop (the reference's
        msh_array remove, :713-716)."""
        n = len(self.items)
        removed = self.items[idx]
        cells = self._sal_cells(removed)
        if len(cells):
            self._n_cov += native.cov_update(self._cnt, cells, _EMPTY_CELLS)
        last = n - 1
        if idx != last:
            self.items[idx] = self.items[last]
            self._f[idx] = self._f[last]
            self._cents[idx] = self._cents[last]
            self._sig_invs[idx] = self._sig_invs[last]
            self._pen[idx, :n] = self._pen[last, :n]
            self._pen[:n, idx] = self._pen[:n, last]
            self._pen[idx, idx] = 0.0
        self.items.pop()
        self._f.pop()
        self._pen[last, :n] = 0.0
        self._pen[:n, last] = 0.0
        return removed

    def set(self, idx: int, p: Placement) -> None:
        """Replace items[idx] in place (move/replace/swap actions)."""
        old = self.items[idx]
        old_cells = self._sal_cells(old)
        cells = self._sal_cells(p)
        if len(old_cells) or len(cells):
            self._n_cov += native.cov_update(self._cnt, old_cells, cells)
        cent, sig_inv = placement_gaussian(self.ctx, self.db, p)
        self._cents[idx] = cent
        self._sig_invs[idx] = sig_inv
        n = len(self.items)
        pen = native.pair_penalties(cent, sig_inv, self._cents[:n],
                                    self._sig_invs[:n],
                                    config.ISECT_MAHALANOBIS_SCALE)
        pen[idx] = 0.0
        self._pen[idx, :n] = pen
        self._pen[:n, idx] = pen
        self._f[idx] = self._placement_f(p)
        self.items[idx] = p

    def rebuild(self, arrangement: Sequence[Placement]) -> None:
        """Reset to a fresh arrangement (SA random restart)."""
        while self.items:
            self.remove_swap(len(self.items) - 1)
        for p in arrangement:
            self.add(p)

    # -- energy ----------------------------------------------------------

    def coverage(self) -> float:
        if self.ctx.n_scn_valid == 0:
            return 0.0
        return self._n_cov / self.ctx.n_scn_valid

    def intersection(self) -> float:
        n = len(self.items)
        if n == 0:
            return 1.0
        return 1.0 - float(self._pen[:n, :n].max()) if n > 1 else 1.0

    def geometry(self) -> float:
        if not self.items:
            return 0.0
        return sum(p.score for p in self.items) / len(self.items)

    def score(self) -> float:
        """scene_alignment_score of the current items (:376-402), from the
        incremental state; identical term order and weight gating."""
        w_cov, w_geom, w_isect, w_hyst = self.weights
        s = 0.0
        if w_geom > 0:
            s += w_geom * self.geometry()
        if w_isect > 0:
            s += w_isect * self.intersection()
        if w_hyst > 0:
            s += w_hyst * self._hysteresis()
        if w_cov > 0:
            s += w_cov * self.coverage()
        return s / self.wsum

    # -- batched candidate scoring (greedy) --------------------------------

    def score_with_each(self, proposals: Sequence[Placement]) -> np.ndarray:
        """score() of (items + [p]) for EVERY proposal p, in one vectorized
        pass — the greedy inner loop (:1012-1020) without per-candidate
        energy recomputation."""
        P = len(proposals)
        n = len(self.items)
        w_cov, w_geom, w_isect, w_hyst = self.weights
        out = np.zeros(P, np.float64)

        if w_geom > 0:
            base_sum = float(np.sum([p.score for p in self.items])) if n \
                else 0.0
            geo = (base_sum + np.array([p.score for p in proposals],
                                       np.float64)) / (n + 1)
            out += w_geom * geo

        if w_isect > 0:
            base_max = float(self._pen[:n, :n].max()) if n > 1 else 0.0
            pen_new = np.zeros(P, np.float64)
            if n:
                for j, p in enumerate(proposals):
                    cent, sig_inv = placement_gaussian(self.ctx, self.db, p)
                    pr = native.pair_penalties(
                        cent, sig_inv, self._cents[:n], self._sig_invs[:n],
                        config.ISECT_MAHALANOBIS_SCALE)
                    pen_new[j] = pr.max()
            out += w_isect * (1.0 - np.maximum(base_max, pen_new))

        if w_hyst > 0:
            uids = np.array([p.uidx for p in self.items])
            _, cnts = np.unique(uids, return_counts=True) if n else \
                (None, np.zeros(0, np.int64))
            base_dup = int((cnts * (cnts - 1) // 2).sum())
            base_f = 0.0
            for f in self._f:
                s_, ex, mm = f
                v = config.HYSTER_MISMATCH_PENALTY if mm else s_
                v += (config.HYSTER_EXISTED_BONUS if ex
                      else config.HYSTER_NOVEL_BONUS)
                base_f += min(v, 1.0)
            fp = np.zeros(P, np.float64)
            dup_add = np.zeros(P, np.int64)
            for j, p in enumerate(proposals):
                s_, ex, mm = self._placement_f(p)
                v = config.HYSTER_MISMATCH_PENALTY if mm else s_
                v += (config.HYSTER_EXISTED_BONUS if ex
                      else config.HYSTER_NOVEL_BONUS)
                fp[j] = min(v, 1.0)
                if n:
                    dup_add[j] = int((uids == p.uidx).sum())
            tot = ((base_f + fp) / (n + 1)
                   - (base_dup + dup_add) * config.HYSTER_DUPLICATE_PENALTY)
            out += w_hyst * np.maximum(tot, 0.0)

        if w_cov > 0 and self.ctx.n_scn_valid > 0:
            delta = np.zeros(P, np.int64)
            for j, p in enumerate(proposals):
                cells = self._sal_cells(p)
                if len(cells):
                    delta[j] = int((self._cnt[cells] == 0).sum())
            out += w_cov * (self._n_cov + delta) / self.ctx.n_scn_valid

        return out / self.wsum


# ---------------------------------------------------------------------------
# Greedy construction (rsao_greedy_step, :937-1035)
# ---------------------------------------------------------------------------

def _collect_proposals(ctx: EnergyContext, db: Rsdb,
                       scene_idx: int) -> List[Placement]:
    poses = db.proposed_poses[scene_idx]
    scores = db.proposed_scores[scene_idx]
    arrangement = db.arrangements[scene_idx]
    max_uidx = db.max_dynamic_uidx()
    used = {p.uidx for p in arrangement}
    proposals: List[Placement] = []
    for obj_idx in range(len(poses)):
        if ctx.obj_static[obj_idx] or poses[obj_idx] is None:
            continue
        uidx = db.objects[obj_idx].uidx
        # duplicate-uidx remap (greedy :996-1006)
        if uidx in used:
            uidx = max_uidx + 1
        for k in range(len(poses[obj_idx])):
            proposals.append(Placement(
                uidx=uidx, arrangement_idx=scene_idx, object_idx=obj_idx,
                pose_idx=k, pose=poses[obj_idx][k],
                score=float(scores[obj_idx][k])))
    return proposals


def greedy_step(ctx: EnergyContext, db: Rsdb, scene_idx: int,
                opts: config.ArrangementOpts,
                state: "FastEnergy | None" = None) -> float:
    """One greedy round: score every proposal appended to the arrangement
    (one batched pass), add the best improving one. When ``state`` is given
    it carries the incremental energy across rounds (greedy_optimize's
    path); otherwise a fresh one is built."""
    arrangement = db.arrangements[scene_idx]
    weights = opts.energy_weights_greedy
    if state is None:
        state = FastEnergy(ctx, db, scene_idx, weights, opts.n_past_steps,
                           arrangement)
    proposals = _collect_proposals(ctx, db, scene_idx)
    if not proposals:
        return state.score()

    cand_scores = state.score_with_each(proposals)
    # replicate the reference's sequential "improves by > 1e-6" selection
    # (ties keep the earliest strictly-improving candidate)
    best_score, best_idx = 0.0, -1
    for i in range(len(proposals)):
        if cand_scores[i] - best_score > 1e-6:
            best_score, best_idx = float(cand_scores[i]), i
    state.add(proposals[best_idx])
    arrangement.append(proposals[best_idx])
    return state.score()


def greedy_optimize(ctx: EnergyContext, db: Rsdb, scene_idx: int,
                    opts: config.ArrangementOpts, trace_fp=None) -> None:
    """The greedy driver loop (apps/segment_transfer/main.cpp:344-364):
    keep adding the single best proposal until the score stops improving
    (pop the last placement if it made things worse). ``trace_fp``:
    optional file — arrangement-oracle-format GREEDY_* lines for parity
    comparison (tools/run_arrangement_parity.py)."""
    weights = opts.energy_weights_greedy
    state = FastEnergy(ctx, db, scene_idx, weights, opts.n_past_steps,
                       db.arrangements[scene_idx])
    score = state.score()
    if trace_fp is not None:
        trace_fp.write(f"GREEDY_INIT {score:.9g}\n")
    k = 0
    while True:
        prev = score
        score = greedy_step(ctx, db, scene_idx, opts, state=state)
        if trace_fp is not None:
            arr = db.arrangements[scene_idx]
            last = arr[-1] if arr else None
            trace_fp.write(
                f"GREEDY_STEP {k} {score:.9g} "
                f"{last.uidx if last else -1} "
                f"{last.object_idx if last else -1} "
                f"{last.pose_idx if last else -1} "
                f"{last.score if last else 0.0:.9g}\n")
        k += 1
        if prev - score > 1e-6:
            db.arrangements[scene_idx].pop()
            if trace_fp is not None:
                trace_fp.write("GREEDY_POP\n")
            break
        if abs(prev - score) < 1e-6:
            break
    if trace_fp is not None:
        trace_fp.write(f"GREEDY_DONE {len(db.arrangements[scene_idx])}\n")


# ---------------------------------------------------------------------------
# Simulated annealing (rsao_simulated_annealing, :789-935)
# ---------------------------------------------------------------------------

def _find_max_uidx(db: Rsdb, obj_static=None) -> Tuple[int, int, int]:
    max_uidx, si, pi = 0, -1, -1
    static = (db.is_object_static if obj_static is None
              else lambda i: obj_static[i])
    for s, arr in enumerate(db.arrangements):
        for j, p in enumerate(arr):
            if p.uidx > max_uidx and not static(p.object_idx):
                max_uidx, si, pi = p.uidx, s, j
    return max_uidx, si, pi


def _linearize_ids(db: Rsdb, obj_static=None) -> bool:
    """rsao__linearize_ids (:434-465): keep the global max dynamic uidx at
    most 1 above the second largest. Returns True when an arrangement was
    mutated (FastEnergy's past-arrangement caches must refresh)."""
    max_uidx, si, pi = _find_max_uidx(db, obj_static)
    second = 0
    static = (db.is_object_static if obj_static is None
              else lambda i: obj_static[i])
    for arr in db.arrangements:
        for p in arr:
            if second < p.uidx < max_uidx and not static(p.object_idx):
                second = p.uidx
    if max_uidx - second > 1 and si >= 0:
        db.arrangements[si][pi].uidx = second + 1
        return True
    return False


def _obj_sigma_of(db: Rsdb) -> np.ndarray:
    return np.array(
        [max(config.HYSTER_SIGMA_A
             * np.exp(-config.HYSTER_SIGMA_B * _bbox_volume(o.cloud))
             + config.HYSTER_SIGMA_C, config.HYSTER_SIGMA_MIN)
         for o in db.objects], np.float64)


def _marshal_sa(ctx: EnergyContext, db: Rsdb, scene_idx: int,
                opts: config.ArrangementOpts):
    """Precompute every geometric quantity the native SA loop consumes
    (native/rescan_host.cpp::rescan_sa_run): per-proposal salient-cell CSR,
    gaussians, translations, ADD pdfs, initial-item 'extra' tables, and the
    (mutable) past-arrangement windows."""
    poses = db.proposed_poses[scene_idx]
    pscores = db.proposed_scores[scene_idx]
    n_obj = len(db.objects)
    n_arr = len(db.arrangements)

    lik = np.array([0.0 if ctx.obj_static[i] else 1.0 for i in range(n_obj)])
    prop_off = [0]
    trans_l, score_l, add_pdf_l, cent_l, sig_l = [], [], [], [], []
    cells_l, cells_off = [], [0]
    for i in range(n_obj):
        k = 0 if poses[i] is None else len(poses[i])
        if k:
            ps = np.asarray(poses[i], np.float32)
            trans_l.append(np.ascontiguousarray(ps[:, :3, 3]))
            sc = np.asarray(pscores[i], np.float64)
            score_l.append(sc)
            mx, mn = max(sc.max(), 0.0), min(sc.min(), 1.0)
            rangev = mx - mn
            norm = (sc - mn) / rangev if rangev > 0 else np.zeros_like(sc)
            add_pdf_l.append(mshrng.distrib2pdf(norm))
            if not ctx.obj_static[i] and len(ctx.proposal_centroid[i]):
                cent_l.append(ctx.proposal_centroid[i])
                sig_l.append(ctx.proposal_sigma_inv[i])
                for c in ctx.proposal_cells[i]:
                    sal = c[ctx.scn_valid[c]]
                    cells_l.append(sal)
                    cells_off.append(cells_off[-1] + len(sal))
            else:
                # static object that still has proposals (the prob==0.0
                # ADD edge case can select it): same gaussians, no cells
                cents, sigs = [], []
                obj = db.objects[i].cloud
                c0, cov = obj.centroid(0), obj.covariance(0).astype(np.float64)
                for p in range(k):
                    T = np.asarray(poses[i][p], np.float32)
                    R = T[:3, :3].astype(np.float64)
                    cents.append(R @ c0 + T[:3, 3])
                    sigs.append(np.linalg.pinv(R @ cov @ R.T))
                cent_l.append(np.asarray(cents).reshape(-1, 3))
                sig_l.append(np.asarray(sigs).reshape(-1, 3, 3))
                for _ in range(k):
                    cells_l.append(np.zeros(0, np.int64))
                    cells_off.append(cells_off[-1])
        prop_off.append(prop_off[-1] + k)

    def cat(lst, dtype, width):
        if not lst:
            return np.zeros((0, width) if width > 1 else 0, dtype)
        a = np.concatenate([np.asarray(x, dtype).reshape(-1, width)
                            for x in lst])
        return np.ascontiguousarray(a if width > 1 else a.reshape(-1))

    init_items = list(db.arrangements[scene_idx])
    ex_trans, ex_cent, ex_sig = [], [], []
    ex_cells, ex_cells_off = [], [0]
    init = dict(
        uidx=np.array([p.uidx for p in init_items], np.int64),
        arr_idx=np.array([p.arrangement_idx for p in init_items], np.int64),
        objidx=np.array([p.object_idx for p in init_items], np.int64),
        ref=np.array([-1 - j for j in range(len(init_items))], np.int64),
        score=np.array([p.score for p in init_items], np.float64))
    for p in init_items:
        ex_trans.append(np.asarray(p.pose, np.float32)[:3, 3])
        cent, sig_inv = placement_gaussian(ctx, db, p)
        ex_cent.append(cent)
        ex_sig.append(sig_inv)
        if ctx.obj_static[p.object_idx]:
            sal = np.zeros(0, np.int64)
        else:
            c = placement_cells(ctx, db, p)
            sal = c[ctx.scn_valid[c]]
        ex_cells.append(sal)
        ex_cells_off.append(ex_cells_off[-1] + len(sal))

    past_off = [0]
    past_uidx, past_class, past_pos, past_objidx = [], [], [], []
    for ai in range(n_arr - 1):
        arr = db.arrangements[ai]
        for p in arr:
            past_uidx.append(p.uidx)
            past_class.append(db.objects[p.object_idx].class_idx)
            past_pos.append(np.asarray(p.pose, np.float32)[:3, 3])
            past_objidx.append(p.object_idx)
        past_off.append(len(past_uidx))

    likelihoods = np.asarray(opts.sa_action_likelihoods, np.float64)
    lk_noswap = likelihoods.copy()
    lk_noswap[3] = 0.0
    weights = np.asarray(opts.energy_weights_sa, np.float64)
    cfg = dict(
        n_iter=opts.n_sa_iter, seed=config.SA_SEED,
        restart_prob=config.SA_RESTART_PROB, init_temp=config.SA_INIT_TEMP,
        min_temp=config.SA_MIN_TEMP, weights4=np.ascontiguousarray(weights),
        wsum=float(weights.sum()), n_past=opts.n_past_steps,
        swap_thr=config.SWAP_DIST_THRESHOLD,
        replace_thr=config.REPLACE_DIST_THRESHOLD,
        dup_pen=config.HYSTER_DUPLICATE_PENALTY,
        mismatch_pen=config.HYSTER_MISMATCH_PENALTY,
        existed_bonus=config.HYSTER_EXISTED_BONUS,
        novel_bonus=config.HYSTER_NOVEL_BONUS,
        decay_a=config.HYSTER_DECAY_A, decay_b=config.HYSTER_DECAY_B,
        base_scale=config.HYSTER_BASE_SCALE,
        mah_scale=config.ISECT_MAHALANOBIS_SCALE,
        pdf_full=np.ascontiguousarray(mshrng.distrib2pdf(likelihoods)),
        pdf_noswap=np.ascontiguousarray(mshrng.distrib2pdf(lk_noswap)))
    tables = dict(
        n_obj=n_obj, obj_static=ctx.obj_static.astype(np.uint8),
        obj_uidx=np.array([o.uidx for o in db.objects], np.int64),
        obj_class=np.ascontiguousarray(ctx.obj_class, np.int64),
        obj_sigma=_obj_sigma_of(db),
        obj_pdf=np.ascontiguousarray(mshrng.distrib2pdf(lik)),
        prop_off=np.asarray(prop_off, np.int64),
        prop_trans=cat(trans_l, np.float32, 3),
        prop_score=cat(score_l, np.float64, 1),
        prop_add_pdf=cat(add_pdf_l, np.float64, 1),
        prop_cent=cat(cent_l, np.float64, 3),
        prop_sig=cat([s.reshape(-1, 9) for s in sig_l], np.float64, 9),
        cells_off=np.asarray(cells_off, np.int64),
        cells=cat(cells_l, np.int64, 1),
        n_extra=len(init_items),
        ex_trans=cat(ex_trans, np.float32, 3),
        ex_cent=cat(ex_cent, np.float64, 3),
        ex_sig=cat([s.reshape(9) for s in ex_sig], np.float64, 9),
        ex_cells_off=np.asarray(ex_cells_off, np.int64),
        ex_cells=cat(ex_cells, np.int64, 1),
        n_cells_total=len(ctx.scn_valid), n_scn_valid=ctx.n_scn_valid,
        n_past_arr=n_arr - 1,
        past_off=np.asarray(past_off, np.int64),
        past_uidx=np.asarray(past_uidx, np.int64),
        past_class=np.asarray(past_class, np.int64),
        past_pos=cat(past_pos, np.float32, 3),
        past_objidx=np.asarray(past_objidx, np.int64),
        scene_idx=scene_idx, n_arr=n_arr)
    return cfg, tables, init, init_items


def _simulated_annealing_native(ctx: EnergyContext, db: Rsdb, scene_idx: int,
                                opts: config.ArrangementOpts,
                                trace_fp=None, follow=None) -> None:
    from ..core import native

    cfg, tables, init, init_items = _marshal_sa(ctx, db, scene_idx, opts)
    follow_a = None
    if follow is not None:
        follow_a = np.array([int(r[9]) for r in follow], np.uint8)
    n_done, trace, muts, out_items, out_scores, (init_sc, max_sc) = \
        native.sa_run(cfg, tables, init, follow=follow_a)

    if trace_fp is not None:
        for r in trace:
            trace_fp.write(f"{int(r[0])} {int(r[1])} {int(r[2])} "
                           f"{int(r[3])} {r[4]:.9g} {r[5]:.9g} {r[6]:.9g} "
                           f"{r[7]:.9g} {r[8]:.9g} {int(r[9])}\n")

    # replay linearize-ids mutations on the PAST arrangements (the native
    # loop already applied them to its own committed copy; past_uidx was
    # mutated in place but db holds Placement objects, not that buffer)
    for si, pi, u in muts:
        if si < scene_idx:
            db.arrangements[int(si)][int(pi)].uidx = int(u)

    poses = db.proposed_poses[scene_idx]
    pscores = db.proposed_scores[scene_idx]
    prop_off = tables["prop_off"]
    out = []
    for (uidx, arr_idx, objidx, ref), score in zip(out_items, out_scores):
        if ref >= 0:
            i = int(np.searchsorted(prop_off, ref, side="right") - 1)
            k = int(ref - prop_off[i])
            out.append(Placement(uidx=int(uidx),
                                 arrangement_idx=int(arr_idx),
                                 object_idx=i, pose_idx=k,
                                 pose=poses[i][k],
                                 score=float(pscores[i][k])))
        else:
            orig = init_items[int(-1 - ref)]
            out.append(Placement(uidx=int(uidx),
                                 arrangement_idx=int(arr_idx),
                                 object_idx=int(objidx),
                                 pose_idx=orig.pose_idx, pose=orig.pose,
                                 score=float(score)))
    db.arrangements[scene_idx] = out
    print(f"SIMULATED_ANNEALING: Done. | Score: {init_sc:f} -> {max_sc:f}")


def simulated_annealing(ctx: EnergyContext, db: Rsdb, scene_idx: int,
                        opts: config.ArrangementOpts,
                        trace_fp=None, follow=None) -> None:
    """``trace_fp``: optional file — writes one line per iteration in the
    arrangement-oracle trace format ("iter restart action n prev cur temp
    accept_p roll accepted") for step-level parity against the reference
    (tools/run_arrangement_parity.py). ``follow``: optional list of parsed
    oracle trace rows; each iteration's accept decision is FORCED to the
    oracle's so both trajectories stay on the identical state sequence and
    every divergence is localized to the step it happened at instead of
    cascading.

    Engine dispatch: the default engine is the native C++ loop
    (rescan_sa_run — bit-exact with this Python loop, which PARITY_r03
    proved oracle-exact vs the instrumented reference; trace equality is
    unit-tested). RESCAN_SA_ENGINE=python selects this Python loop."""
    import os as _os

    likelihoods = np.asarray(opts.sa_action_likelihoods, np.float64)
    if likelihoods[0] < 0.001 and len(db.arrangements[scene_idx]) < 2:
        return
    if _os.environ.get("RESCAN_SA_ENGINE", "native") == "native":
        return _simulated_annealing_native(ctx, db, scene_idx, opts,
                                           trace_fp=trace_fp, follow=follow)

    rand = mshrng.MshRand(config.SA_SEED)
    poses = db.proposed_poses[scene_idx]
    pscores = db.proposed_scores[scene_idx]
    weights = opts.energy_weights_sa
    state = FastEnergy(ctx, db, scene_idx, weights, opts.n_past_steps,
                       [dataclasses.replace(p)
                        for p in db.arrangements[scene_idx]])

    likelihoods = np.asarray(opts.sa_action_likelihoods, np.float64)
    if likelihoods[0] < 0.001 and len(state.items) < 2:
        return

    init_score = state.score()
    prev_score = init_score
    max_score = init_score

    # per-object proposal translations, precomputed for the swap/replace
    # distance gates (sliced per action in the reference, :560,:753)
    trans = [None if poses[i] is None or len(poses[i]) == 0
             else np.ascontiguousarray(
                 np.asarray(poses[i], np.float32)[:, :3, 3])
             for i in range(len(poses))]

    def commit():
        db.arrangements[scene_idx] = [dataclasses.replace(p)
                                      for p in state.items]

    # action pdfs depend only on whether swap is enabled (:832-841)
    pdf_full = list(mshrng.distrib2pdf(likelihoods))
    lk_noswap = likelihoods.copy()
    lk_noswap[3] = 0.0
    pdf_noswap = list(mshrng.distrib2pdf(lk_noswap))

    for it in range(opts.n_sa_iter):
        # random restart (:821-829)
        restarted = 0
        if rand.next_f32() < config.SA_RESTART_PROB:
            restarted = 1
            state.rebuild([dataclasses.replace(p)
                           for p in db.arrangements[scene_idx]])

        # action selection (:832-841)
        pdf = pdf_noswap if len(state.items) < 2 else pdf_full
        action = mshrng.pdfsample_linear(pdf, rand.next_f32())

        undo = None
        if action == 0:      # ADD (:628-705)
            undo = _apply_add(db, ctx, scene_idx, rand, state, poses, pscores)
        elif action == 1:    # REMOVE (:707-727)
            undo = _apply_remove(rand, state)
        elif action == 2:    # REPLACE (:729-787)
            undo = _apply_replace(db, ctx, scene_idx, rand, state, poses,
                                  pscores, trans)
        elif action == 3:    # SWAP (:527-626)
            undo = _apply_swap(rand, state, poses, pscores, trans)
        elif action == 4:    # MOVE (:494-525)
            undo = _apply_move(rand, state, poses, pscores)

        cur_score = state.score()
        if _os.environ.get("RESCAN_SA_DEBUG"):
            print(f"PYDBG {it} cur={cur_score!r} "
                  f"hyst={state._hysteresis()!r} n={len(state.items)}",
                  " ".join(f"[u{p.uidx} o{p.object_idx} k{p.pose_idx} "
                           f"f={state._f[j][0]!r} e{int(state._f[j][1])} "
                           f"m{int(state._f[j][2])}]"
                           for j, p in enumerate(state.items)),
                  "past=" + ";".join(
                      ",".join(str(q.uidx) for q in arr)
                      for arr in db.arrangements))
        if cur_score < 0:
            commit()
            break
        temp = max(config.SA_INIT_TEMP * (1.0 - it / opts.n_sa_iter),
                   config.SA_MIN_TEMP)
        accept_p = (1.0 if cur_score > prev_score
                    else math.exp(-(prev_score - cur_score) / temp))
        roll = rand.next_f32()
        accepted = accept_p >= roll
        if trace_fp is not None:
            trace_fp.write(f"{it} {restarted} {action} {len(state.items)} "
                           f"{prev_score:.9g} {cur_score:.9g} {temp:.9g} "
                           f"{accept_p:.9g} {roll:.9g} {int(accepted)}\n")
        if follow is not None and it < len(follow):
            accepted = bool(int(follow[it][9]))
        if accepted:
            prev_score = cur_score
            if cur_score > max_score:
                max_score = cur_score
                commit()
        else:
            if undo is not None:
                undo()
        if _linearize_ids(db, ctx.obj_static):
            state.invalidate_past()

    print(f"SIMULATED_ANNEALING: Done. | Score: {init_score:f} -> {max_score:f}")


def _repose(p: Placement, pose, score: float, k: int) -> Placement:
    """dataclasses.replace(p, pose=..., score=..., pose_idx=...) without
    the ~20 us replace() machinery (SA calls this several times per
    iteration)."""
    return Placement(uidx=p.uidx, arrangement_idx=p.arrangement_idx,
                     object_idx=p.object_idx, pose_idx=k, pose=pose,
                     score=score)


def _apply_move(rand, state: FastEnergy, poses, pscores):
    cur = state.items
    n = len(cur)
    if n == 0:
        return None
    idx = rand.next_u32() % n
    old = cur[idx]
    obj_idx = cur[idx].object_idx
    if poses[obj_idx] is None or len(poses[obj_idx]) == 0:
        return None
    k = rand.next_u32() % len(poses[obj_idx])
    state.set(idx, _repose(cur[idx], poses[obj_idx][k],
                           float(pscores[obj_idx][k]), k))

    def undo():
        state.set(idx, old)
    return undo


def _apply_swap(rand, state: FastEnergy, poses, pscores, trans):
    """Swap: re-draw poses for two placements, each near the other's
    position (:527-626)."""
    cur = state.items
    n = len(cur)
    ia = rand.next_u32() % n
    ib = ia
    while ib == ia:
        ib = rand.next_u32() % n
    a, b = cur[ia], cur[ib]
    olds = (a, b)

    def pick_near(obj_idx, target_pos):
        t = trans[obj_idx]
        if t is None:
            return None
        diff = t - target_pos[None, :]
        d = np.sqrt((diff * diff).sum(axis=1))
        thr = config.SWAP_DIST_THRESHOLD
        dmin = d.min()
        if thr < dmin:
            thr = 2.0 * dmin
        idxs = np.nonzero(d < thr)[0]
        if len(idxs) == 0:
            return None
        return int(idxs[rand.next_u32() % len(idxs)])

    ka = pick_near(a.object_idx, b.pose[:3, 3])
    kb = pick_near(b.object_idx, a.pose[:3, 3])
    if ka is not None:
        state.set(ia, _repose(a, poses[a.object_idx][ka],
                              float(pscores[a.object_idx][ka]), ka))
    if kb is not None:
        state.set(ib, _repose(b, poses[b.object_idx][kb],
                              float(pscores[b.object_idx][kb]), kb))

    def undo():
        state.set(ia, olds[0])
        state.set(ib, olds[1])
    return undo


def _apply_add(db, ctx, scene_idx, rand, state: FastEnergy, poses, pscores):
    """Add: uniform dynamic object, pose by normalized-score pdf
    (:628-705)."""
    max_uidx, _, _ = _find_max_uidx(db, ctx.obj_static)
    used = {p.uidx for p in db.arrangements[scene_idx]}

    lik = np.array([0.0 if ctx.obj_static[i] else 1.0
                    for i in range(len(db.objects))])
    pdf = mshrng.distrib2pdf(lik)
    obj_idx = mshrng.pdfsample_linear(pdf, rand.next_f32())
    if obj_idx >= len(db.objects) or poses[obj_idx] is None or len(poses[obj_idx]) == 0:
        return None
    sc = np.asarray(pscores[obj_idx], np.float64)
    mx, mn = max(sc.max(), 0.0), min(sc.min(), 1.0)
    rangev = mx - mn
    norm = (sc - mn) / rangev if rangev > 0 else np.zeros_like(sc)
    pdf = mshrng.distrib2pdf(norm)
    k = mshrng.pdfsample_linear(pdf, rand.next_f32())
    k = min(k, len(sc) - 1)
    uidx = db.objects[obj_idx].uidx
    if uidx in used:
        uidx = max_uidx + 1
    state.add(Placement(uidx=uidx, arrangement_idx=scene_idx,
                        object_idx=obj_idx, pose_idx=k,
                        pose=poses[obj_idx][k],
                        score=float(pscores[obj_idx][k])))

    def undo():
        state.remove_swap(len(state.items) - 1)
    return undo


def _apply_remove(rand, state: FastEnergy):
    """Remove: swap-remove a random placement (:707-727). The reference's
    revert reads the one-past-end slot of the shrunk array — which still
    holds the REMOVED element (swap-remove parked it there) — and pushes it
    back at the TAIL, leaving the old last element at ``idx``. The
    resulting order ([..., old_last@idx, ..., removed@end]) matters: every
    later index draw (move/swap/replace/remove) is position-based, so the
    exact order must be replicated (oracle SA traces diverge otherwise)."""
    n = len(state.items)
    if n == 0:
        return None
    idx = rand.next_u32() % n
    removed = state.remove_swap(idx)

    def undo():
        state.add(removed)
    return undo


def _apply_replace(db, ctx, scene_idx, rand, state: FastEnergy, poses,
                   pscores, trans):
    """Replace: swap a placement for a score-weighted nearby proposal of
    any dynamic object (:729-787)."""
    cur = state.items
    n = len(cur)
    if n == 0:
        return None
    idx = rand.next_u32() % n
    old = cur[idx]
    old_pos = old.pose[:3, 3]
    cand = []
    for i in range(len(trans)):
        if ctx.obj_static[i] or trans[i] is None:
            continue
        diff = trans[i] - old_pos[None, :]
        dist = np.sqrt((diff * diff).sum(axis=1))
        match = dist < config.REPLACE_DIST_THRESHOLD
        if len(cand) + int(match.sum()) < 1024:
            for k in np.nonzero(match)[0]:
                cand.append((i, int(k), float(pscores[i][k])))
        else:
            # cap reachable: replicate the reference's per-k cap check
            # (1024 cap tested after EVERY pose, matched or not, :760-764)
            for k in range(len(poses[i])):
                if match[k]:
                    cand.append((i, k, float(pscores[i][k])))
                if len(cand) >= 1024:
                    break
    if not cand:
        return None
    sc = np.array([c[2] for c in cand], np.float64)
    pdf = mshrng.distrib2pdf(sc)
    sel = mshrng.pdfsample_linear(pdf, rand.next_f32())
    sel = min(sel, len(cand) - 1)
    i, k, s = cand[sel]
    state.set(idx, Placement(uidx=db.objects[i].uidx,
                             arrangement_idx=len(db.arrangements),
                             object_idx=i, pose_idx=k, pose=poses[i][k],
                             score=s))

    def undo():
        state.set(idx, old)
    return undo
