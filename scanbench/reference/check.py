"""The plain reference that decides ``correct``.

It judges what the timed rescans produced, at their own sizes, against
what it works out itself from the same inputs (the scan meshes; the prior
database's objects, cut from the first scan's mesh as the bootstrap
defines them) in float64:

* ``score_gap``: the proposals' scores (the scoring kernel K1 and the
  per-point terms) -- the widest gap between a sampled proposal's score
  and the score that the reference computes at the same pose, over the
  scene's and the object's level-1 points it samples itself;
* ``icp_gap_mm``: the ICP-refined poses (K2's ICP launches, the sums,
  the step's head and tail) -- at each object's best proposal, the
  distance between its level-2 points placed by the program's pose and
  by the pose that the reference's ICP reaches from the same starting
  hypothesis. The starting hypotheses are the program's (the grid
  search's survivors and the prior's poses, recorded as the ICP takes
  them): the reference follows the ICP from the program's own state;
* ``label_miss``: the arrangement and the transferred labels (K2's label
  launches, the smoothing) -- the share of the segmented scan's level-1
  points that lie at least ``INTERIOR_M`` from any surface of another
  label and carry a class or an instance (up to twins) other than the
  generator's.

``dtype`` float64 is the reference; bfloat16 is the control: the same
computation in the precision below the configuration's float32 (the
ICP's points placed and searched in it, its sums kept in float64).
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

from .. import scenes
from . import levels

SCORE_RADIUS = SCORE_SIGMA = 0.1    # at scene level 1 (pose_proposal.cpp:98)
SCORE_COS_GATE = math.cos(math.radians(35.0))
SCORE_ALPHA = 0.05
SCORE_NORMAL_SIGMA = 0.5
SCORE_LEVEL = 1
INTERIOR_M = 0.1
NEAREST = 8
# the proposals' ICP (apps/pose_proposal/main.cpp:195-197, icp.h:416-500):
# object and scene level 2, 60 degrees, max_dist 0.1 annealed by 0.95 an
# iteration down to 0.05, 2.5 sigma rejection, at most 100 iterations, a
# pair stopped after iteration 5 once its error moves by under 1e-5
ICP_LEVEL = 2
ICP_COS_GATE = math.cos(math.radians(60.0))
ICP_MAX_DIST, ICP_ANNEAL, ICP_FLOOR = 0.1, 0.95, 0.05
ICP_MAX_ITER, ICP_MIN_ITER, ICP_DELTA = 100, 5, 1e-5
ICP_SIGMAS = 2.5
ICP_STD_FLOOR = 1e-6
ICP_MIN_WSUM = 1e-7
# the ICP gap of a proposed pose that no ICP call returned
NO_ICP_MM = 1e9
# classes whose objects never move, and get no proposals but their prior
# poses (rs_database.h:257-288)
STATIC_CLASSES = ("wall", "floor", "ceiling", "door", "window", "picture",
                  "counter", "cabinet", "bookshelf", "shelves", "unlabelled",
                  "other")


class Scene:
    """A scan's level-1 points (scoring) and level-2 points (the ICP),
    each with its search tree."""

    def __init__(self, mesh: Dict[str, np.ndarray]):
        lvl0 = levels.resample(mesh)
        for name, lvl in (("", SCORE_LEVEL), ("icp_", ICP_LEVEL)):
            lv = levels.level(lvl0, lvl)
            setattr(self, name + "pos", lv["positions"])
            setattr(self, name + "nrm", lv["normals"])
            setattr(self, name + "tree",
                    cKDTree(lv["positions"].astype(np.float64)))


def objects_of(mesh: Dict[str, np.ndarray]) -> Dict[int, dict]:
    """The prior database's objects, worked out from the first scan's mesh
    as the bootstrap defines them (seg2rsdb, main.cpp:83-126): the
    resampled scan split by ground-truth instance id, in first-occurrence
    order; a dynamic object moved so that its centroid lies on the
    vertical through the origin. Per object index: ``gt_id``, ``static``
    and its level-0 ``cloud``."""
    lvl0 = levels.resample(mesh)
    ids = lvl0["instance_ids"]
    _, first = np.unique(ids, return_index=True)
    out = {}
    for i, uid in enumerate(ids[np.sort(first)]):
        cloud = {k: np.ascontiguousarray(v[ids == uid])
                 for k, v in lvl0.items()}
        static = scenes.NYU40_CLASSES[int(cloud["class_ids"][0])] \
            in STATIC_CLASSES
        if not static:
            c = cloud["positions"].astype(np.float64).mean(0) \
                .astype(np.float32)
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = [-c[0], 0.0, -c[2]]
            cloud["positions"] = (cloud["positions"] @ m[:3, :3].T
                                  + m[:3, 3]).astype(np.float32)
        # the object's file stores its normals; loading normalises them
        cloud["normals"] = levels._normalize_f32(cloud["normals"])
        out[i] = {"gt_id": int(uid), "static": static, "cloud": cloud}
    return out


def _t(a, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64)).to(dtype)


def _place(pts, nrm, T, dtype):
    T = np.asarray(T, np.float64)
    R = _t(T[:3, :3], dtype)
    return (_t(pts, dtype) @ R.T + _t(T[:3, 3], dtype),
            _t(nrm, dtype) @ R.T)


def _nearest_passing(tree, spos, snrm, q, qn, radius, cos_gate, dtype):
    """(query, scene point, d2, dot) of each query's nearest scene point
    within ``radius`` whose normal passes ``dot >= cos_gate``, in
    ``dtype``; queries with none are left out."""
    # candidates: the nearest few within the radius and a margin wider
    # than any rounding; every point within it where none of them passes
    reach = radius + (0.02 if dtype != torch.float64 else 1e-9)
    _, near = tree.query(q.double().numpy(), k=NEAREST,
                         distance_upper_bound=reach)
    n = len(spos)
    rows = np.repeat(np.arange(len(q)), NEAREST)
    cols = near.reshape(-1)
    full = (near[:, -1] < n)
    i, j = rows[cols < n], cols[cols < n]
    d2, dot, ok = _gate(q, qn, spos, snrm, i, j, radius, cos_gate, dtype)
    hit = np.zeros(len(q), bool)
    hit[i[ok]] = True
    redo = np.flatnonzero(full & ~hit)
    if len(redo):
        ball = tree.query_ball_point(q[redo].double().numpy(), reach)
        i2 = np.repeat(redo, [len(b) for b in ball])
        j2 = np.fromiter((x for b in ball for x in b), np.int64, len(i2))
        keep = ~np.isin(i, redo)
        i, j = np.concatenate([i[keep], i2]), np.concatenate([j[keep], j2])
        d2, dot, ok = _gate(q, qn, spos, snrm, i, j, radius, cos_gate,
                            dtype)
    i, j, d2, dot = i[ok], j[ok], d2[ok], dot[ok]
    order = np.lexsort((j, d2.double().numpy(), i))
    first = order[np.r_[True, i[order][1:] != i[order][:-1]]] \
        if len(order) else order
    return i[first], j[first], d2[first], dot[first]


def _gate(q, qn, spos, snrm, i, j, radius, cos_gate, dtype):
    """(d2, dot, passes) of the pairs (query i, scene point j) in
    ``dtype``."""
    d = q[i] - _t(spos[j], dtype)
    d2 = (d * d).sum(1)
    dot = (qn[i] * _t(snrm[j], dtype)).sum(1)
    ok = ((d2 < _t(radius * radius, dtype))
          & (dot >= _t(cos_gate, dtype))).numpy()
    return d2, dot, ok


def score(scene: Scene, pts: np.ndarray, nrm: np.ndarray, T: np.ndarray,
          dtype=torch.float64) -> float:
    """The proposal score of ``pts``/``nrm`` placed by ``T``: the mean over
    the points of 0.95 exp(-d^2 / 2 sigma^2) + 0.05 exp(-angle^2 / 2 0.5^2)
    for the nearest scene point within the radius whose normal lies within
    35 degrees; 0 where there is none."""
    q, qn = _place(pts, nrm, T, dtype)
    _, _, d2, dot = _nearest_passing(scene.tree, scene.pos, scene.nrm, q, qn,
                                     SCORE_RADIUS, SCORE_COS_GATE, dtype)
    ang = torch.acos(dot.clamp(0.0, 1.0))
    per = ((1.0 - SCORE_ALPHA) * torch.exp(-d2 / (2.0 * SCORE_SIGMA ** 2))
           + SCORE_ALPHA * torch.exp(-(ang * ang)
                                     / (2.0 * SCORE_NORMAL_SIGMA ** 2)))
    return float(per.sum() / len(pts))


# --- the ICP (lib/rs/icp.h:416-500) ------------------------------------------

def _rotation_xyz(a: torch.Tensor) -> torch.Tensor:
    """Rx(a0) Ry(a1) Rz(a2) (icp.h:288-290)."""
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a[0]), torch.zeros_like(a[0])
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, c[0], -s[0]]),
                      torch.stack([zero, s[0], c[0]])])
    ry = torch.stack([torch.stack([c[1], zero, s[1]]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-s[1], zero, c[1]])])
    rz = torch.stack([torch.stack([c[2], -s[2], zero]),
                      torch.stack([s[2], c[2], zero]),
                      torch.stack([zero, zero, one])])
    return rx @ ry @ rz


def icp_step(scene: Scene, pts: np.ndarray, nrm: np.ndarray, T: np.ndarray,
             dist: float, dtype=torch.float64):
    """One point-to-plane ICP iteration at pose ``T`` (icp.h:416-500), the
    points placed and searched in ``dtype``, the sums and the solve in
    float64 (as a kernel accumulates wider than it stores): the nearest
    scene point within ``dist`` whose normal lies within 60 degrees;
    weights (1 - d2 / dist) dot; pairs with d2 above 2.5 standard
    deviations of d2 dropped; the 6 x 6 normal system about the weighted
    centroid with the reference's damping; the update Trans(c1) Trans(t)
    Rx Ry Rz Trans(-c1). Returns (update 4 x 4, the error, whether any
    weight was left)."""
    q, qn = _place(pts, nrm, T, dtype)
    i, j, d2, dot = _nearest_passing(scene.icp_tree, scene.icp_pos,
                                     scene.icp_nrm, q, qn, dist,
                                     ICP_COS_GATE, dtype)
    f64 = torch.float64
    if not len(i):
        return np.eye(4), 0.0, False
    p2 = _t(scene.icp_pos[j], dtype).to(f64)
    n2 = _t(scene.icp_nrm[j], dtype).to(f64)
    a, d2, dot = q[i].to(f64), d2.to(f64), dot.to(f64)
    w = (1.0 - d2 / dist) * dot
    std = torch.sqrt(((d2 - d2.mean()) ** 2).mean())
    if float(std) > ICP_STD_FLOOR:
        w = torch.where(d2 <= ICP_SIGMAS * std, w, torch.zeros_like(w))
    wsum = w.sum()
    if float(wsum) <= ICP_MIN_WSUM:
        return np.eye(4), 0.0, False
    c1 = (w[:, None] * a).sum(0) / wsum
    c2 = (w[:, None] * p2).sum(0) / wsum
    p = a - c1
    d = p - (p2 - c2)
    j6 = torch.cat([torch.cross(p, n2, dim=1), n2], 1)
    ddn = (d * n2).sum(1)
    C = (w[:, None, None] * j6[:, :, None] * j6[:, None, :]).sum(0)
    rhs = -(w[:, None] * j6 * ddn[:, None]).sum(0)
    C = C + torch.eye(6, dtype=f64) * (1e-6 * torch.trace(C) / 6.0 + 1e-20)
    x = torch.linalg.solve(C, rhs)
    R = _rotation_xyz(x[:3])
    upd = torch.eye(4, dtype=f64)
    upd[:3, :3] = R
    upd[:3, 3] = c1 + x[3:] - R @ c1
    err = float(torch.sqrt((w * ddn * ddn).sum() / wsum))
    return upd.numpy(), err, True


def icp(scene: Scene, pts: np.ndarray, nrm: np.ndarray, T0: np.ndarray,
        dtype=torch.float64) -> np.ndarray:
    """The proposals' ICP from ``T0`` (apps/pose_proposal/main.cpp:195-197
    with icp.h's loop): max_dist 0.1 annealed by 0.95 an iteration (in
    float32, as the configuration states it) down to 0.05, at most 100
    iterations, a pair stopped after iteration 5 once its error changes
    by less than 1e-5 or when no weight is left. Returns the final pose
    (float64)."""
    T = np.asarray(T0, np.float64)
    err, dist = 1e6, np.float32(ICP_MAX_DIST)
    for it in range(ICP_MAX_ITER):
        upd, new_err, ok = icp_step(scene, pts, nrm, T, float(dist), dtype)
        if not ok:
            break
        T = upd @ T
        if it > ICP_MIN_ITER and abs(err - new_err) < ICP_DELTA:
            break
        err = new_err
        dist = max(np.float32(dist * np.float32(ICP_ANNEAL)),
                   np.float32(ICP_FLOOR))
    return T


def pose_gap_mm(pts: np.ndarray, A: np.ndarray, B: np.ndarray) -> float:
    """The root mean square distance (mm) between the points placed by
    ``A`` and by ``B``."""
    p = pts.astype(np.float64)
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    d = p @ (A[:3, :3] - B[:3, :3]).T + (A[:3, 3] - B[:3, 3])
    return 1e3 * float(np.sqrt((d * d).sum(1).mean()))


# --- the generator's surfaces ----------------------------------------------

def _rects(room: scenes.Room):
    """(origin, u, v, class id, instance id) of every flat piece of the
    room's surface, u and v its two edges."""
    cls = scenes.NYU40_CLASSES.index
    w, d = room.size
    h = room.wall_height
    out = [((0, 0, 0), (w, 0, 0), (0, 0, d), cls("floor"), scenes.FLOOR_ID)]
    for o, u in (((0, 0, 0), (w, 0, 0)), ((0, 0, d), (w, 0, 0)),
                 ((0, 0, 0), (0, 0, d)), ((w, 0, 0), (0, 0, d))):
        out.append((o, u, (0, h, 0), cls("wall"), scenes.WALL_ID))
    for k, b in enumerate(room.objects):
        c, s = math.cos(b.rot), math.sin(b.rot)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        ctr = np.array([b.center[0], 0.0, b.center[1]])
        sx, sy, sz = b.size
        lo = np.array([-sx / 2, 0.0, -sz / 2])
        ex = np.diag([sx, sy, sz])
        for axis in range(3):
            e1, e2 = [ex[a] for a in range(3) if a != axis]
            for side in (0.0, 1.0):
                o = lo + side * ex[axis]
                out.append((R @ o + ctr, R @ e1, R @ e2, cls(b.cls),
                            scenes.FIRST_OBJECT_ID + k))
    return out


def _rect_dist(p: np.ndarray, o, u, v) -> np.ndarray:
    o, u, v = (np.asarray(a, np.float64) for a in (o, u, v))
    r = p - o
    a = np.clip(r @ u / (u @ u), 0.0, 1.0)
    b = np.clip(r @ v / (v @ v), 0.0, 1.0)
    return np.linalg.norm(r - a[:, None] * u - b[:, None] * v, axis=1)


def gt_labels(room: scenes.Room, twins: Dict[int, int], pts: np.ndarray,
              dtype=torch.float64):
    """(label group, interior) of each point: the class and twin group of
    the nearest surface, and whether every surface of another label lies
    at least INTERIOR_M away. The points are taken in ``dtype``."""
    p = _t(pts, dtype).double().numpy()
    rects = _rects(room)
    dist = np.stack([_rect_dist(p, o, u, v) for o, u, v, _, _ in rects], 1)
    group = np.array([c * 4096 + twins[i] for _, _, _, c, i in rects])
    own = group[dist.argmin(1)]
    other = np.where(group[None, :] == own[:, None], np.inf, dist)
    return own, other.min(1) >= INTERIOR_M


def label_miss(room: scenes.Room, twins: Dict[int, int], pts: np.ndarray,
               pred: np.ndarray) -> float:
    """The share of interior points whose label group is not ``pred``."""
    truth, interior = gt_labels(room, twins, pts)
    if not interior.any():
        raise ValueError("no interior points to judge")
    return float((np.asarray(pred) != truth)[interior].mean())


def label_group(twins: Dict[int, int], cls: np.ndarray, ins: np.ndarray
                ) -> np.ndarray:
    return np.asarray(cls, np.int64) * 4096 + np.array(
        [twins.get(int(i), -1) for i in np.asarray(ins)], np.int64)


def judge(rescans: List[dict], objects: Dict[int, dict], seed: int,
          sample: int, control: bool = False,
          memo: Optional[dict] = None) -> Dict[str, float]:
    """The three numbers over the given rescans' outputs.

    ``rescans``: per rescan, ``room`` (the scan's scenes.Room), ``mesh``
    (its mesh), ``twins``, and the outputs ``proposals`` (object index ->
    (poses (n, 4, 4), scores (n,)), best first), ``icp_starts`` (object
    index -> the hypothesis from which the ICP reached each pose, None
    for a pose that no ICP call returned) and ``labels`` (the level-1
    positions, class and instance ids). ``objects``: per object
    index of the prior database, as ``objects_of`` gives them.
    ``sample``: proposals drawn from ``seed`` per rescan beside every
    object's best, for the scores; the ICP's poses are judged at each
    object's best (a hypothesis far from any object follows rounding
    into another minimum, so a gap there measures the ICP's sensitivity,
    not its arithmetic). ``control``: judge the control in the program's place:
    the scores, the ICP's poses and the labels as the reference works
    them out in bfloat16. ``memo``: a dict kept between calls on the same
    ``rescans``, so that judging them for many seeds works each proposal
    out once."""
    low = torch.bfloat16 if control else torch.float64
    rng = np.random.default_rng(seed % (1 << 64))
    memo = {} if memo is None else memo

    def once(key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    obj = {i: {lvl: once(("object", i, lvl),
                         lambda o=o, lvl=lvl: levels.level(o["cloud"], lvl))
               for lvl in (SCORE_LEVEL, ICP_LEVEL)}
           for i, o in objects.items()}
    gap = step = miss = 0.0
    for r in rescans:
        room = repr(r["room"])
        scene = once(("scene", room), lambda r=r: Scene(r["mesh"]))
        props = {i: p for i, p in r["proposals"].items()
                 if not objects[i]["static"]}
        picks = [(i, 0) for i, (p, _) in props.items() if len(p)]
        pool = [(i, k) for i, (p, _) in props.items()
                for k in range(1, len(p))]
        if pool:
            for m in rng.choice(len(pool), min(sample, len(pool)),
                                replace=False):
                picks.append(pool[int(m)])
        for i, k in picks:
            poses, scores = r["proposals"][i]
            o1, o2 = obj[i][SCORE_LEVEL], obj[i][ICP_LEVEL]
            at = (room, i, np.asarray(poses[k], np.float64).tobytes())
            want = once(("score", *at), lambda: score(
                scene, o1["positions"], o1["normals"], poses[k]))
            have = once(("score_control", *at), lambda: score(
                scene, o1["positions"], o1["normals"], poses[k], low)) \
                if control else float(scores[k])
            gap = max(gap, abs(have - want))
            start = r["icp_starts"][i][k]
            if k:
                continue
            if start is None:           # a pose that no ICP call returned
                step = max(step, NO_ICP_MM)
                continue
            ref = once(("icp", *at), lambda: icp(
                scene, o2["positions"], o2["normals"], start))
            got = once(("icp_control", *at), lambda: icp(
                scene, o2["positions"], o2["normals"], start, low)) \
                if control else poses[k]
            step = max(step, pose_gap_mm(o2["positions"], got, ref))
        lab = r["labels"]
        pred = gt_labels(r["room"], r["twins"], lab["positions"], low)[0] \
            if control else label_group(r["twins"], lab["class_ids"],
                                        lab["instance_ids"])
        miss = max(miss, once(("labels", room, control), lambda: label_miss(
            r["room"], r["twins"], lab["positions"], pred)))
    return {"score_gap": gap, "icp_gap_mm": step, "label_miss": miss}
