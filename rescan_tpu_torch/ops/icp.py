"""Batched point-to-plane ICP — the port of rescan_tpu/ops/icp.py.

Every (object, pose) pair of a batch iterates together; per-pair
convergence is an ``active`` mask, and the loop runs while
``it < max_iter`` and some pair is active. Correspondences come from K2
(ops/gnn.py ``nearest_gated``) against the scene slab.

Semantics mirror the reference (lib/rs/icp.h:416-500) and the JAX
package, quirks included:

* correspondences: nearest scene point within the current max_dist whose
  normal passes ``max(dot, 0) >= cos(max_angle)``;
* weights ``(1 - d2 / max_dist) * dot`` (d2 squared, max_dist not);
* outlier rejection: weights zeroed where ``d2 > 2.5 * std(d2)`` over the
  accepted set (squared distances, against the std alone);
* update: Low '04 linearisation about the weighted source centroid, the
  6x6 normal system with the same Tikhonov damping, composed as
  ``Trans(c1) Trans(t) Rx Ry Rz Trans(-c1) @ T``;
* loop: stop a pair when ``|err - prev| < 1e-5`` after iteration 5;
  ``max_dist <- max(0.95 * max_dist, 0.05)`` each iteration, in f32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import config
from . import gnn, search
from .reduce import small_matmul, tree_sum


def _rotation_xyz(ax, ay, az):
    """R = Rx(ax) @ Ry(ay) @ Rz(az) (icp.h:288-290)."""
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one = torch.ones_like(ax)
    zero = torch.zeros_like(ax)
    rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cx, -sx], -1),
                      torch.stack([zero, sx, cx], -1)], -2)
    ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    rz = torch.stack([torch.stack([cz, -sz, zero], -1),
                      torch.stack([sz, cz, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return small_matmul(small_matmul(rx, ry), rz)


def cos_gate_of(max_angle) -> float:
    """cos(max_angle) formed in f32, as the reference's jitted code forms
    it (icp.py:92)."""
    return float(torch.cos(torch.tensor(np.float32(max_angle))))


def _no_sum(*xs):
    return xs


def _icp_step(obj_pts, obj_nrm, obj_mask, index, scene_pts, scene_nrm, T,
              err, dist: np.float32, active, it: int, cos_gate: float,
              allsum=None):
    """One iteration for every pair; returns (T, err, active).

    Every per-pair sum over points is a ``tree_sum`` (ops/reduce.py), so
    a pair's result does not depend on the pairs batched beside it. The
    sums come in four dependent rounds (count and sum of d2; sum of
    squared deviations; sums of w, w*q and w*p2; the normal system and
    the error); everything after a round is computed from its totals.
    ``allsum``: with each pair's points split over shards
    (parallel/mesh.py, the sp mode), a function that adds a round's
    per-pair partial sums over the shards, by the same tree, and hands
    every shard the same totals. None on one shard."""
    total = allsum or _no_sum
    B, N, _ = obj_pts.shape
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    q = torch.einsum("bij,bnj->bni", R, obj_pts) + t[:, None, :]
    qn = torch.einsum("bij,bnj->bni", R, obj_nrm)
    # inactive pairs query from far away: their blocks are near no tile
    q = torch.where(active[:, None, None], q, 2e6)
    idx, d2, dot = search.nearest_gated(index, q.reshape(B * N, 3),
                                        qn.reshape(B * N, 3), dist, cos_gate)
    idx = idx.reshape(B, N).long()
    d2 = d2.reshape(B, N)
    dot = dot.reshape(B, N)
    ok = (idx >= 0) & obj_mask
    idx_safe = idx.clamp_min(0)
    p2 = scene_pts[idx_safe]
    n2 = scene_nrm[idx_safe]

    dist_f = float(dist)
    w = torch.where(ok, (1.0 - d2 / dist_f) * dot, 0.0)
    # 2.5-sigma rejection on squared distances (icp.h:393-401)
    cnt_raw, d2_sum = total(ok.sum(1), tree_sum(torch.where(ok, d2, 0.0)))
    cnt = cnt_raw.clamp_min(1)
    mean = d2_sum / cnt
    (dev_sum,) = total(tree_sum(
        torch.where(ok, (d2 - mean[:, None]) ** 2, 0.0)))
    var = dev_sum / cnt
    std = torch.sqrt(var)
    keep = (std[:, None] <= 1e-6) | (d2 <= 2.5 * std[:, None])
    w = torch.where(keep, w, 0.0)

    (s3,) = total(tree_sum(torch.cat([w[..., None], w[..., None] * q,
                                      w[..., None] * p2], -1)))
    wsum, wq, wp2 = s3[:, 0], s3[:, 1:4], s3[:, 4:7]
    has_corrs = (cnt_raw > 0) & (wsum > 1e-7)
    wsafe = wsum.clamp_min(1e-30)
    c1 = wq / wsafe[:, None]
    c2 = wp2 / wsafe[:, None]
    p = q - c1[:, None, :]
    qq = p2 - c2[:, None, :]
    d = p - qq
    cxn = torch.linalg.cross(p, n2)
    # products and sums in the reference's order (icp.py:152-165): ddn as
    # its einsum over i, e2 as w * (ddn * ddn), the trace left to right
    ddn = d[..., 0] * n2[..., 0] + d[..., 1] * n2[..., 1] \
        + d[..., 2] * n2[..., 2]

    # 6x6 normal system: J = [c; n] per correspondence (Low '04)
    j6 = torch.cat([cxn, n2], dim=-1)                       # (B, N, 6)
    wj6 = w[..., None] * j6
    wd = w * ddn
    (s4,) = total(tree_sum(torch.cat([
        (wj6[..., :, None] * j6[..., None, :]).reshape(B, N, 36),
        j6 * wd[..., None], (w * (ddn * ddn))[..., None]], -1)))
    C = s4[:, :36].reshape(B, 6, 6)
    b = -s4[:, 36:42]
    e2 = s4[:, 42]
    tr = C[:, 0, 0]
    for k in range(1, 6):
        tr = tr + C[:, k, k]
    tr = tr[:, None, None]
    C = C + torch.eye(6, dtype=C.dtype, device=C.device)[None] \
        * (1e-6 * tr / 6.0 + 1e-20)
    x, info = torch.linalg.solve_ex(C, b[..., None])
    x = x[..., 0]
    x = torch.where(torch.isfinite(x) & (info == 0)[:, None], x, 0.0)

    new_err = torch.sqrt(e2 / wsafe)
    Rx = _rotation_xyz(x[:, 0], x[:, 1], x[:, 2])
    tx = x[:, 3:6]
    upd = torch.zeros((B, 4, 4), dtype=torch.float32, device=T.device)
    upd[:, :3, :3] = Rx
    upd[:, :3, 3] = c1 + tx - torch.einsum("bij,bj->bi", Rx, c1)
    upd[:, 3, 3] = 1.0

    do_update = active & has_corrs
    T_new = torch.where(do_update[:, None, None], small_matmul(upd, T), T)
    err_new = torch.where(do_update, new_err, err)
    converged = (it > config.ICP_CONVERGE_MIN_ITER) & \
        ((err - err_new).abs() < config.ICP_CONVERGE_DELTA)
    return T_new, err_new, active & has_corrs & ~converged


def icp_align_indexed(uobj_pts: torch.Tensor, uobj_nrm: torch.Tensor,
                      uobj_mask: torch.Tensor, obj_of_pair: torch.Tensor,
                      pair_valid: torch.Tensor, index: gnn.SortedSlab,
                      T_init: torch.Tensor, max_dist, max_angle,
                      max_iter: int = config.ICP_MAX_ITER, allsum=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 int]:
    """Refine B rigid transforms against the scene ``index``.

    uobj_pts/uobj_nrm: (O, N, 3) per-object padded points (pad_batch over
    the unique objects); uobj_mask: (O, N); obj_of_pair: (B,) row of each
    pair's object; pair_valid: (B,) False rows start inactive; T_init:
    (B, 4, 4). All on the index's device. ``allsum``: the cross-shard
    sum of the sp mode (see ``_icp_step``); the all-padding start mask
    goes through it too, so every shard starts and stops alike.

    Returns (T, err, active, n_iter): refined transforms, final
    point-to-plane errors, the pairs still active when the loop stopped,
    and the number of iterations run.
    """
    own = obj_of_pair.long()
    obj_pts = uobj_pts[own]
    obj_nrm = uobj_nrm[own]
    obj_mask = uobj_mask[own] & pair_valid[:, None]
    B = obj_pts.shape[0]
    cos_gate = cos_gate_of(max_angle)
    scene_pts, scene_nrm = search.index_arrays(index)
    T = T_init.to(torch.float32)
    err = torch.full((B,), 1e6, dtype=torch.float32, device=T.device)
    dist = np.float32(max_dist)
    # all-padding rows start inactive
    (n_pts,) = (allsum or _no_sum)(obj_mask.sum(1))
    active = n_pts > 0
    it = 0
    while it < max_iter and bool(active.any()):
        T, err, active = _icp_step(obj_pts, obj_nrm, obj_mask, index,
                                   scene_pts, scene_nrm, T, err, dist,
                                   active, it, cos_gate, allsum=allsum)
        dist = np.maximum(np.float32(dist * np.float32(config.ICP_DIST_ANNEAL)),
                          np.float32(config.ICP_DIST_FLOOR))
        it += 1
    return T, err, active, it


def icp_align_batched(obj_pts: torch.Tensor, obj_nrm: torch.Tensor,
                      obj_mask: torch.Tensor, index: gnn.SortedSlab,
                      T_init: torch.Tensor, max_dist, max_angle,
                      max_iter: int = config.ICP_MAX_ITER
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """icp_align_indexed with one object row per pair: (T, err)."""
    B = obj_pts.shape[0]
    own = torch.arange(B, device=obj_pts.device)
    valid = torch.ones(B, dtype=torch.bool, device=obj_pts.device)
    T, err, _, _ = icp_align_indexed(obj_pts, obj_nrm, obj_mask, own, valid,
                                     index, T_init, max_dist, max_angle,
                                     max_iter=max_iter)
    return T, err


def prep_unique_batch(list_of_pts, list_of_nrm, n_min: int = 1):
    """pad_batch over UNIQUE objects, with the row axis padded to a power
    of two (>= 8). Padding rows are FAR points with empty masks —
    selectable only by invalid pairs, which start inactive."""
    pts, nrm, mask = pad_batch(list_of_pts, list_of_nrm, n_min=n_min)
    O, Np = mask.shape
    Op = max(1 << int(np.ceil(np.log2(max(O, 1)))), 8)
    if Op != O:
        pts = np.concatenate(
            [pts, np.full((Op - O, Np, 3), gnn.FAR, np.float32)])
        nrm = np.concatenate([nrm, np.zeros((Op - O, Np, 3), np.float32)])
        mask = np.concatenate([mask, np.zeros((Op - O, Np), bool)])
    return pts, nrm, mask


def pad_batch(list_of_pts, list_of_nrm, n_min: int = 1):
    """Pad a ragged list of (n_i, 3) arrays to (B, N_pad, 3) + mask.

    N_pad is the power of two covering the largest pair (>= 128, >=
    n_min). Each pair's points are Morton-sorted (tight kernel query
    blocks), padded replicate-last up to the next query-block boundary,
    then FAR beyond, so whole padding blocks are near no scene tile.
    """
    B = len(list_of_pts)
    n_max = max([len(p) for p in list_of_pts] + [n_min, 1])
    n_pad = max(1 << int(np.ceil(np.log2(n_max))), 128)
    bq = _block_for(n_pad)
    n_pad = max(n_pad, bq)
    pts = np.full((B, n_pad, 3), gnn.FAR, np.float32)
    nrm = np.zeros((B, n_pad, 3), np.float32)
    mask = np.zeros((B, n_pad), bool)
    for i, (p, n) in enumerate(zip(list_of_pts, list_of_nrm)):
        k = len(p)
        if k:
            order = gnn.morton_order(p)
            p = np.asarray(p, np.float32)[order]
            n = np.asarray(n, np.float32)[order]
        pts[i, :k] = p
        nrm[i, :k] = n
        mask[i, :k] = True
        edge = min(((k + bq - 1) // bq) * bq, n_pad)
        if k and edge > k:
            pts[i, k:edge] = p[k - 1]
            nrm[i, k:edge] = n[k - 1]
    return pts, nrm, mask


def _block_for(n_run: int) -> int:
    """The reference's replicate-padding granule for runs of ``n_run``
    points (pallas_nn.block_for), kept so padded batches equal the JAX
    package's."""
    if n_run <= 512:
        return 128
    if n_run <= 2048:
        return 256
    return 512
