"""Label transfer from placed objects and label smoothing — the port of
rescan_tpu/ops/labels.py.

Label transfer mirrors rspf_arrangement_to_labels
(lib/rs/rs_pointcloud_filters.cpp:780-879): placements sorted dynamic-
first (by (is_static << 10 | class_idx)); each placement claims the scene
points whose inverse-transformed position has its nearest object point
within the radius AND whose normal is within 70 degrees of that point's
(|dot|); the closest claim wins through a running min-distance; the
static pass runs at 1.5x radius without resetting the distances.

Smoothing runs over the reference's unary + weighted-Potts energy with
one of three engines: ``abswap`` (the default, the reference's gco
alpha-beta swap move space) and ``native`` (mean-field + masked ICM) in
the shared C++ library, or ``torch`` — the same mean-field + masked ICM
in torch ops on the device, the counterpart of the JAX package's ``jax``
engine (that name selects it here too).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import config, resolve_device
from ..core import native
from ..io.rsdb import Placement, Rsdb
from ..parallel import mesh as pmesh
from ..utils import timing
from . import gnn, hashgrid, search


def _static_sort_key(db: Rsdb, p: Placement) -> int:
    """rsfp__static_plcmnt_cmp (rs_pointcloud_filters.cpp:724-736):
    ascending (is_static << 10 | class_idx), stable."""
    return (int(db.is_object_static(p.object_idx)) << 10) | \
        db.objects[p.object_idx].class_idx


def arrangement_to_labels(db: Rsdb, scene, arrangement: Sequence[Placement],
                          radius: float = config.LABEL_TRANSFER_RADIUS,
                          prioritize_static: bool = False,
                          device=None, mesh=None) -> None:
    """Write class/instance ids into scene level 1 from the arrangement.

    Per placement, one K2 query (ops/gnn.py ``nearest_gated`` with |dot|
    and cos_gate -1, so every in-radius neighbour passes) of the
    bbox-filtered scene points against the object's slab, built once per
    object on ``device``. The 70-degree gate is applied after, to the
    nearest neighbour's |dot| — nearest-THEN-gate, as the reference does
    (:758-771). All placements launch before the first result is read;
    the merge reads them in placement order.

    ``mesh``: a parallel.mesh.Mesh — each launch's queries, padded with
    far sentinels to one power-of-two bucket for all placements (as the
    JAX package pads them), split over the mesh's slots when the bucket
    divides by the slot count (parallel.mesh.nearest_gated_sharded). The
    1-NN is per query, so the labels are the single-device ones."""
    dev = resolve_device(device)
    lvl = config.LABEL_LVL
    pts = scene.pos(lvl)
    nrm = scene.nrm(lvl)
    n = len(pts)
    labels = np.zeros(n, np.int32)
    min_d2 = np.full(n, 1e9, np.float32)

    order = sorted(range(len(arrangement)),
                   key=lambda i: _static_sort_key(db, arrangement[i]))
    sorted_arr = [arrangement[i] for i in order]
    first_static = 0
    for i, p in enumerate(sorted_arr):
        if db.is_object_static(p.object_idx):
            first_static = i
            break
    # quirk preserved: if no placement is static, first_static stays 0 and
    # the "static" pass (1.5x radius) covers the whole arrangement
    # (rs_pointcloud_filters.cpp:830-848)

    cos_gate = np.cos(np.deg2rad(config.LABEL_TRANSFER_MAX_ANGLE_DEG))
    max_r = config.LABEL_TRANSFER_STATIC_RADIUS_SCALE * radius
    index_cache = {}

    def obj_index(obj_idx: int) -> search.Index:
        e = index_cache.get(obj_idx)
        if e is None:
            obj = db.objects[obj_idx].cloud
            e = search.build_index(obj.pos(lvl), max_r,
                                   normals=obj.nrm(lvl), device=dev)
            index_cache[obj_idx] = e
        return e

    r2 = (radius if prioritize_static
          else config.LABEL_TRANSFER_STATIC_RADIUS_SCALE * radius)

    plans = []
    for i, p in enumerate(sorted_arr):
        r = radius if i < first_static else r2
        obj = db.objects[p.object_idx].cloud
        inv = np.linalg.inv(p.pose.astype(np.float64)).astype(np.float32)
        q = pts @ inv[:3, :3].T + inv[:3, 3]
        # normal "matrix" is the TRANSPOSE of the pose
        # (rs_pointcloud_filters.cpp:751): R^T = R^-1 for rigid poses
        qn = nrm @ p.pose[:3, :3].astype(np.float32)
        # bbox prefilter: only scene points near the object can match
        bmin = obj.pos(lvl).min(axis=0) - r
        bmax = obj.pos(lvl).max(axis=0) + r
        cand = np.where(((q >= bmin) & (q <= bmax)).all(axis=1))[0]
        plans.append((i, r, cand, q[cand], qn[cand]))
    max_cand = max((len(c) for _, _, c, _, _ in plans), default=0)
    mp = max(1 << int(np.ceil(np.log2(max(max_cand, 1)))), 256)
    sharded = mesh is not None and mp % mesh.size == 0

    def submit(start: int, end: int):
        pend = []
        for i, r, cand, qc, qnc in plans[start:end]:
            m = len(cand)
            if m == 0:
                continue
            index = obj_index(sorted_arr[i].object_idx)
            if sharded:
                qp = np.full((mp, 3), gnn.FAR, np.float32)
                qp[:m] = qc
                qnp = np.zeros((mp, 3), np.float32)
                qnp[:m] = qnc
                res = pmesh.nearest_gated_sharded(mesh, index, qp, qnp, r,
                                                  -1.0, use_abs_dot=True)
            else:
                res = search.nearest_gated(
                    index, timing.to_device(
                        torch.from_numpy(np.ascontiguousarray(qc)), dev),
                    timing.to_device(
                        torch.from_numpy(np.ascontiguousarray(qnc)), dev),
                    r, -1.0, use_abs_dot=True)
            pend.append((i, cand, res))
        return pend

    def merge(pend):
        for i, cand, res in pend:
            idx, d2, dot = mesh.gather(res) if sharded else res
            m = len(cand)
            idx = timing.to_host(idx[:m])
            nd2 = timing.to_host(d2[:m])
            dot = timing.to_host(dot[:m])
            hit = idx >= 0
            ci, nd2, dot = cand[hit], nd2[hit], dot[hit]
            better = nd2 < min_d2[ci]
            ci, nd2, dot = ci[better], nd2[better], dot[better]
            ok = dot > cos_gate  # angle < 70 deg
            ci, nd2 = ci[ok], nd2[ok]
            min_d2[ci] = nd2
            labels[ci] = i + 1

    merge(submit(0, first_static))
    if prioritize_static:
        min_d2[:] = 1e9
    merge(submit(first_static, len(sorted_arr)))

    unlabelled_idx = db.class_idx("unlabelled")
    cls = np.full(n, unlabelled_idx, np.int32)
    ins = np.full(n, config.MAX_INSTANCES, np.int32)
    for i, p in enumerate(sorted_arr):
        sel = labels == (i + 1)
        cls[sel] = db.objects[p.object_idx].class_idx
        ins[sel] = p.uidx
    scene.levels[lvl]["class_ids"] = cls
    scene.levels[lvl]["instance_ids"] = ins


def build_smoothing_graph(scene, device=None) -> Tuple[np.ndarray,
                                                     np.ndarray]:
    """8-NN 0.05-radius edge graph with the reference's edge weights
    (rspf_compute_neighborhood, rs_pointcloud_filters.cpp:674-722).
    Returns (edges (E,2) int32 deduped unordered pairs, weights (E,)).

    The radius search is the JAX package's CPU branch (labels.py:224-233),
    ``hashgrid.radius_knn`` over a grid of the level-1 points, here on
    ``device`` (its kernel on the card); the skip-self, dedup and weight
    pass stays in the native host library, as there."""
    dev = resolve_device(device)
    lvl = config.LABEL_LVL
    pts = scene.pos(lvl)
    nrm = scene.nrm(lvl)
    r = config.SMOOTH_RADIUS
    grid = hashgrid.build_grid(pts, r, device=dev)
    idx, d2, _ = hashgrid.radius_knn(
        grid, timing.to_device(
            torch.from_numpy(np.ascontiguousarray(pts, np.float32)), dev),
        r, config.SMOOTH_MAX_NN, chunk=16384)
    return native.smooth_graph(timing.to_host(idx), timing.to_host(d2), nrm,
                               np.float32(r * r), config.SMOOTH_DIST_EXP,
                               config.SMOOTH_ANGLE_EXP)


def smooth_labels(db: Rsdb, scene, n_meanfield: int = 30,
                  n_icm: int = 8, engine: str | None = None,
                  device=None) -> None:
    """Smoothing of level-1 instance labels over the reference's unary +
    weighted-Potts energy (rspf_smooth_labels,
    rs_pointcloud_filters.cpp:882-989) with the engine ``abswap``
    (default; env RESCAN_SMOOTH_ENGINE overrides), ``native`` or
    ``torch`` (alias ``jax``). ``device`` runs the graph's radius search
    (``build_smoothing_graph``) and the torch engine."""
    engine = engine or os.environ.get("RESCAN_SMOOTH_ENGINE", "abswap")
    if engine not in ENGINES:
        raise ValueError(f"unknown smoothing engine {engine!r}; use one of "
                         f"{sorted(ENGINES)}")

    lvl = config.LABEL_LVL
    L = scene.levels[lvl]
    n = len(L["class_ids"])
    inst = L["instance_ids"]
    cls = L["class_ids"]
    unlabelled_idx = db.class_idx("unlabelled")

    valid_inst = inst[inst < config.MAX_INSTANCES]
    max_uidx = int(valid_inst.max()) if len(valid_inst) else -1
    n_labels = max_uidx + 5
    if n_labels < 2:
        return
    # the label axis padded to a multiple of 8, as the reference package
    # does (it changes the energy's label set, so it is kept)
    n_labels = ((n_labels + 7) // 8) * 8

    labels0 = np.where(cls == unlabelled_idx, 0, inst + 1).astype(np.int32)
    labels0 = np.clip(labels0, 0, n_labels - 1)
    # label -> (class, instance) maps built like the reference (last point
    # of each label wins, :908-917)
    label_to_class = np.full(n_labels, unlabelled_idx, np.int32)
    label_to_inst = np.full(n_labels, config.MAX_INSTANCES, np.int32)
    label_to_class[labels0] = cls
    label_to_inst[labels0] = inst

    # unary: 0 for own label, else 30/15/1 by the point's label class
    is_static = np.array([db.is_class_static(int(c))
                          for c in label_to_class])
    cost_of_point = np.where(is_static[labels0],
                             config.SMOOTH_COST_STATIC,
                             config.SMOOTH_COST_DYNAMIC)
    cost_of_point = np.where(labels0 == 0, config.SMOOTH_COST_UNLABELLED,
                             cost_of_point).astype(np.float32)

    edges, w = build_smoothing_graph(scene, device)
    # gco receives int(w * edge_cost) as the neighbor weight, multiplied by
    # the Potts table value edge_cost (:942-966)
    pair_w = (np.floor(w * config.SMOOTH_EDGE_COST).astype(np.float32)
              * config.SMOOTH_EDGE_COST)

    if ENGINES[engine] == "abswap":
        off, nbr, w2 = native.csr_from_edges(edges[:, 0], edges[:, 1],
                                             pair_w, n)
        labels = native.abswap(
            cost_of_point[:, None]
            * (1.0 - np.eye(n_labels, dtype=np.float32)[labels0]),
            off, nbr, w2, labels0, n_cycles=2)
    else:
        # ICM masks drawn over the pow2-padded point count, so the rng
        # stream is the reference package's
        n_pad = max(1 << int(np.ceil(np.log2(max(n, 1)))), 1024)
        rng = np.random.default_rng(config.SA_SEED)
        icm_masks = (rng.random((n_icm, n_pad)) < 0.5)[:, :n]
        if ENGINES[engine] == "torch":
            off, nbr, w2 = native.csr_from_edges(edges[:, 0], edges[:, 1],
                                                 pair_w, n)
            labels = meanfield_icm_torch(cost_of_point, labels0, n_labels,
                                         off, nbr, w2, n_meanfield,
                                         icm_masks, resolve_device(device))
        else:
            labels = _meanfield_icm_native(scene, cost_of_point, labels0,
                                           n_labels, edges, pair_w,
                                           n_meanfield, icm_masks)
    L["class_ids"] = label_to_class[labels].astype(np.int32)
    L["instance_ids"] = label_to_inst[labels].astype(np.int32)


def potts_energy(U: np.ndarray, edges: np.ndarray, pair_w: np.ndarray,
                 labels: np.ndarray) -> float:
    """E(l) = sum_i U[i, l_i] + sum_(ij) w_ij [l_i != l_j] over the
    undirected edge list — the objective every smoothing engine optimizes
    (integer-valued by construction; used for engine comparison)."""
    unary = float(U[np.arange(len(labels)), labels].sum())
    cut = float(pair_w[labels[edges[:, 0]] != labels[edges[:, 1]]].sum())
    return unary + cut


# engine name -> implementation; "jax" names the torch engine, so
# RESCAN_SMOOTH_ENGINE means the same in both packages
ENGINES = {"abswap": "abswap", "native": "native", "torch": "torch",
           "jax": "torch"}


def _meanfield_icm_native(scene, cost_of_point, labels0, n_labels, edges,
                          pair_w, n_meanfield, icm_masks) -> np.ndarray:
    n = len(labels0)
    # nodes renumbered along a Morton curve for cache-resident CSR
    # neighbour rows
    perm = gnn.morton_order(scene.pos(config.LABEL_LVL), cell=0.1)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    lab_s = labels0[perm]
    onehot = np.zeros((n, n_labels), np.float32)
    onehot[np.arange(n), lab_s] = 1.0
    U = cost_of_point[perm, None] * (1.0 - onehot)
    off, nbr, w2 = native.csr_from_edges(
        inv[edges[:, 0]], inv[edges[:, 1]], pair_w, n)
    labels_s = native.meanfield_icm(U, off, nbr, w2, n_meanfield, 0.25,
                                    onehot, icm_masks[:, perm])
    labels = np.empty(n, np.int32)
    labels[perm] = labels_s
    return labels


# elements per gathered (rows, neighbours, labels) block of the torch
# engine's neighbour sums: bounds its scratch at 128 MB of f32
_NBR_BLOCK = 1 << 25


def meanfield_icm_torch(cost_of_point: np.ndarray, labels0: np.ndarray,
                        n_labels: int, off: np.ndarray, nbr: np.ndarray,
                        w2: np.ndarray, n_meanfield: int,
                        icm_masks: np.ndarray, device) -> np.ndarray:
    """Damped mean-field then masked ICM over the Potts MRF, in torch ops
    on ``device`` — the JAX package's ``jax`` engine (labels.py:359-397,
    ``_meanfield_impl`` :409, ``_icm_step_impl`` :433).

    U = cost * (1 - onehot(own label)), Q0 = onehot(own label); each
    mean-field step sets E = U + (sum_j w_ij - sum_j w_ij Q_j) and
    Q <- 0.5 Q + 0.5 softmax(-E / 4); labels = argmax Q; each ICM step
    sets the masked nodes to argmin of the same E over the neighbours'
    one-hot labels. Ties go to the first label in both.

    The JAX engine's scatter-adds over the edge list become neighbour
    sums over the CSR adjacency (both directions of every edge) laid out
    as a padded (n, max degree) table: row i holds i's neighbours in CSR
    order, padded with i itself at weight 0, and each sum is a reduction
    along one row — the same order on every run, with no atomics. The
    JAX engine's padding nodes have no edges, so the engine runs on the
    n real nodes; the ICM masks are the padded draw sliced to n."""
    dev = torch.device(device)
    n = len(labels0)
    deg = np.diff(off)
    D = max(int(deg.max()) if n else 0, 1)
    cols = np.arange(D)
    has = cols[None, :] < deg[:, None]
    at = np.minimum(off[:-1, None] + cols[None, :], max(len(nbr) - 1, 0))
    rows = np.arange(n)[:, None]
    nb = np.where(has, nbr[at] if len(nbr) else rows, rows)
    wt = np.where(has, w2[at] if len(w2) else 0.0, 0.0).astype(np.float32)
    nb = timing.to_device(torch.from_numpy(nb.astype(np.int64)), dev)
    wt = timing.to_device(torch.from_numpy(wt), dev)
    block = max(1, _NBR_BLOCK // (D * n_labels))

    def nbr_sum(X: torch.Tensor) -> torch.Tensor:
        """sum_k wt[i, k] * X[nb[i, k]] for every node i."""
        return torch.cat([(wt[s:s + block, :, None] * X[nb[s:s + block]])
                          .sum(1) for s in range(0, n, block)])

    own = timing.to_device(torch.from_numpy(labels0.astype(np.int64)), dev)
    Q = torch.nn.functional.one_hot(own, n_labels).to(torch.float32)
    U = timing.to_device(torch.from_numpy(cost_of_point), dev)[:, None] \
        * (1.0 - Q)
    wsum = wt.sum(1)[:, None]
    for _ in range(n_meanfield):
        E = U + (wsum - nbr_sum(Q))
        Q = 0.5 * Q + 0.5 * torch.softmax(-E / 4.0, dim=1)
    lab = torch.argmax(Q, dim=1)
    masks = timing.to_device(
        torch.from_numpy(np.ascontiguousarray(icm_masks)), dev)
    for k in range(len(masks)):
        oh = torch.nn.functional.one_hot(lab, n_labels).to(torch.float32)
        E = U + (wsum - nbr_sum(oh))
        lab = torch.where(masks[k], torch.argmin(E, dim=1), lab)
    return timing.to_host(lab.to(torch.int32))
