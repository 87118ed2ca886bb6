"""pose_proposal — multiresolution grid search for object pose candidates;
the port of rescan_tpu/pipeline/pose_proposal.py.

CLI-compatible with the reference binary (apps/pose_proposal/main.cpp):

    python -m rescan_tpu_torch.pipeline.pose_proposal \
        <rsdb_filename> <scene_filename> <output_filename> [-v] [--device D]

Same stage flow and ``timings`` keys as the JAX stage (spans of the
stage's trace, utils/timing.py, beside the port's own): scene ingest, the
level-1 scene slab and the exact occupancy prune, the level-4 grid
search over the (x, z, theta) lattice of every dynamic object, level-3/2
verification, NMS, batched ICP of every (object, proposal) pair, the
level-1 rescore, and the final NMS and sort. Scoring goes through
ops/score.py (kernel K1), the ICP through ops/icp.py (kernel K2). With
more than one device (by default every visible card), every scoring
launch splits its hypotheses and the ICP its pairs over the mesh
(parallel/mesh.py), as the JAX stage does.
"""

from __future__ import annotations

import argparse
import contextvars
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

from .. import config
from ..core import database
from ..core.pointcloud import PointCloud
from ..io import paths, rsdb as rsdbio
from ..ops import icp, score, search, voxel
from ..parallel import mesh as pmesh
from ..utils import timing


class SceneOccupancy:
    """Dilated boolean occupancy of the scene for EXACT hypothesis pruning.

    A hypothesis's alignment score is a mean of per-point contributions in
    [0, 1] where a point contributes 0 whenever no scene point lies within
    the search radius. The fraction of object points whose cell falls in
    the (conservatively dilated) occupancy is therefore an upper bound on
    the score; hypotheses whose bound is below the level's threshold can
    be dropped WITHOUT changing the reference semantics — they could never
    pass the `score > threshold` test nor become a surviving per-cell best.
    """

    N_NORMAL_BINS = 64

    def __init__(self, scene_pts: np.ndarray, radius: float,
                 voxel: float = 0.05, scene_nrm: np.ndarray | None = None,
                 gate_deg: float = config.SCORE_MAX_ANGLE_DEG):
        self.voxel = voxel
        self.origin = scene_pts.min(axis=0).astype(np.float32) - 4 * voxel
        res = (np.ceil((scene_pts.max(axis=0) - self.origin) / voxel)
               .astype(np.int64) + 8)
        c = np.floor((scene_pts - self.origin) / voxel).astype(np.int64)
        occ = np.zeros(tuple(res), bool)
        occ[c[:, 0], c[:, 1], c[:, 2]] = True
        # normal-aware masks: each occupied cell records which normal-
        # direction bins its scene points fall in; a transformed object
        # point can only score if its rotated normal is gate-compatible
        # with SOME bin present near its cell. This kills poses floating
        # in empty space whose only nearby surface is the floor (bottom
        # and side normals of furniture can never pass the 35-degree
        # max(dot, 0) gate against up-facing floor normals).
        self.bin_dirs = self._fibonacci_dirs(self.N_NORMAL_BINS)
        masks = None
        if scene_nrm is not None:
            bins = np.argmax(scene_nrm @ self.bin_dirs.T, axis=1)
            masks = np.zeros(tuple(res), np.uint64)
            # scatter-OR via sort + reduceat (np.bitwise_or.at is ~100x
            # slower: 2.5 s for a 300k-point level on this host)
            flat = (c[:, 0] * res[1] + c[:, 1]) * res[2] + c[:, 2]
            order = np.argsort(flat)
            fs = flat[order]
            vs = (np.uint64(1) << bins.astype(np.uint64))[order]
            starts = np.concatenate(
                [[0], np.flatnonzero(fs[1:] != fs[:-1]) + 1])
            masks.reshape(-1)[fs[starts]] = np.bitwise_or.reduceat(vs,
                                                                   starts)
            # compat table: bin b of a query normal is compatible with
            # scene bin s iff the gate could pass for SOME pair of vectors
            # in the two bins: angle(center_b, center_s) <= gate +
            # cover_b + cover_s, using per-bin exact cover angles (the
            # global worst-case cover doubles the slack and lets side
            # normals stay "compatible" with the floor)
            covers = self._cover_angles(self.bin_dirs)
            ang = np.arccos(np.clip(self.bin_dirs @ self.bin_dirs.T,
                                    -1.0, 1.0))
            cc2 = ang <= (np.deg2rad(gate_deg)
                          + covers[:, None] + covers[None, :])
            self.compat = np.zeros(self.N_NORMAL_BINS, np.uint64)
            for b in range(self.N_NORMAL_BINS):
                self.compat[b] = np.uint64(
                    np.bitwise_or.reduce((np.uint64(1)
                                          << np.where(cc2[b])[0]
                                          .astype(np.uint64))))
        # conservative box dilation: covers radius + cell diagonal
        n_dil = int(np.ceil(radius / voxel)) + 1
        for _ in range(n_dil):
            d = occ.copy()
            d[1:] |= occ[:-1]
            d[:-1] |= occ[1:]
            d[:, 1:] |= occ[:, :-1]
            d[:, :-1] |= occ[:, 1:]
            d[:, :, 1:] |= occ[:, :, :-1]
            d[:, :, :-1] |= occ[:, :, 1:]
            occ = d
            if masks is not None:
                m = masks.copy()
                m[1:] |= masks[:-1]
                m[:-1] |= masks[1:]
                m[:, 1:] |= masks[:, :-1]
                m[:, :-1] |= masks[:, 1:]
                m[:, :, 1:] |= masks[:, :, :-1]
                m[:, :, :-1] |= masks[:, :, 1:]
                masks = m
        self.occ = occ
        self.masks = masks
        self.res = np.asarray(occ.shape)
        # flat views for fast fancy indexing in score_upper_bound
        self._occ_flat = occ.reshape(-1)
        self._masks_flat = masks.reshape(-1) if masks is not None else None

    @staticmethod
    def _fibonacci_dirs(n: int) -> np.ndarray:
        i = np.arange(n, dtype=np.float64) + 0.5
        phi = np.arccos(1.0 - 2.0 * i / n)
        theta = np.pi * (1.0 + np.sqrt(5.0)) * i
        return np.stack([np.cos(theta) * np.sin(phi),
                         np.sin(theta) * np.sin(phi),
                         np.cos(phi)], axis=1).astype(np.float32)

    @staticmethod
    def _cover_angles(dirs: np.ndarray, n_samples: int = 16384
                      ) -> np.ndarray:
        """Per-bin max angle from any unit vector assigned to the bin
        (by argmax of dot) to the bin's center."""
        s = SceneOccupancy._fibonacci_dirs(n_samples)
        dots = s @ dirs.T
        assign = np.argmax(dots, axis=1)
        worst = np.ones(len(dirs))
        np.minimum.at(worst, assign, dots[np.arange(len(s)), assign])
        return np.arccos(np.clip(worst, -1.0, 1.0))

    def score_upper_bound(self, obj_pts: np.ndarray, hyps: np.ndarray,
                          obj_nrm: np.ndarray | None = None) -> np.ndarray:
        """(H,) upper bound on the alignment score per pose: fraction of
        object points whose cell is near scene geometry (and, when normals
        are available, whose rotated normal is gate-compatible with the
        normals present around that cell)."""
        H = len(hyps)
        out = np.empty(H, np.float32)
        R = hyps[:, :3, :3]
        t = hyps[:, :3, 3]
        use_nrm = obj_nrm is not None and self.masks is not None
        r0, r1, r2 = (int(x) for x in self.res)

        # hypotheses come from a lattice with few unique rotations: group
        # by rotation so points/normals are rotated once per angle
        key = np.round(R.reshape(H, 9), 5)
        _, grp_idx, grp_inv = np.unique(key, axis=0, return_index=True,
                                        return_inverse=True)
        block = max(1, 4_000_000 // max(len(obj_pts), 1))
        inv_vox = np.float32(1.0 / self.voxel)
        n_flat = r0 * r1 * r2
        for g, hrep in enumerate(grp_idx):
            sel = np.where(grp_inv == g)[0]
            rp = (obj_pts @ R[hrep].T - self.origin) * inv_vox   # (P, 3)
            if use_nrm:
                rn = obj_nrm @ R[hrep].T
                qbin = np.argmax(rn @ self.bin_dirs.T, axis=1)
                req = self.compat[qbin]                          # (P,) u64
            for lo in range(0, len(sel), block):
                hh = sel[lo:lo + block]
                tv = t[hh] * inv_vox                             # (B, 3)
                # int32 cells; out-of-range detected on the FLAT index via
                # the unsigned-compare trick (negative floors go huge)
                c0 = np.floor(rp[None, :, 0] + tv[:, 0:1]).astype(np.int32)
                c1 = np.floor(rp[None, :, 1] + tv[:, 1:2]).astype(np.int32)
                c2 = np.floor(rp[None, :, 2] + tv[:, 2:3]).astype(np.int32)
                inb = ((c0.view(np.uint32) < r0) & (c1.view(np.uint32) < r1)
                       & (c2.view(np.uint32) < r2))
                flat = (c0 * np.int32(r1) + c1) * np.int32(r2) + c2
                flat = np.where(inb, flat, 0)
                if use_nrm:
                    near = (((self._masks_flat[flat] & req[None, :]) != 0)
                            & inb)
                else:
                    near = self._occ_flat[flat] & inb
                out[hh] = near.mean(axis=1)
        return out


def _select_cell_best(s4: np.ndarray, cell_of_hyp: np.ndarray,
                      thr: float) -> np.ndarray:
    """Vectorized per-cell best-angle selection (pose_proposal.cpp:238-243):
    the highest-scoring hypothesis of each lattice cell survives if its
    score exceeds the threshold; ties keep the earliest hypothesis.
    Returns surviving hypothesis indices ordered by cell id."""
    if len(s4) == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort((np.arange(len(s4)), -s4, cell_of_hyp))
    cells_sorted = cell_of_hyp[order]
    first = np.ones(len(order), bool)
    first[1:] = cells_sorted[1:] != cells_sorted[:-1]
    best_h = order[first]
    return best_h[s4[best_h] > thr]


def grid_search_all_objects(db: rsdbio.Rsdb, scene_grid, scene_bbox,
                            occupancy: "SceneOccupancy | None",
                            verbose: bool = False, mesh=None
                            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Coarse-to-fine grid search for every dynamic object, level-major:
    the occupancy prune runs threaded across objects, then each level's
    scoring for ALL objects shares one launch stream (sharded over
    ``mesh`` when given). Returns per-object (poses (K,4,4), scores
    (K,))."""
    lvl = config.GRID_SEARCH_LEVELS[0]
    hyps, cell_of_hyp, _ = score.grid_search_hypotheses(
        scene_bbox[0], scene_bbox[1])
    radius = sigma = config.SCORE_SEARCH_RADII[config.SCORE_SEARCH_LVL]

    dyn = [i for i in range(len(db.objects)) if not db.is_object_static(i)]
    results: List[Tuple[np.ndarray, np.ndarray]] = \
        [(np.zeros((0, 4, 4), np.float32), np.zeros(0, np.float32))
         for _ in db.objects]
    if not dyn:
        return results

    # --- level 4: occupancy prune (host) interleaved with scoring
    # dispatch — each object's hypotheses launch while the NEXT object
    # prunes (ScoreStream launches full slices at once; the prune is
    # host numpy, the scoring is device, so they overlap) ---
    with timing.span("gs_prune_dispatch") as dispatch:
        prepped = {(i, lvl): score.prep_points(db.objects[i].cloud.pos(lvl),
                                               db.objects[i].cloud.nrm(lvl))
                   for i in dyn}
        stream = score.ScoreStream(scene_grid, radius, sigma, mesh=mesh)
        alive = {}
        req_of = {}
        for i in dyn:
            if occupancy is not None:
                obj = db.objects[i].cloud
                ub = occupancy.score_upper_bound(obj.pos(lvl), hyps,
                                                 obj_nrm=obj.nrm(lvl))
                alive[i] = np.where(ub >= config.SCORE_THRESHOLDS[lvl])[0]
            else:
                alive[i] = np.arange(len(hyps))
            req_of[i] = stream.submit(None, None, hyps[alive[i]],
                                      prepped=prepped[(i, lvl)])
    if verbose:
        for i in dyn:
            print(f"POSE_PROPOSAL:         occupancy prune kept "
                  f"{len(alive[i])}/{len(hyps)} hypotheses "
                  f"({db.class_name(db.objects[i].class_idx)}."
                  f"{db.objects[i].uidx:03d})")
        print(f"PROFILE:   prune+dispatch {dispatch.seconds:.2f}s")
    with timing.span("gs_l4_collect") as collect:
        lvl4_scores = stream.collect()

    poses_of, scores_of = {}, {}
    thr = config.SCORE_THRESHOLDS[lvl]
    for i in dyn:
        s4 = np.zeros(len(hyps), np.float32)
        s4[alive[i]] = lvl4_scores[req_of[i]]
        keep = _select_cell_best(s4, cell_of_hyp, thr)
        poses_of[i] = hyps[keep]
        scores_of[i] = s4[keep].astype(np.float32)
        if verbose:
            print(f"POSE_PROPOSAL:         --> Found {len(keep)} potential "
                  f"poses for object {i}. "
                  f"(Max score: {s4.max() if len(s4) else -1e9:f})")
    if verbose:
        print(f"PROFILE:   level-4 prune+score "
              f"{dispatch.seconds + collect.seconds:.2f}s")

    # --- levels 3, 2: rescore still-valid poses of ALL objects together,
    # mark below-threshold as -1; -1 entries are carried along (they
    # survive the final copy's |score| > 1e-6 filter, mgs_propose_poses
    # :348-359, and die in NMS via its score < 0.01 rule) ---
    for vlvl in config.GRID_SEARCH_LEVELS[1:]:
        with timing.span(f"gs_l{vlvl}_rescore") as rescore:
            stream = score.ScoreStream(scene_grid, radius, sigma, mesh=mesh)
            submitted = []
            for i in dyn:
                valid = scores_of[i] > 0.0
                if not valid.any():
                    continue
                key = (i, vlvl)
                if key not in prepped:
                    prepped[key] = score.prep_points(
                        db.objects[i].cloud.pos(vlvl),
                        db.objects[i].cloud.nrm(vlvl))
                stream.submit(None, None, poses_of[i][valid],
                              prepped=prepped[key])
                submitted.append((i, valid))
            rescored = stream.collect()
        thr = config.SCORE_THRESHOLDS[vlvl]
        for (i, valid), sv in zip(submitted, rescored):
            scores_of[i][valid] = np.where(sv > thr, sv,
                                           -1.0).astype(np.float32)
        if verbose:
            for i in dyn:
                print(f"POSE_PROPOSAL:         --> Level {vlvl}: "
                      f"{int((scores_of[i] > 0).sum())} poses (object {i})")
            print(f"PROFILE:   level-{vlvl} rescoring "
                  f"{rescore.seconds:.2f}s")

    for i in dyn:
        aliveM = (np.abs(scores_of[i]) > 1e-6 if len(poses_of[i])
                  else np.zeros(0, bool))
        results[i] = (poses_of[i][aliveM], scores_of[i][aliveM])
    return results


def propose_poses_for_object(obj: PointCloud, scene_grid, scene_bbox,
                             verbose: bool = False,
                             occupancy: "SceneOccupancy | None" = None,
                             mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """The grid search of one object (the JAX package's test and dry-run
    entry point), through ``grid_search_all_objects`` on a one-object
    database. Returns (poses (K,4,4), scores (K,))."""
    db = rsdbio.Rsdb()
    db.objects.append(rsdbio.RsObject(uidx=0, filename="object.ply",
                                      class_idx=0, cloud=obj))
    (out,) = grid_search_all_objects(db, scene_grid, scene_bbox, occupancy,
                                     verbose=verbose, mesh=mesh)
    return out


def non_maxima_suppression(db: rsdbio.Rsdb,
                           proposals: List[Tuple[np.ndarray, np.ndarray]],
                           dist_threshold: float = config.NMS_DIST_THRESHOLD,
                           verbose: bool = False):
    """Greedy NMS per object (mgs_non_maxima_suppresion,
    pose_proposal.cpp:371-452): keep max-score detection, discard others
    with centroid distance < 0.2 m, voxel overlap > 0.5, or score < 0.01.
    Distance/score rejections are vectorized per round; the exact voxel
    overlap factor runs only for survivors of those tests."""
    out = []
    for i, (poses, scores) in enumerate(proposals):
        n = len(poses)
        if n == 0:
            out.append((poses, scores))
            continue
        shape = db.objects[i].cloud
        c = shape.centroid(0)
        ch = np.concatenate([c, [1.0]]).astype(np.float32)
        marks = np.zeros(n, dtype=np.int8)  # 0 unmarked, 1 keep, 2 discard
        centers = (poses @ ch)[:, :3]  # (n, 3)
        posed_cache = {}  # pose idx -> posed_points (transform each once)
        while (marks == 0).any():
            unm = np.where(marks == 0)[0]
            mx = unm[np.argmax(scores[unm])]
            marks[mx] = 1
            cached_mx = posed_cache.setdefault(
                mx, voxel.posed_points(shape, poses[mx]))
            rest = unm[unm != mx]
            if len(rest) == 0:
                continue
            dist = np.linalg.norm(centers[rest] - centers[mx][None, :],
                                  axis=1)
            kill = (scores[rest] < config.NMS_MIN_SCORE) | \
                (dist < dist_threshold)
            marks[rest[kill]] = 2
            for j in rest[~kill]:
                cached_j = posed_cache.setdefault(
                    j, voxel.posed_points(shape, poses[j]))
                ov = voxel.overlap_factor(shape, poses[mx], shape, poses[j],
                                          cached_a=cached_mx,
                                          cached_b=cached_j)
                if ov > config.NMS_OVERLAP_THRESHOLD:
                    marks[j] = 2
                    posed_cache.pop(j, None)
        keep = marks == 1
        if verbose:
            print(f"POSE_PROPOSAL: Non-max suppress. --> Keep: {int(keep.sum()):5d}"
                  f" Discard: {int((marks == 2).sum()):5d} Unmarked: 0")
        out.append((poses[keep], scores[keep]))
    return out


def run(rsdb_filename: str, scene_filename: str, output_filename: str,
        verbose: bool = False, save_outputs: bool = True,
        db: "rsdbio.Rsdb | None" = None, device=None,
        devices=None) -> rsdbio.Rsdb:
    """``db``: optional in-memory database from the previous stage — skips
    the from-disk reload of every object/scene cloud. ``device``: where
    the scene indexes live and the kernels run; ``devices``: the mesh's
    device list, led by ``device`` (parallel.mesh.resolve_devices; by
    default every visible card, capped by RESCAN_DEVICES). The stage's
    seconds by span (utils/timing.py) are left in
    ``db.last_pose_proposal_timings``."""
    timings = {}
    with timing.stage("pose_proposal", timings):
        db = _run(rsdb_filename, scene_filename, output_filename, verbose,
                  save_outputs, db, device, devices)
    db.last_pose_proposal_timings = timings
    return db


def _run(rsdb_filename, scene_filename, output_filename, verbose,
         save_outputs, db, device, devices) -> rsdbio.Rsdb:
    devs = pmesh.resolve_devices(device, devices)
    dev = devs[0]
    mesh = pmesh.Mesh(devs) if len(devs) > 1 else None
    if verbose and mesh is not None:
        print(f"PARALLEL: sharding over {mesh.size} slots "
              f"({', '.join(map(str, devs))})")
    with timing.span("io_load"):
        if db is None:
            db = database.load_database(rsdb_filename, load_pointclouds=True,
                                        verbose=verbose)
    db.model_folder = paths.model_folder_name(output_filename)
    if verbose:
        print(f"IO:   N. Objects:      {len(db.objects)}")
        print(f"IO:   N. Scenes:       {len(db.scenes)}")
        print(f"IO:   N. Arrangements: {len(db.arrangements)}")

    # the reference's "Computed poses in" timer spans scene ingest through
    # the final sort (apps/pose_proposal/main.cpp:144-208): ``total``; the
    # substages inside it are the root's children
    with timing.span("total", nest=False) as total:
        sorted_props, scene = _propose(db, scene_filename, output_filename,
                                       verbose, dev, mesh)
    print(f"POSE_PROPOSAL: Computed poses in {total.seconds:f}s.")

    with timing.span("final_nms_sort_save"):
        if save_outputs:
            with timing.span("io_save"):
                rsdbio.save_rsdb(output_filename, db, save_objects=True)
                rsdbio.save_pose_proposals(scene.pose_proposal_filename,
                                           [p for p, _ in sorted_props],
                                           [s for _, s in sorted_props])
        db.proposed_poses[-1] = [p for p, _ in sorted_props]
        db.proposed_scores[-1] = [s for _, s in sorted_props]
    return db


def _propose(db, scene_filename, output_filename, verbose, dev, mesh):
    """Scene ingest through the final sort; returns each object's sorted
    (poses, scores) and the new scene."""
    with timing.span("ingest") as ingest:
        # levels 3-4 are unused by this stage; they fill in on a
        # background thread while the scene index is built
        scn_cloud = PointCloud.from_ply(scene_filename, defer_levels_from=3)
        scene = rsdbio.RsScene(
            uidx=len(db.scenes), arrangement_idx=len(db.scenes),
            scn_filename=scene_filename,
            pose_proposal_filename=paths.pose_proposal_filename(
                output_filename),
            cloud=scn_cloud)
        db.scenes.append(scene)
        db.arrangements.append([])
        db.proposed_poses.append(None)
        db.proposed_scores.append(None)
    if verbose:
        print(f"PROFILE: scene ingest {ingest.seconds:.2f}s")

    # one level-1 scene slab serves every scoring pass (search_lvl = 1
    # throughout, pose_proposal.cpp:178,:263); the occupancy grid is
    # built concurrently on a host thread
    slvl = config.SCORE_SEARCH_LVL
    with timing.span("grid_occupancy") as grid_occ, \
            ThreadPoolExecutor(max_workers=1) as ex:
        occ_future = ex.submit(SceneOccupancy, scn_cloud.pos(slvl),
                               config.SCORE_SEARCH_RADII[slvl],
                               scene_nrm=scn_cloud.nrm(slvl))
        scene_grid = search.build_index(scn_cloud.pos(slvl),
                                        config.SCORE_SEARCH_RADII[slvl],
                                        normals=scn_cloud.nrm(slvl),
                                        device=dev)
        occupancy = occ_future.result()
    bbox = scn_cloud.bbox
    if verbose:
        print(f"PROFILE: search grid + occupancy {grid_occ.seconds:.2f}s")

    # --- multiresolution grid search, all dynamic objects level-major ---
    with timing.span("grid_search") as gs:
        proposals = grid_search_all_objects(db, scene_grid, bbox, occupancy,
                                            verbose=verbose, mesh=mesh)
    if verbose:
        print(f"PROFILE: grid search (all objects) {gs.seconds:.2f}s")

    # --- ICP prep is proposal-independent: build the ICP-level scene slab
    # and the unique-object point batch on a worker thread while NMS runs
    # on the main thread ---
    icp_lvl = config.REFINE_ICP_LVL
    dyn_objs = [i for i in range(len(db.objects))
                if not db.is_object_static(i)]

    def _icp_prep():
        grid = search.build_index(scn_cloud.pos(icp_lvl),
                                  config.REFINE_ICP_MAX_DIST,
                                  normals=scn_cloud.nrm(icp_lvl),
                                  tile=1024, device=dev)
        if not dyn_objs:
            return grid, None
        # the same n_min floor as segment_transfer's refinement batch
        n_min = max(len(db.objects[i].cloud.pos(icp_lvl)) for i in dyn_objs)
        batch = icp.prep_unique_batch(
            [db.objects[i].cloud.pos(icp_lvl) for i in dyn_objs],
            [db.objects[i].cloud.nrm(icp_lvl) for i in dyn_objs],
            n_min=n_min)
        return grid, tuple(timing.to_device(torch.from_numpy(a), dev)
                           for a in batch)

    with timing.span("nms") as nms, ThreadPoolExecutor(max_workers=1) as ex:
        # the worker's waits on the card count in this stage's host_syncs
        icp_prep_future = ex.submit(contextvars.copy_context().run,
                                    _icp_prep)
        proposals = non_maxima_suppression(db, proposals, verbose=verbose)
        icp_grid, ubatch = icp_prep_future.result()
    if verbose:
        print(f"PROFILE: NMS (|| ICP prep) {nms.seconds:.2f}s")

    # --- copy poses from ALL previous arrangements as proposals, score 10
    # (apps/pose_proposal/main.cpp:163-173) ---
    prop_lists = [[p for p in poses] for poses, _ in proposals]
    score_lists = [[s for s in scores] for _, scores in proposals]
    for arrangement in db.arrangements:
        for plc in arrangement:
            prop_lists[plc.object_idx].append(np.asarray(plc.pose, np.float32))
            score_lists[plc.object_idx].append(config.PRIOR_POSE_SCORE)

    # --- batched ICP refinement of every proposal of every dynamic object
    # (main.cpp:176-204: obj/scene level 2, max_dist 0.1, 60 deg; rescore
    # at query level 1) ---
    flat_T, owners = [], []
    for i in range(len(db.objects)):
        if db.is_object_static(i) or not prop_lists[i]:
            continue
        for k, T in enumerate(prop_lists[i]):
            flat_T.append(T)
            owners.append((i, k))
    if flat_T:
        with timing.span("icp_refine") as refine:
            by_obj = {}
            for b, (i, k) in enumerate(owners):
                by_obj.setdefault(i, []).append((b, k))
            # indexed batch: each unique object's padded points once, and
            # a row index per pair
            row_of = {i: r for r, i in enumerate(dyn_objs)}
            own = timing.to_device(torch.tensor([row_of[i] for i, _ in owners]),
                                   dev)
            val = torch.ones(len(owners), dtype=torch.bool, device=dev)
            T_all = timing.to_device(
                torch.from_numpy(np.stack(flat_T).astype(np.float32)), dev)
            upts, unrm, umask = ubatch
            if mesh is not None:
                T_ref, _ = pmesh.icp_refine_indexed_sharded(
                    mesh, icp_grid, upts, unrm, umask, own, val, T_all,
                    config.REFINE_ICP_MAX_DIST,
                    np.deg2rad(config.REFINE_ICP_MAX_ANGLE_DEG))
            else:
                # the JAX stage pads this batch to >= 256 pairs: its sums
                # take the many-pair orders (ops/icp.py ``single``)
                T_ref, _, _, _ = icp.icp_align_indexed(
                    upts, unrm, umask, own, val, icp_grid, T_all,
                    config.REFINE_ICP_MAX_DIST,
                    np.deg2rad(config.REFINE_ICP_MAX_ANGLE_DEG), single=False)
                T_ref = timing.to_host(T_ref)
        if verbose:
            print(f"PROFILE: ICP refinement {refine.seconds:.2f}s")

    with timing.span("refine_rescore") as rescore:
        if flat_T:
            # rescore refined poses at query level 1, all objects in one
            # launch stream
            qlvl = config.REFINE_SCORE_QUERY_LVL
            radius = sigma = config.SCORE_SEARCH_RADII[slvl]
            stream = score.ScoreStream(scene_grid, radius, sigma, mesh=mesh)
            obj_order = []
            for i, entries in by_obj.items():
                name = db.class_name(db.objects[i].class_idx)
                if verbose:
                    print(f"POSE_PROPOSAL:   Refining poses for object "
                          f"{name}.{db.objects[i].uidx:03d}")
                obj = db.objects[i].cloud
                mats = np.stack([T_ref[b] for b, _ in entries])
                stream.submit(obj.pos(qlvl), obj.nrm(qlvl), mats)
                obj_order.append((i, entries, mats))
            rescored = stream.collect()
            for (i, entries, mats), s in zip(obj_order, rescored):
                for (b, k), sc, Tn in zip(entries, s, mats):
                    prop_lists[i][k] = Tn
                    score_lists[i][k] = float(sc)
    if verbose:
        print(f"PROFILE: refine rescore {rescore.seconds:.2f}s")

    with timing.span("final_nms_sort_save"):
        proposals = [(np.stack(p) if p else np.zeros((0, 4, 4), np.float32),
                      np.asarray(s, np.float32)) for p, s in
                     zip(prop_lists, score_lists)]
        proposals = non_maxima_suppression(db, proposals, verbose=verbose)

        # sort by score descending (mgs_sort_poses,
        # pose_proposal.cpp:463-475)
        sorted_props = []
        for poses, scores in proposals:
            order = np.argsort(-scores, kind="stable")
            sorted_props.append((poses[order], scores[order]))
    return sorted_props, scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pose_proposal",
        description="Outputs pose proposals using multiresolution grid search")
    ap.add_argument("rsdb_filename")
    ap.add_argument("scene_filename")
    ap.add_argument("output_filename")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu or cuda:1 (default: every "
                    "visible card, capped by RESCAN_DEVICES)")
    args = ap.parse_args(argv)
    run(args.rsdb_filename, args.scene_filename, args.output_filename,
        args.verbose, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
