"""segment_transfer — arrangement optimisation + label transfer + database
augmentation; the port of rescan_tpu/pipeline/segment_transfer.py.
CLI-compatible with the reference binary (apps/segment_transfer/main.cpp):

    python -m rescan_tpu_torch.pipeline.segment_transfer <input_database>
        -o <output_database> [-v] [--just_greedy_initialization]
        [--just_simulated_annealing] [--efw_greedy w w w w] [--efw_sa w w w w]
        [--likelihoods_sa ...] [--n_sa_iter N] [--n_past_steps N]
        [--lower_index N] [--upper_index N] [--device D]

Stage flow (main.cpp:246-421): load db + pose proposals, scene saliency +
plane classes, greedy arrangement construction, simulated annealing,
carry static placements forward, ICP-refine placements to the scene
(ops/icp.py, kernel K2), transfer labels (ops/labels.py, kernel K2),
smooth, augment the object database with newly observed geometry
(ICP again), save db + segmented scene (level-1 PLY). Planes, saliency,
the energy, greedy/SA and smoothing are the shared host code of
rescan_tpu. With more than one device (by default every visible card),
the refine-to-scene ICP and label transfer are sharded over the mesh
(parallel/mesh.py), as the JAX stage shards them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List

import numpy as np
import torch

from .. import config, resolve_device
from ..core import database
from ..io import paths, rsdb as rsdbio
from ..ops import energy, icp, labels as labels_ops, planes, search
from ..parallel import mesh as pmesh
from ..utils import timing


def compute_scene_saliency(db: rsdbio.Rsdb, scene_idx: int) -> None:
    """rsao__compute_scene_saliency_grid
    (arrangement_optimization.cpp:1108-1160): a 0.15 m voxel grid is lit by
    dynamic-object proposal footprints (level 2) and un-lit by static ones;
    level-0 scene points get quality 1 inside lit cells, 0 elsewhere, with
    wall/floor-classified points forced to 0."""
    scene = db.scenes[scene_idx].cloud
    poses = db.proposed_poses[scene_idx]
    bmin, bmax = scene.bbox
    fat = config.ISECT_FAT_FACTOR
    origin = (bmin - fat).astype(np.float32)
    voxel = config.SALIENCY_GRID_VOXEL
    res = (np.ceil(((bmax + fat) - origin) / np.float32(voxel)).astype(np.int64) + 1)
    grid = np.zeros((res[1], res[2], res[0]), np.uint8)

    lvl = config.SALIENCY_RASTERIZE_LVL

    def rasterize(value: int, want_static: bool):
        for i, obj in enumerate(db.objects):
            if db.is_object_static(i) != want_static:
                continue
            if poses is None or poses[i] is None or len(poses[i]) == 0:
                continue
            pts = obj.cloud.pos(lvl)
            for T in poses[i]:
                p = pts @ T[:3, :3].T + T[:3, 3]
                c = np.floor((p - origin) / np.float32(voxel)).astype(np.int64)
                ok = ((c >= 0) & (c < res[None, :])).all(axis=1)
                c = c[ok]
                grid[c[:, 1], c[:, 2], c[:, 0]] = value

    rasterize(1, want_static=False)   # dynamic proposals light cells
    rasterize(0, want_static=True)    # static proposals clear cells

    L0 = scene.levels[0]
    floor_idx = db.class_idx("floor")
    wall_idx = db.class_idx("wall")
    p = L0["positions"]
    c = np.floor((p - origin) / np.float32(voxel)).astype(np.int64)
    in_range = ((c >= 0) & (c < res[None, :])).all(axis=1)
    cc = np.clip(c, 0, res[None, :] - 1)
    active = np.zeros(len(p), bool)
    active[in_range] = grid[cc[in_range, 1], cc[in_range, 2],
                            cc[in_range, 0]] == 1
    q = np.where(active, 1.0, 0.0).astype(np.float32)
    is_plane = ((L0["class_ids"] == wall_idx) | (L0["class_ids"] == floor_idx))
    q[is_plane] = 0.0
    L0["qualities"] = q


def add_static_objects(db: rsdbio.Rsdb, scene_idx: int) -> None:
    """rsao_add_static_objects (arrangement_optimization.cpp:68-82):
    copy static placements from the previous arrangement."""
    for p in db.arrangements[scene_idx - 1]:
        if db.is_object_static(p.object_idx):
            db.arrangements[scene_idx].append(dataclasses.replace(p))


def refine_alignment_to_scene(db: rsdbio.Rsdb, scene_idx: int,
                              skip_static: bool = True,
                              device=None, mesh=None) -> None:
    """rsdb_refine_alignment_of_objects_to_scene (rs_database.h:216-232):
    batched ICP of every (dynamic) placement at level 2, 0.075 m, 50 deg.

    ``mesh``: a parallel.mesh.Mesh led by ``device``. The pairs are split
    over its slots; when they cannot fill it, each pair's points are
    split too (the dp x sp mode, parallel.mesh.refine_sp_factor), as the
    JAX stage does."""
    dev = resolve_device(device)
    arr = db.arrangements[scene_idx]
    idxs = [i for i, p in enumerate(arr)
            if not (skip_static and db.is_object_static(p.object_idx))]
    if not idxs:
        return
    scene = db.scenes[scene_idx].cloud
    lvl = config.SCENE_REFINE_ICP_LVL
    grid = search.build_index(scene.pos(lvl),
                              config.SCENE_REFINE_ICP_MAX_DIST,
                              normals=scene.nrm(lvl), tile=1024, device=dev)
    # indexed batch over ALL dynamic objects with the same n_min floor as
    # pose_proposal's refinement (pairs gather their rows on the device)
    uniq = [i for i in range(len(db.objects)) if not db.is_object_static(i)]
    row_of = {o: r for r, o in enumerate(uniq)}
    n_min = max((len(db.objects[i].cloud.pos(lvl)) for i in uniq),
                default=1)
    upts, unrm, umask = (timing.to_device(torch.from_numpy(a), dev) for a in
                         icp.prep_unique_batch(
                             [db.objects[o].cloud.pos(lvl) for o in uniq],
                             [db.objects[o].cloud.nrm(lvl) for o in uniq],
                             n_min=n_min))
    own = timing.to_device(
        torch.tensor([row_of[arr[i].object_idx] for i in idxs]), dev)
    val = torch.ones(len(idxs), dtype=torch.bool, device=dev)
    T0 = timing.to_device(torch.from_numpy(
        np.stack([arr[i].pose for i in idxs]).astype(np.float32)), dev)
    args = (config.SCENE_REFINE_ICP_MAX_DIST,
            np.deg2rad(config.SCENE_REFINE_ICP_MAX_ANGLE_DEG))
    # the JAX stage pads this batch to >= 256 pairs: its sums take the
    # many-pair orders (ops/icp.py ``single``)
    if mesh is None:
        T, _, _, _ = icp.icp_align_indexed(upts, unrm, umask, own, val,
                                           grid, T0, *args, single=False)
        T = timing.to_host(T)
    else:
        sp = pmesh.refine_sp_factor(len(idxs), upts.shape[1], mesh.size)
        if sp > 1:
            mesh = pmesh.make_mesh(sp=sp, devices=mesh.devices)
        T, _ = pmesh.icp_refine_indexed_dpsp(mesh, grid, upts, unrm, umask,
                                             own, val, T0, *args)
    for k, i in enumerate(idxs):
        arr[i] = dataclasses.replace(arr[i], pose=T[k])


def augment_database(db: rsdbio.Rsdb, scene_idx: int,
                     device=None) -> None:
    """rsdu_augment_database (apps/segment_transfer/database_update.cpp:22-92):
    merge each placement's newly observed points (extracted from scene level
    1 by uidx) back into the object's canonical cloud, cloning the object
    when the uidx is novel; dynamic extractions are ICP-aligned to the model
    (0.05 m, 10 deg) before merging."""
    dev = resolve_device(device)
    # every key is in the stage's timings (a reader of aug_icp finds it
    # in a rescan with no placement to augment too)
    for key in ("aug_extract", "aug_icp", "aug_merge"):
        timing.add(key, 0.0)
    scene = db.scenes[scene_idx].cloud
    arr = db.arrangements[scene_idx]
    for ci, plc in enumerate(arr):
        obj = db.objects[plc.object_idx]
        with timing.span("aug_extract"):
            extracted = scene.extract_by_ids(1, "instance_ids", [plc.uidx],
                                             compute_levels=False)
        print(f"DATABASE_AUGMENT: Working on placement {plc.uidx:3d} - "
              f"{obj.filename} | ({ci:3d}/{len(arr):3d})")
        if plc.uidx != obj.uidx:
            # novel object: clone the model under the new uidx
            new_obj = rsdbio.RsObject(
                uidx=plc.uidx,
                filename=f"{db.class_name(obj.class_idx)}.{plc.uidx:03d}.ply",
                class_idx=obj.class_idx, cloud=obj.cloud.copy())
            plc.object_idx = db.add_object(new_obj)
            obj = db.objects[plc.object_idx]
            print(f"DATABASE_AUGMENT:  --- Novel object {new_obj.filename}!")

        if extracted is None:
            continue
        xform = np.linalg.inv(plc.pose.astype(np.float64)).astype(np.float32)
        if not db.is_object_static(plc.object_idx):
            with timing.span("aug_icp"):
                model = obj.cloud
                grid = search.build_index(model.pos(0),
                                          config.AUGMENT_ICP_MAX_DIST,
                                          normals=model.nrm(0), tile=1024,
                                          device=dev)
                pts_b, nrm_b, mask_b = (
                    timing.to_device(torch.from_numpy(a), dev) for a in
                    icp.pad_batch([extracted.pos(0)], [extracted.nrm(0)]))
                T, _ = icp.icp_align_batched(
                    pts_b, nrm_b, mask_b, grid,
                    timing.to_device(torch.from_numpy(xform[None]), dev),
                    config.AUGMENT_ICP_MAX_DIST,
                    np.deg2rad(config.AUGMENT_ICP_MAX_ANGLE_DEG))
                xform = timing.to_host(T[0])
        with timing.span("aug_merge"):
            extracted.transform(xform, compute_levels=False)
            extracted.levels[0]["instance_ids"][:] = 0
            obj.cloud.levels[0]["instance_ids"][:] = 1
            merged = extracted.merge_with(obj.cloud, lvl=0)
            for lvl in range(config.N_LEVELS):
                merged.levels[lvl]["instance_ids"][:] = plc.uidx
            obj.cloud = merged


def run(input_db: str, output_db: str,
        opts: config.ArrangementOpts | None = None,
        verbose: bool = False,
        db: rsdbio.Rsdb | None = None, device=None,
        devices=None) -> rsdbio.Rsdb:
    """``db``: optional in-memory database from pose_proposal — skips the
    from-disk reload of every cloud AND the pose-proposal .bin reread
    (the fused driver's path; files on disk stay authoritative).
    ``device``: where the ICP, label-transfer and smoothing work runs;
    ``devices``: the mesh's device list, led by ``device``
    (parallel.mesh.resolve_devices; by default every visible card, capped
    by RESCAN_DEVICES). The stage's seconds by span (utils/timing.py) are
    left in ``db.last_segment_transfer_timings``."""
    timings = {}
    with timing.stage("segment_transfer", timings):
        devs = pmesh.resolve_devices(device, devices)
        mesh = pmesh.Mesh(devs) if len(devs) > 1 else None
        opts = opts or config.ArrangementOpts()
        # the substages inside ``total`` are the root's children
        with timing.span("total", nest=False):
            db, time_idx = _transfer(input_db, opts, verbose, db, devs[0],
                                     mesh)
        db.last_segment_transfer_timings = timings

        if output_db:
            db.model_folder = paths.model_folder_name(output_db)
            scene_out = paths.output_segmentation_scene_filename(
                db.model_folder)
            db.scenes[time_idx].scn_filename = scene_out
            with timing.span("io_save"):
                rsdbio.save_rsdb(output_db, db, save_objects=True)
                # the reference writes level 0 then OVERWRITES with level 1
                # (main.cpp:411-412); the surviving file is the level-1
                # cloud
                db.scenes[time_idx].cloud.save_ply(scene_out, level=1)
            print(f"IO: Saved database {output_db} and segmented pointcloud "
                  f"{scene_out}")
    return db


def _transfer(input_db, opts, verbose, db, dev, mesh):
    """The stage from the database's load through its augmentation;
    returns the database and the new scene's index."""
    with timing.span("io_load"):
        if db is None:
            db = database.load_database(input_db, load_pointclouds=True,
                                        verbose=verbose)

    # load per-scene pose proposals (main.cpp:290-297); in-memory dbs
    # already carry the latest scene's proposals
    lo = opts.lower_idx
    hi = min(len(db.scenes), opts.upper_idx)
    while len(db.proposed_poses) < len(db.scenes):
        db.proposed_poses.append(None)
        db.proposed_scores.append(None)
    for i in range(lo, hi):
        s = db.scenes[i]
        if (s.pose_proposal_filename
                and db.proposed_poses[i] is None
                and os.path.exists(s.pose_proposal_filename)):
            p, sc = rsdbio.load_pose_proposals(s.pose_proposal_filename)
            db.proposed_poses[i] = p
            db.proposed_scores[i] = sc

    # pad arrangements for novel scenes (main.cpp:300-310)
    while len(db.arrangements) < len(db.scenes):
        db.arrangements.append([])

    time_idx = len(db.arrangements) - 1
    if opts.load_arrangement_filename:
        # arrangement-blob resume surface (save_arrangement/load_arrangement,
        # apps/segment_transfer/main.cpp:81-141; byte-compatible codec)
        db.arrangements[time_idx] = rsdbio.load_arrangement(
            opts.load_arrangement_filename)
        print(f"IO: Loaded arrangement "
              f"{opts.load_arrangement_filename} "
              f"({len(db.arrangements[time_idx])} placements)")
    plane_models: List[planes.PlaneModel] = []
    ctx = None
    if db.scenes and db.scenes[time_idx].pose_proposal_filename:
        scene = db.scenes[time_idx].cloud
        with timing.stage_timer("scene_analysis",
                                "SCENE_ANALYSIS: done in %fs"):
            with timing.span("sa_planes"):
                plane_models = planes.detect_planes(scene)
                planes.compute_plane_features(scene, plane_models)
                planes.classify_planes(scene, plane_models)
            with timing.span("sa_saliency"):
                compute_scene_saliency(db, time_idx)
            with timing.span("sa_levels"):
                scene.compute_levels()
            with timing.span("sa_context"):
                opts.n_past_steps = min(len(db.arrangements) - 1,
                                        opts.n_past_steps)
                ctx = energy.build_context(db, time_idx,
                                           db.proposed_poses[time_idx],
                                           db.proposed_scores[time_idx])

    if ctx is not None and not opts.just_simulated_annealing:
        with timing.stage_timer("greedy", "ARRANGEMENT_OPTIMIZATION: Greedy "
                                "estimation finished in %fs."):
            energy.greedy_optimize(ctx, db, time_idx, opts)

    if ctx is not None and not opts.just_greedy_initialization:
        with timing.stage_timer("simulated_annealing",
                                "ARRANGEMENT_OPTIMIZATION: Optimization "
                                "finished in %fs."):
            energy.simulated_annealing(ctx, db, time_idx, opts)

    if opts.save_arrangement_filename:
        rsdbio.save_arrangement(opts.save_arrangement_filename,
                                db.arrangements[time_idx])
        print(f"IO: Saved arrangement {opts.save_arrangement_filename}")

    with timing.stage_timer("add_static", "LABEL_TRANSFER: Adding static "
                            "objects finished in %fs."):
        add_static_objects(db, time_idx)

    with timing.stage_timer("refine_to_scene", "ARRANGEMENT_OPTIMIZATION: "
                            "Refining optimized poses done in %fs."):
        refine_alignment_to_scene(db, time_idx, skip_static=True, device=dev,
                                  mesh=mesh)

    with timing.stage_timer("label_transfer", "LABEL_TRANSFER: Segmentation "
                            "finished in %fs."):
        scene = db.scenes[time_idx].cloud
        with timing.span("label_assign"):
            labels_ops.arrangement_to_labels(db, scene,
                                             db.arrangements[time_idx],
                                             device=dev, mesh=mesh)
        with timing.span("label_relabel"):
            planes.relabel_walls_and_floors(db, scene, plane_models)
        with timing.span("label_smooth"):
            labels_ops.smooth_labels(db, scene, device=dev)

    with timing.stage_timer("augment", "LABEL_TRANSFER: Database "
                            "augmentation finished in %fs."):
        augment_database(db, time_idx, device=dev)
    return db, time_idx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="segment_transfer",
        description="Arrangement optimization and segmentation transfer")
    ap.add_argument("input_database_filename")
    ap.add_argument("--output_database", "-o", dest="output")
    # accepted for argv parity and intentionally unused: the reference
    # parses -s into opts.output_segmented_mesh (main.cpp:72,:221-222) and
    # never reads it either — the segmented PLY is always written when -o
    # is given (main.cpp:403-419), which run() replicates
    ap.add_argument("--output_segmentation", "-s", action="store_true")
    ap.add_argument("--just_simulated_annealing", action="store_true")
    ap.add_argument("--just_greedy_initialization", action="store_true")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--efw_greedy", nargs=4, type=float)
    ap.add_argument("--efw_sa", nargs=4, type=float)
    ap.add_argument("--likelihoods_sa", "-l", nargs=5, type=float)
    ap.add_argument("--lower_index", type=int, default=0)
    ap.add_argument("--upper_index", type=int, default=10)
    ap.add_argument("--n_sa_iter", type=int, default=config.SA_N_ITER)
    ap.add_argument("--n_past_steps", type=int, default=config.N_PAST_STEPS)
    ap.add_argument("--save_arrangement", default=None,
                    help="write the optimized arrangement blob (binary, "
                    "byte-compatible with the reference's save_arrangement)")
    ap.add_argument("--load_arrangement", default=None,
                    help="skip optimization state: preload the arrangement "
                    "from a blob written by --save_arrangement")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu or cuda:1 (default: every "
                    "visible card, capped by RESCAN_DEVICES)")
    args = ap.parse_args(argv)

    opts = config.ArrangementOpts(
        lower_idx=args.lower_index, upper_idx=args.upper_index,
        n_sa_iter=args.n_sa_iter, n_past_steps=args.n_past_steps,
        just_greedy_initialization=args.just_greedy_initialization,
        just_simulated_annealing=args.just_simulated_annealing,
        save_arrangement_filename=args.save_arrangement,
        load_arrangement_filename=args.load_arrangement)
    if args.efw_greedy:
        opts.energy_weights_greedy = tuple(args.efw_greedy)
    if args.efw_sa:
        opts.energy_weights_sa = tuple(args.efw_sa)
    if args.likelihoods_sa:
        opts.sa_action_likelihoods = tuple(args.likelihoods_sa)

    run(args.input_database_filename, args.output, opts, args.verbose,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
