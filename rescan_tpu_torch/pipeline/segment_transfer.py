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
import time
from typing import List

import numpy as np
import torch

from rescan_tpu import config
from rescan_tpu.core import database
from rescan_tpu.io import paths, rsdb as rsdbio
from rescan_tpu.ops import energy, planes

from .. import resolve_device
from ..ops import icp, labels as labels_ops, search
from ..parallel import mesh as pmesh


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
    grid = search.build_index(scene.pos(lvl), normals=scene.nrm(lvl),
                              tile=1024, device=dev)
    # indexed batch over ALL dynamic objects with the same n_min floor as
    # pose_proposal's refinement (pairs gather their rows on the device)
    uniq = [i for i in range(len(db.objects)) if not db.is_object_static(i)]
    row_of = {o: r for r, o in enumerate(uniq)}
    n_min = max((len(db.objects[i].cloud.pos(lvl)) for i in uniq),
                default=1)
    upts, unrm, umask = (torch.from_numpy(a).to(dev) for a in
                         icp.prep_unique_batch(
                             [db.objects[o].cloud.pos(lvl) for o in uniq],
                             [db.objects[o].cloud.nrm(lvl) for o in uniq],
                             n_min=n_min))
    own = torch.tensor([row_of[arr[i].object_idx] for i in idxs], device=dev)
    val = torch.ones(len(idxs), dtype=torch.bool, device=dev)
    T0 = torch.from_numpy(np.stack([arr[i].pose for i in idxs])
                          .astype(np.float32)).to(dev)
    args = (config.SCENE_REFINE_ICP_MAX_DIST,
            np.deg2rad(config.SCENE_REFINE_ICP_MAX_ANGLE_DEG))
    if mesh is None:
        T, _, _, _ = icp.icp_align_indexed(upts, unrm, umask, own, val,
                                           grid, T0, *args)
        T = T.cpu().numpy()
    else:
        sp = pmesh.refine_sp_factor(len(idxs), upts.shape[1], mesh.size)
        if sp > 1:
            mesh = pmesh.make_mesh(sp=sp, devices=mesh.devices)
        T, _ = pmesh.icp_refine_indexed_dpsp(mesh, grid, upts, unrm, umask,
                                             own, val, T0, *args)
    for k, i in enumerate(idxs):
        arr[i] = dataclasses.replace(arr[i], pose=T[k])


def augment_database(db: rsdbio.Rsdb, scene_idx: int,
                     timings: dict | None = None, device=None) -> None:
    """rsdu_augment_database (apps/segment_transfer/database_update.cpp:22-92):
    merge each placement's newly observed points (extracted from scene level
    1 by uidx) back into the object's canonical cloud, cloning the object
    when the uidx is novel; dynamic extractions are ICP-aligned to the model
    (0.05 m, 10 deg) before merging."""
    dev = resolve_device(device)
    if timings is None:
        timings = {}
    timings.setdefault("aug_extract", 0.0)
    timings.setdefault("aug_icp", 0.0)
    timings.setdefault("aug_merge", 0.0)
    scene = db.scenes[scene_idx].cloud
    arr = db.arrangements[scene_idx]
    for ci, plc in enumerate(arr):
        obj = db.objects[plc.object_idx]
        t0 = time.perf_counter()
        extracted = scene.extract_by_ids(1, "instance_ids", [plc.uidx],
                                         compute_levels=False)
        timings["aug_extract"] += time.perf_counter() - t0
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
            t0 = time.perf_counter()
            model = obj.cloud
            grid = search.build_index(model.pos(0), normals=model.nrm(0),
                                      tile=1024, device=dev)
            pts_b, nrm_b, mask_b = (torch.from_numpy(a).to(dev) for a in
                                    icp.pad_batch([extracted.pos(0)],
                                                  [extracted.nrm(0)]))
            T, _ = icp.icp_align_batched(
                pts_b, nrm_b, mask_b, grid,
                torch.from_numpy(xform[None]).to(dev),
                config.AUGMENT_ICP_MAX_DIST,
                np.deg2rad(config.AUGMENT_ICP_MAX_ANGLE_DEG))
            xform = T[0].cpu().numpy()
            timings["aug_icp"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        extracted.transform(xform, compute_levels=False)
        extracted.levels[0]["instance_ids"][:] = 0
        obj.cloud.levels[0]["instance_ids"][:] = 1
        merged = extracted.merge_with(obj.cloud, lvl=0)
        for lvl in range(config.N_LEVELS):
            merged.levels[lvl]["instance_ids"][:] = plc.uidx
        obj.cloud = merged
        timings["aug_merge"] += time.perf_counter() - t0


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
    by RESCAN_DEVICES)."""
    devs = pmesh.resolve_devices(device, devices)
    dev = devs[0]
    mesh = pmesh.Mesh(devs) if len(devs) > 1 else None
    opts = opts or config.ArrangementOpts()
    timings = {}
    t_run = time.perf_counter()
    if db is None:
        db = database.load_database(input_db, load_pointclouds=True,
                                    verbose=verbose)
    timings["io_load"] = time.perf_counter() - t_run

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
        t0 = time.perf_counter()
        plane_models = planes.detect_planes(scene)
        planes.compute_plane_features(scene, plane_models)
        planes.classify_planes(scene, plane_models)
        timings["sa_planes"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        compute_scene_saliency(db, time_idx)
        timings["sa_saliency"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        scene.compute_levels()
        timings["sa_levels"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        opts.n_past_steps = min(len(db.arrangements) - 1, opts.n_past_steps)
        ctx = energy.build_context(db, time_idx, db.proposed_poses[time_idx],
                                   db.proposed_scores[time_idx])
        timings["sa_context"] = time.perf_counter() - t1
        timings["scene_analysis"] = time.perf_counter() - t0
        print(f"SCENE_ANALYSIS: done in {timings['scene_analysis']:f}s")

    if ctx is not None and not opts.just_simulated_annealing:
        t0 = time.perf_counter()
        energy.greedy_optimize(ctx, db, time_idx, opts)
        timings["greedy"] = time.perf_counter() - t0
        print(f"ARRANGEMENT_OPTIMIZATION: Greedy estimation finished in "
              f"{timings['greedy']:f}s.")

    if ctx is not None and not opts.just_greedy_initialization:
        t0 = time.perf_counter()
        energy.simulated_annealing(ctx, db, time_idx, opts)
        timings["simulated_annealing"] = time.perf_counter() - t0
        print(f"ARRANGEMENT_OPTIMIZATION: Optimization finished in "
              f"{timings['simulated_annealing']:f}s.")

    if opts.save_arrangement_filename:
        rsdbio.save_arrangement(opts.save_arrangement_filename,
                                db.arrangements[time_idx])
        print(f"IO: Saved arrangement {opts.save_arrangement_filename}")

    t0 = time.perf_counter()
    add_static_objects(db, time_idx)
    print(f"LABEL_TRANSFER: Adding static objects finished in "
          f"{time.perf_counter() - t0:f}s.")

    t0 = time.perf_counter()
    refine_alignment_to_scene(db, time_idx, skip_static=True, device=dev,
                              mesh=mesh)
    timings["refine_to_scene"] = time.perf_counter() - t0
    print(f"ARRANGEMENT_OPTIMIZATION: Refining optimized poses done in "
          f"{timings['refine_to_scene']:f}s.")

    t0 = time.perf_counter()
    scene = db.scenes[time_idx].cloud
    labels_ops.arrangement_to_labels(db, scene, db.arrangements[time_idx],
                                     device=dev, mesh=mesh)
    timings["label_assign"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    planes.relabel_walls_and_floors(db, scene, plane_models)
    timings["label_relabel"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    labels_ops.smooth_labels(db, scene, device=dev)
    timings["label_smooth"] = time.perf_counter() - t1
    timings["label_transfer"] = time.perf_counter() - t0
    print(f"LABEL_TRANSFER: Segmentation finished in "
          f"{timings['label_transfer']:f}s.")

    t0 = time.perf_counter()
    augment_database(db, time_idx, timings=timings, device=dev)
    timings["augment"] = time.perf_counter() - t0
    print(f"LABEL_TRANSFER: Database augmentation finished in "
          f"{timings['augment']:f}s.")
    timings["total"] = time.perf_counter() - t_run
    db.last_segment_transfer_timings = timings

    if output_db:
        db.model_folder = paths.model_folder_name(output_db)
        scene_out = paths.output_segmentation_scene_filename(db.model_folder)
        db.scenes[time_idx].scn_filename = scene_out
        rsdbio.save_rsdb(output_db, db, save_objects=True)
        # the reference writes level 0 then OVERWRITES with level 1
        # (main.cpp:411-412); the surviving file is the level-1 cloud
        scene.save_ply(scene_out, level=1)
        print(f"IO: Saved database {output_db} and segmented pointcloud "
              f"{scene_out}")
    return db


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
