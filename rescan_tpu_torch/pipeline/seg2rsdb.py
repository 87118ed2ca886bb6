"""seg2rsdb — bootstrap the object database from a GT-segmented scan.

CLI-compatible with the reference binary (apps/seg2rsdb/main.cpp):

    seg2rsdb <ply_filename> <class_to_idx> <out_rsdb_filename> [-v]

Pipeline (pointcloud_to_rsdb, apps/seg2rsdb/main.cpp:45-159): load + resample
the GT scan, find unique instance ids in first-occurrence order, extract each
instance into an object cloud, recenter dynamic objects to the XZ origin and
record the inverse translation as the placement pose, copy the class table,
write arrangement 0 and all object model PLYs.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


from ..core.pointcloud import PointCloud
from ..io import paths, rsdb as rsdbio
from ..utils.timing import stage_timer


def pointcloud_to_rsdb(in_db: rsdbio.Rsdb, cloud: PointCloud,
                       in_ply_filename: str, out_rsdb_filename: str,
                       verbose: bool = False) -> rsdbio.Rsdb:
    out = rsdbio.Rsdb()
    out.version = in_db.version
    out.model_folder = paths.model_folder_name(out_rsdb_filename)
    out.class_table = dict(in_db.class_table)

    scene = rsdbio.RsScene(uidx=len(in_db.scenes),
                           arrangement_idx=len(in_db.scenes),
                           scn_filename=in_ply_filename, cloud=cloud)
    out.scenes.append(scene)

    # unique instance ids in first-occurrence order (the reference's
    # hashtable preserves insertion order; main.cpp:83-94)
    ids = cloud.levels[0]["instance_ids"]
    _, first = np.unique(ids, return_index=True)
    unique_ids = ids[np.sort(first)]
    print(f"PC_TO_RSDB: Scene contains {len(unique_ids)} unique object instances")

    arrangement = []
    for i, uidx in enumerate(unique_ids):
        print(f"PC_TO_RSDB: Working on object {i + 1:2d}/{len(unique_ids):2d}...")
        shape = cloud.extract_by_ids(0, "instance_ids", [int(uidx)],
                                     compute_levels=False)
        class_idx = int(shape.levels[0]["class_ids"][0])
        class_name = in_db.class_name(class_idx)
        print(f"PC_TO_RSDB:    Class name: {class_name:>15} | Class id: "
              f"{class_idx:5d} | Instance id: {int(uidx):5d}")

        # dynamic objects recentered to XZ origin; pose = inverse translation
        # (main.cpp:118-126)
        pose = np.eye(4, dtype=np.float32)
        if not in_db.is_class_static(class_idx):
            centroid = shape.centroid(0).astype(np.float32)
            xform = np.eye(4, dtype=np.float32)
            xform[:3, 3] = [-centroid[0], 0.0, -centroid[2]]
            shape.transform(xform, compute_levels=False)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [centroid[0], 0.0, centroid[2]]

        obj = rsdbio.RsObject(uidx=int(uidx),
                              filename=f"{class_name}.{int(uidx):03d}.ply",
                              class_idx=class_idx, cloud=shape)
        out.objects.append(obj)
        arrangement.append(rsdbio.Placement(
            uidx=int(uidx), arrangement_idx=len(in_db.arrangements),
            object_idx=i, pose_idx=0, pose=pose, score=1.0))

    out.arrangements.append(arrangement)
    print(f"PC_TO_RSDB: Added {len(unique_ids)} new objects")
    return out


def run(ply_filename: str, class_to_idx: str, out_rsdb_filename: str,
        verbose: bool = False) -> rsdbio.Rsdb:
    """Bootstrap the database and write it; returns the in-memory db so a
    fused driver can chain stages without reloading (SURVEY §7.3)."""
    t0 = time.perf_counter()
    cloud = PointCloud.from_ply(ply_filename)
    if verbose:
        print(f"IO: Reading a ply file {ply_filename} with "
              f"{cloud.n_pts(0)} points in {time.perf_counter() - t0:f}s.")

    in_db = rsdbio.load_rsdb(class_to_idx)
    out_db = pointcloud_to_rsdb(in_db, cloud, ply_filename,
                                out_rsdb_filename, verbose)
    with stage_timer("seg2rsdb.save", "Saving database took %fs.",
                     verbose):
        rsdbio.save_rsdb(out_rsdb_filename, out_db, save_objects=True)
    return out_db


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="seg2rsdb",
        description="Generates an rsdb file from a .ply with segmentation fields")
    ap.add_argument("ply_filename")
    ap.add_argument("class_to_idx")
    ap.add_argument("out_rsdb_filename")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    run(args.ply_filename, args.class_to_idx, args.out_rsdb_filename,
        args.verbose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
