"""Temporal database loading: attach point clouds to a parsed Rsdb.

Mirrors rsdb_load with load_pointclouds=1 (lib/rs/rs_database.h:479-519):
object model PLYs resolve against the db's model_folder; scene PLYs load
from their recorded paths; every cloud gets its full LoD pyramid (on
``device``, as ``PointCloud.compute_levels``).
"""

from __future__ import annotations

import os

from ..io import rsdb as rsdbio
from .pointcloud import PointCloud


def load_database(path: str, load_pointclouds: bool = True,
                  verbose: bool = False, device=None) -> rsdbio.Rsdb:
    db = rsdbio.load_rsdb(path)
    if load_pointclouds:
        n = len(db.objects) + len(db.scenes)
        if verbose:
            print(f"IO: Loading and processing {n} pointclouds...")
        for obj in db.objects:
            p = os.path.join(db.model_folder, obj.filename)
            obj.cloud = PointCloud.from_ply(p, device=device)
        for s in db.scenes:
            s.cloud = PointCloud.from_ply(s.scn_filename, device=device)
    return db
