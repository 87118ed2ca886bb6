"""Synthetic scan sequences for parity checks, and the comparison of one
rescan's outputs with a reference's.

``write_small_sequence`` is the 2-scan room of tests/test_pipeline_e2e.py
(chair moved by (0.25, 0.15)); ``write_bench_sequence`` is bench.py's
4x4 m room with five dynamic objects, two of them moved. ``read_outputs``
collects what the driver wrote for a rescan (pose proposals, the
optimised arrangement, the level-1 labels of the predicted scan), and
``compare_outputs`` holds two such sets to the port's stated tolerances.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from rescan_tpu.io import ply as plyio, rsdb as rsdbio
from rescan_tpu.utils import synthetic

SEQ_NAME = "roomA"
RESCAN = "scan_001"


def _write(root: str, specs, resolution: int) -> str:
    gt = os.path.join(root, SEQ_NAME, "gt_segmentation")
    os.makedirs(gt, exist_ok=True)
    for i, spec in enumerate(specs):
        synthetic.save_scene_ply(os.path.join(gt, f"scan_{i:03d}.ply"), spec,
                                 resolution=resolution, seed=i)
    class_file = os.path.join(root, "nyu40_classes.txt")
    synthetic.write_class_file(class_file)
    return class_file


def write_small_sequence(root: str) -> str:
    """The 2-scan small room under ``root/roomA``; returns the class file."""
    spec0 = synthetic.SceneSpec(room_size=(1.6, 1.6), wall_height=0.9,
                                objects=[
        ("chair", (0.45, 0.45), (0.35, 0.5, 0.35), 0.0),
        ("table", (1.1, 1.0), (0.5, 0.4, 0.35), 0.0)])
    spec1 = synthetic.moved_scene_spec(spec0, (0.25, 0.15), which=0)
    return _write(root, [spec0, spec1], resolution=6)


def write_bench_sequence(root: str) -> str:
    """bench.py's 2-scan scene (4x4 m room, five dynamic objects, two
    moved, resolution 16) under ``root/roomA``; returns the class file."""
    spec = synthetic.SceneSpec(room_size=(4.0, 4.0), wall_height=2.5,
                               objects=[
        ("chair", (1.0, 1.0), (0.5, 0.9, 0.5), 0.0),
        ("chair", (3.0, 1.2), (0.5, 0.9, 0.5), 0.6),
        ("table", (2.0, 2.0), (1.2, 0.75, 0.8), 0.0),
        ("sofa", (1.0, 3.2), (1.6, 0.8, 0.7), 0.0),
        ("desk", (3.2, 3.0), (1.0, 0.75, 0.6), 1.2),
    ])
    moved = synthetic.moved_scene_spec(spec, (0.5, 0.3), which=0)
    moved = synthetic.moved_scene_spec(moved, (-0.4, 0.5), which=3)
    return _write(root, [spec, moved], resolution=16)


def read_outputs(root: str, sub: str = RESCAN) -> Dict[str, np.ndarray]:
    """The driver's files for rescan ``sub`` as arrays."""
    seq = os.path.join(root, SEQ_NAME)
    (bin_path,) = glob.glob(os.path.join(seq, f"{sub}_pp", "*.bin"))
    poses, scores = rsdbio.load_pose_proposals(bin_path)
    db = rsdbio.load_rsdb(os.path.join(seq, f"{sub}.rsdb"))
    arr = db.arrangements[-1]
    pred = plyio.load_surfel_ply(os.path.join(seq, "predictions",
                                              f"{sub}.ply"))
    return {
        "prop_counts": np.array([len(p) for p in poses], np.int32),
        "prop_poses": np.concatenate(
            [np.asarray(p, np.float32).reshape(-1, 4, 4) for p in poses]),
        "prop_scores": np.concatenate(
            [np.asarray(s, np.float32).reshape(-1) for s in scores]),
        "arr_object_idx": np.array([p.object_idx for p in arr], np.int32),
        "arr_uidx": np.array([p.uidx for p in arr], np.int32),
        "arr_poses": np.array([p.pose for p in arr], np.float32
                              ).reshape(-1, 4, 4),
        "class_ids": np.asarray(pred["class_ids"], np.int32),
        "instance_ids": np.asarray(pred["instance_ids"], np.int32),
    }


# Tolerances of the port against the JAX package on one rescan:
# - proposal counts per object, the arrangement's objects and the label
#   arrays' lengths: identical;
# - top-1 proposal per object: pose within 1e-4, score within 1e-5;
# - every proposal: pose within 1e-4, score within 5e-5 — lower-ranked
#   proposals come out of ICP runs of ~30 iterations whose reductions sum
#   in another order than XLA's, which moves a pose by up to ~3e-5 and
#   its level-1 rescore by up to ~1.2e-5 (measured on the small
#   sequence, CPU);
# - arrangement poses within 1e-4;
# - level-1 class and instance ids: agreement >= 0.999, because a pose
#   moved by ~1e-5 can carry a point at the edge of the 5 cm transfer
#   radius across it.
TOP1_POSE_TOL = 1e-4
TOP1_SCORE_TOL = 1e-5
POSE_TOL = 1e-4
SCORE_TOL = 5e-5
LABEL_AGREEMENT = 0.999


def compare_outputs(ref: Dict[str, np.ndarray],
                    got: Dict[str, np.ndarray]) -> List[str]:
    """The tolerance breaches of ``got`` against ``ref`` (empty when
    within every tolerance above)."""
    bad = []
    if not np.array_equal(ref["prop_counts"], got["prop_counts"]):
        return [f"proposal counts {ref['prop_counts'].tolist()} vs "
                f"{got['prop_counts'].tolist()}"]
    starts = np.concatenate([[0], np.cumsum(ref["prop_counts"])[:-1]])
    for i, (s, n) in enumerate(zip(starts, ref["prop_counts"])):
        if n == 0:
            continue
        dp = float(np.abs(ref["prop_poses"][s] - got["prop_poses"][s]).max())
        ds = abs(float(ref["prop_scores"][s]) - float(got["prop_scores"][s]))
        if dp > TOP1_POSE_TOL or ds > TOP1_SCORE_TOL:
            bad.append(f"object {i} top-1: pose diff {dp:.3g}, score diff "
                       f"{ds:.3g}")
    dp = float(np.abs(ref["prop_poses"] - got["prop_poses"]).max(initial=0))
    ds = float(np.abs(ref["prop_scores"] - got["prop_scores"]).max(initial=0))
    if dp > POSE_TOL or ds > SCORE_TOL:
        bad.append(f"proposals: pose diff {dp:.3g}, score diff {ds:.3g}")
    for k in ("arr_object_idx", "arr_uidx"):
        if not np.array_equal(ref[k], got[k]):
            bad.append(f"arrangement {k}: {ref[k].tolist()} vs "
                       f"{got[k].tolist()}")
    if not bad:
        da = float(np.abs(ref["arr_poses"] - got["arr_poses"]).max(initial=0))
        if da > POSE_TOL:
            bad.append(f"arrangement pose diff {da:.3g}")
    for k in ("class_ids", "instance_ids"):
        if len(ref[k]) != len(got[k]):
            bad.append(f"{k}: {len(ref[k])} vs {len(got[k])} points")
            continue
        agree = float((ref[k] == got[k]).mean()) if len(ref[k]) else 1.0
        if agree < LABEL_AGREEMENT:
            bad.append(f"{k}: agreement {agree:.6f}")
    return bad
