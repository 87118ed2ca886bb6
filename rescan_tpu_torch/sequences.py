"""Synthetic scan sequences for parity checks, the comparison of one
rescan's outputs with a reference's, and a sequence's eval metrics.

``write_small_sequence`` is the 2-scan room of tests/test_pipeline_e2e.py
(chair moved by (0.25, 0.15)); ``write_bench_sequence`` is bench.py's
4x4 m room with five dynamic objects, two of them moved;
``write_eval_sequence`` extends either to 3+ scans as
tools/run_eval_parity.py does. ``read_outputs`` collects what the driver
wrote for a rescan (pose proposals, the optimised arrangement, the
level-1 labels of the predicted scan), and ``compare_outputs`` holds two
such sets to the port's stated tolerances. ``evaluate_sequence`` runs the
three evaluators over a sequence's eval files, and ``compare_metrics``
holds its metrics to a reference's.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from .io import ply as plyio, rsdb as rsdbio
from .utils import synthetic

SEQ_NAME = "roomA"
RESCAN = "scan_001"
EVAL_DIR = "eval"

_SMALL_ROOM = synthetic.SceneSpec(room_size=(1.6, 1.6), wall_height=0.9,
                                  objects=[
    ("chair", (0.45, 0.45), (0.35, 0.5, 0.35), 0.0),
    ("table", (1.1, 1.0), (0.5, 0.4, 0.35), 0.0)])
_BENCH_ROOM = synthetic.SceneSpec(room_size=(4.0, 4.0), wall_height=2.5,
                                  objects=[
    ("chair", (1.0, 1.0), (0.5, 0.9, 0.5), 0.0),
    ("chair", (3.0, 1.2), (0.5, 0.9, 0.5), 0.6),
    ("table", (2.0, 2.0), (1.2, 0.75, 0.8), 0.0),
    ("sofa", (1.0, 3.2), (1.6, 0.8, 0.7), 0.0),
    ("desk", (3.2, 3.0), (1.0, 0.75, 0.6), 1.2),
])
# (move, object index) of each rescan after the first, in turn
_SMALL_MOVES = [((0.25, 0.15), 0), ((-0.1, 0.3), 0), ((0.1, -0.25), 1),
                ((-0.2, -0.1), 0)]
_BENCH_MOVES = [((0.5, 0.3), 0), ((-0.4, 0.5), 3), ((0.3, -0.4), 4),
                ((-0.5, -0.2), 0)]


def _write(root: str, specs, resolution: int) -> str:
    gt = os.path.join(root, SEQ_NAME, "gt_segmentation")
    os.makedirs(gt, exist_ok=True)
    for i, spec in enumerate(specs):
        synthetic.save_scene_ply(os.path.join(gt, f"scan_{i:03d}.ply"), spec,
                                 resolution=resolution, seed=i)
    class_file = os.path.join(root, "nyu40_classes.txt")
    synthetic.write_class_file(class_file)
    return class_file


def _specs(spec0, moves, n_scans: int) -> list:
    specs = [spec0]
    while len(specs) < n_scans:
        mv, which = moves[(len(specs) - 1) % len(moves)]
        specs.append(synthetic.moved_scene_spec(specs[-1], mv, which=which))
    return specs


def write_small_sequence(root: str) -> str:
    """The 2-scan small room under ``root/roomA``; returns the class file."""
    return write_eval_sequence(root, small=True, n_scans=2)


def write_bench_sequence(root: str) -> str:
    """bench.py's 2-scan scene (4x4 m room, five dynamic objects, two
    moved, resolution 16) under ``root/roomA``; returns the class file.
    Its rescan moves chair 0 and the sofa at once."""
    moved = synthetic.moved_scene_spec(_BENCH_ROOM, (0.5, 0.3), which=0)
    moved = synthetic.moved_scene_spec(moved, (-0.4, 0.5), which=3)
    return _write(root, [_BENCH_ROOM, moved], resolution=16)


def write_eval_sequence(root: str, small: bool, n_scans: int = 3) -> str:
    """tools/run_eval_parity.py's sequence under ``root/roomA``: the small
    1.6 m room at resolution 6 (the chair moved by (0.25, 0.15), then by
    (-0.1, 0.3)), or bench.py's room at resolution 16 (chair 0 moved by
    (0.5, 0.3), then the sofa by (-0.4, 0.5)). Where two objects of the
    first scan are twins (same class, shape and size), it also writes the
    reference protocol's id-equivalence file for each rescan under
    ``root/eval/instance_transfer/id_equivalences`` (the bench room's two
    chairs). Returns the class file."""
    spec0 = _SMALL_ROOM if small else _BENCH_ROOM
    specs = _specs(spec0, _SMALL_MOVES if small else _BENCH_MOVES, n_scans)
    class_file = _write(root, specs, resolution=6 if small else 16)
    groups = _twin_groups(spec0)
    if groups:
        eq_dir = os.path.join(root, EVAL_DIR, "instance_transfer",
                              "id_equivalences")
        os.makedirs(eq_dir, exist_ok=True)
        lines = "".join(f"{base} | " + " ".join(map(str, g)) + "\n"
                        for g in groups for base in g)
        for i in range(1, n_scans):
            with open(os.path.join(eq_dir, f"scan_{i:03d}.txt"), "w") as f:
                f.write(lines)
    return class_file


def _twin_groups(spec) -> List[List[int]]:
    """GT instance ids (3 + object index, the synthetic scenes'
    convention) of objects that are interchangeable: same class, shape
    and size."""
    groups: Dict[tuple, List[int]] = {}
    for k, obj in enumerate(spec.objects):
        cls, _, size, _, shape = synthetic._obj_fields(obj)
        groups.setdefault((cls, tuple(size), shape), []).append(3 + k)
    return [g for g in groups.values() if len(g) > 1]


def rescans(root: str) -> List[str]:
    """The rescans of the sequence under ``root`` (every GT scan but the
    first), in order."""
    from .pipeline.driver import list_subsequences
    return list_subsequences(os.path.join(root, SEQ_NAME,
                                          "gt_segmentation"))[1:]


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


# Tolerances of the port against the JAX package on one rescan, the same
# for every rescan of a sequence:
# - proposal counts per object, the arrangement's objects and the label
#   arrays' lengths: identical;
# - top-1 proposal per object: pose within 1e-4, score within 1e-5;
# - every proposal: pose within 1e-4, score within 5e-5;
# - arrangement poses within 1e-4;
# - level-1 class and instance ids: agreement >= 0.999, because a pose
#   moved by ~1e-5 can carry a point at the edge of the 5 cm transfer
#   radius across it.
# The port's ICP forms its sums, products and 6x6 solve as XLA compiles
# the JAX package's (ops/pairsum.py, ops/lu6.py), and its gated-NN results
# are the Pallas kernel's, so against the JAX package on the same search
# engine (the sorted slab, its accelerator path) the small 3-scan
# sequence comes out bit-identical on the CPU, every proposal of both
# rescans (tests/test_torch_eval.py); what could still differ is the
# rotation's cos and sin and the scores' exp and arccos (an ulp on some
# arguments; on the card, whose exp and arccos are CUDA's, ~5e-7). On the
# CPU the JAX package searches with its HashGrid, whose distances round
# otherwise: an ICP on a nearly flat error surface then stops at another
# iteration, and the two committed runs of the small 3-scan sequence part
# by 1.6e-3 in pose and score on one lower-ranked proposal of rescan 2
# (tools/torch_port_parity_report.py small3). The references held to
# every limit are therefore the JAX package's runs on the slab
# (tests/data/torch_port_small3_slab_ref.npz,
# torch_port_bench_slab_ref.npz); against a HashGrid run
# (torch_port_small_ref.npz, torch_port_small3_ref.npz,
# torch_port_bench_ref.npz; ``other_engine``) the lower-ranked proposals
# are held to the limits below instead, just above the largest part
# between the JAX package's own two runs of a sequence: 1.6e-3 in pose
# and 1.61e-3 in score on the small 3-scan sequence's rescan 2, 1.94e-3
# and 3.98e-3 on the bench rescan (tools/torch_port_parity_report.py
# engines).
TOP1_POSE_TOL = 1e-4
TOP1_SCORE_TOL = 1e-5
POSE_TOL = 1e-4
SCORE_TOL = 5e-5
OTHER_ENGINE_POSE_TOL = 2.5e-3
OTHER_ENGINE_SCORE_TOL = 5e-3
LABEL_AGREEMENT = 0.999


def compare_outputs(ref: Dict[str, np.ndarray],
                    got: Dict[str, np.ndarray],
                    other_engine: bool = False) -> List[str]:
    """The tolerance breaches of ``got`` against ``ref`` (empty when
    within every tolerance above). ``other_engine``: ``ref`` searched
    with another engine than the port's (a HashGrid run, see above),
    where an ICP of a lower-ranked proposal may stop at another
    iteration: those proposals take the OTHER_ENGINE limits."""
    pose_tol, score_tol = POSE_TOL, SCORE_TOL
    if other_engine:
        prop_pose_tol = OTHER_ENGINE_POSE_TOL
        prop_score_tol = OTHER_ENGINE_SCORE_TOL
    else:
        prop_pose_tol, prop_score_tol = pose_tol, score_tol
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
    if dp > prop_pose_tol or ds > prop_score_tol:
        bad.append(f"proposals: pose diff {dp:.3g}, score diff {ds:.3g}")
    for k in ("arr_object_idx", "arr_uidx"):
        if not np.array_equal(ref[k], got[k]):
            bad.append(f"arrangement {k}: {ref[k].tolist()} vs "
                       f"{got[k].tolist()}")
    if not bad:
        da = float(np.abs(ref["arr_poses"] - got["arr_poses"]).max(initial=0))
        if da > pose_tol:
            bad.append(f"arrangement pose diff {da:.3g}")
    for k in ("class_ids", "instance_ids"):
        if len(ref[k]) != len(got[k]):
            bad.append(f"{k}: {len(ref[k])} vs {len(got[k])} points")
            continue
        agree = float((ref[k] == got[k]).mean()) if len(ref[k]) else 1.0
        if agree < LABEL_AGREEMENT:
            bad.append(f"{k}: agreement {agree:.6f}")
    return bad


def output_diffs(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray]
                 ) -> str:
    """One rescan's largest differences against a reference's, as text."""
    if not np.array_equal(ref["prop_counts"], got["prop_counts"]) or \
            len(ref["arr_poses"]) != len(got["arr_poses"]):
        return (f"proposal counts {got['prop_counts'].tolist()} vs "
                f"{ref['prop_counts'].tolist()}")
    top = np.concatenate([[0], np.cumsum(ref["prop_counts"])[:-1]])[
        ref["prop_counts"] > 0]
    dp = np.abs(ref["prop_poses"] - got["prop_poses"]).max(axis=(1, 2))
    ds = np.abs(ref["prop_scores"] - got["prop_scores"])
    agree = [float((ref[k] == got[k]).mean()) if len(ref[k]) == len(got[k])
             else float("nan") for k in ("class_ids", "instance_ids")]
    return (f"proposals {got['prop_counts'].tolist()}, top-1 pose / score "
            f"max diff {dp[top].max():.3g} / {ds[top].max():.3g}, all "
            f"{dp.max():.3g} / {ds.max():.3g} (worst pose: proposal "
            f"{int(dp.argmax())}, score {ref['prop_scores'][dp.argmax()]:.5f};"
            f" worst score: proposal {int(ds.argmax())}), arrangement pose "
            f"max diff "
            f"{np.abs(ref['arr_poses'] - got['arr_poses']).max(initial=0):.3g}"
            f", label agreement {agree[0]:.6f} / {agree[1]:.6f}")


def sequence_outputs(root: str) -> Dict[str, np.ndarray]:
    """``read_outputs`` of every rescan of the sequence, each key
    prefixed with the rescan's name ("scan_002/prop_poses")."""
    return {f"{sub}/{k}": v for sub in rescans(root)
            for k, v in read_outputs(root, sub).items()}


def split_outputs(flat: Dict[str, np.ndarray], sub: str
                  ) -> Dict[str, np.ndarray]:
    """One rescan's ``read_outputs`` back out of ``sequence_outputs``."""
    return {k[len(sub) + 1:]: v for k, v in flat.items()
            if k.startswith(sub + "/")}


METRICS = ("semantic_label_mIoU", "instance_transfer_mIoU",
           "semantic_instance_AP", "semantic_instance_AP50",
           "semantic_instance_AP25")
# Tolerances of the five metrics against the JAX package's on the small
# 3-scan sequence (measured on the CPU and on the H100: all five equal;
# the numbers below are tools/torch_port_parity_report.py small3's):
# - the two mIoUs within 6e-3: LABEL_AGREEMENT lets 0.1 % of a rescan's
#   41,510 level-1 points (41) change label; each moves tp, fp or fn of at
#   most two classes (instances) by one, whose unions hold >= 3,627
#   points, so a class IoU by <= 2.8e-4 per point, and the mean over the
#   4 classes by <= 41 * 2 * 2.8e-4 / 4 = 5.7e-3;
# - AP50 and AP25 equal: they move only when a prediction's overlap with
#   its GT instance crosses 0.5 or 0.25, and every overlap is >= 0.89
#   with unions >= 3,627 points, over 1,400 points from either;
# - AP within 1/36: the table's overlap, 0.893 in both rescans, is ~28
#   points below the 0.9 threshold, fewer than the 41 that may change, so
#   its AP at 0.9 may flip, which moves the mean over 4 classes x 9
#   thresholds by at most 1/36.
METRIC_TOLS = {"semantic_label_mIoU": 6e-3, "instance_transfer_mIoU": 6e-3,
               "semantic_instance_AP": 1.0 / 36, "semantic_instance_AP50": 0.0,
               "semantic_instance_AP25": 0.0}


def evaluate_sequence(root: str, device=None, evaluators=None
                      ) -> Dict[str, object]:
    """The three evaluators on ``device`` over the eval files the driver
    wrote under ``root/eval``, as tools/run_eval_parity.py runs them:
    the five METRICS (unrounded), the per-rescan instance-transfer mIoU,
    and, where id-equivalence files exist, the instance-transfer mIoU
    with them applied ("..._with_equivalences"). ``evaluators``: other
    (semantic_label, instance_transfer, semantic_instance) modules to run
    instead of the port's, with no device argument (the JAX package's)."""
    if evaluators is None:
        from .eval import (instance_transfer, semantic_instance,
                           semantic_label)
        kw = {"device": device}
    else:
        semantic_label, instance_transfer, semantic_instance = evaluators
        kw = {}
    ev = os.path.join(root, EVAL_DIR)

    def files(task):
        d = os.path.join(ev, task, "predictions")
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".txt")]

    def gt_of(fs):
        return [f.replace("predictions", "gt_segmentation") for f in fs]

    sl = files("semantic_label")
    ious = semantic_label.evaluate(sl, gt_of(sl), **kw)
    per_class = [v[0] for v in ious.values() if np.isfinite(v[0])]
    it = files("instance_transfer")
    it_miou = [instance_transfer.evaluate_scan(f, g, **kw)
               for f, g in zip(it, gt_of(it))]
    si = files("semantic_instance")
    res = semantic_instance.evaluate(si, gt_of(si), **kw)
    out = {
        "semantic_label_mIoU": (float(np.mean(per_class)) if per_class
                                else float("nan")),
        "instance_transfer_mIoU": float(np.mean(it_miou)),
        "semantic_instance_AP": float(res["all_ap"]),
        "semantic_instance_AP50": float(res["all_ap_50%"]),
        "semantic_instance_AP25": float(res["all_ap_25%"]),
        "instance_transfer_mIoU_per_scan": it_miou,
    }
    eq_dir = os.path.join(ev, "instance_transfer", "id_equivalences")
    if os.path.isdir(eq_dir):
        eq = [instance_transfer.evaluate_scan(
            f, g, os.path.join(eq_dir, os.path.basename(f)), **kw)
            for f, g in zip(it, gt_of(it))]
        out["instance_transfer_mIoU_with_equivalences_per_scan"] = eq
        out["instance_transfer_mIoU_with_equivalences"] = float(np.mean(eq))
    return out


def compare_metrics(ref: Dict[str, float], got: Dict[str, float]
                    ) -> List[str]:
    """The breaches of METRIC_TOLS by ``got``'s METRICS against ``ref``'s
    (empty when within them)."""
    bad = []
    for k in METRICS:
        tol = METRIC_TOLS[k]
        a, b = float(ref[k]), float(got[k])
        if not (abs(a - b) <= tol or (np.isnan(a) and np.isnan(b))):
            bad.append(f"{k}: {b!r} vs {a!r} (limit {tol})")
    return bad
