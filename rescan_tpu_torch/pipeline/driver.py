"""Full-sequence pipeline driver — the port of rescan_tpu/pipeline/driver.py.

For every sequence in a scene list, bootstrap the database from the
first GT scan (seg2rsdb), then per rescan run pose_proposal ->
segment_transfer (-> Poisson model fusion when the external
PoissonRecon/SurfaceTrimmer binaries are available). Stages run
in-process; every inter-stage file is still written, byte-compatible
with the JAX package's.

    python -m rescan_tpu_torch.pipeline.driver <scene_list> [--class_file F]
        [--poisson_recon BIN --surface_trimmer BIN] [--device D]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..utils import timing
from . import create_eval_files, pose_proposal, seg2rsdb, segment_transfer
from .fuse_models import fuse_models


def _snap_arrangements_to_text(db) -> None:
    """Round-trip every arrangement pose/score through the .rsdb text
    precision ('%f', 6 decimals) so the in-memory state is IDENTICAL to
    what a reload of the just-written checkpoint would give."""
    for arr in db.arrangements:
        for j, p in enumerate(arr):
            m = np.asarray(p.pose, np.float32)
            rt = np.array([[float("%f" % float(m[r, c])) for c in range(4)]
                           for r in range(4)], np.float32)
            arr[j] = dataclasses.replace(p, pose=rt,
                                         score=float("%f" % p.score))


def list_subsequences(seq_gt_dir: str) -> List[str]:
    subs = [os.path.splitext(f)[0] for f in os.listdir(seq_gt_dir)
            if f.endswith(".ply")]
    return sorted(subs)


def run_sequence(seq_dir: str, class_file: str,
                 poisson_recon: Optional[str] = None,
                 surface_trimmer: Optional[str] = None,
                 eval_folder: Optional[str] = None,
                 verbose: bool = False,
                 resume: bool = False,
                 in_memory: bool = True,
                 profiles: Optional[list] = None,
                 device=None, devices=None) -> List[str]:
    """Process one scene sequence; returns the list of produced .rsdb
    files (one per timestep).

    ``resume``: skip timesteps whose output .rsdb already exists (the
    .rsdb is the pipeline's checkpoint format). ``in_memory``: chain the
    stages through the in-memory database instead of reloading every
    cloud from disk per stage; outputs are identical. ``profiles``:
    optional list that receives one ``{"timestep", "pose_proposal",
    "segment_transfer"}`` dict of per-substage wall seconds per rescan.
    ``device``: where the kernels run; ``devices``: the mesh's device
    list, led by ``device`` (parallel.mesh.resolve_devices; by default
    every visible card, capped by RESCAN_DEVICES). No default picks the
    CPU: name it (``device="cpu"``).
    """
    devs = pmesh.resolve_devices(device, devices)
    gt_dir = os.path.join(seq_dir, "gt_segmentation")
    subs = list_subsequences(gt_dir)
    if not subs:
        raise FileNotFoundError(f"no .ply scans under {gt_dir}")

    produced = []
    first_ply = os.path.join(gt_dir, subs[0] + ".ply")
    prev_rsdb = os.path.join(seq_dir, subs[0] + ".rsdb")
    db = None
    if not (resume and os.path.exists(prev_rsdb)):
        db = seg2rsdb.run(first_ply, class_file, prev_rsdb, verbose)
        if in_memory:
            _snap_arrangements_to_text(db)
            for s in db.scenes:
                s.cloud = None
            # seg2rsdb writes object clouds without LoD levels; compute
            # them as a reload of the written level-0 points would, on the
            # lead device as the stages do
            for o in db.objects:
                if o.cloud is not None and o.cloud.levels[1] is None:
                    o.cloud.compute_levels(device=devs[0])
        else:
            db = None
    produced.append(prev_rsdb)

    for sub in subs[1:]:
        scan_ply = os.path.join(gt_dir, sub + ".ply")
        pp_rsdb = os.path.join(seq_dir, sub + "_pp.rsdb")
        out_rsdb = os.path.join(seq_dir, sub + ".rsdb")
        if resume and os.path.exists(out_rsdb):
            prev_rsdb = out_rsdb
            produced.append(out_rsdb)
            db = None   # state must come from the checkpoint on disk
            continue
        db = pose_proposal.run(prev_rsdb, scan_ply, pp_rsdb, verbose,
                               db=db, devices=devs)
        db = segment_transfer.run(pp_rsdb, out_rsdb, verbose=verbose,
                                  db=db, devices=devs)
        if profiles is not None:
            profiles.append({
                "timestep": sub,
                "pose_proposal": dict(getattr(
                    db, "last_pose_proposal_timings", {})),
                "segment_transfer": dict(getattr(
                    db, "last_segment_transfer_timings", {})),
            })
        if in_memory:
            # scene clouds are never read again after their timestep
            for s in db.scenes:
                s.cloud = None
            _snap_arrangements_to_text(db)
        else:
            db = None
        if poisson_recon and surface_trimmer:
            fuse_models(poisson_recon, surface_trimmer,
                        os.path.join(seq_dir, sub))
        if eval_folder:
            pred_ply = os.path.join(seq_dir, "predictions", sub + ".ply")
            create_eval_files.run(pred_ply, eval_folder)
            # GT files at level 1 so their enumeration matches the level-1
            # predictions (see create_eval_files.run)
            create_eval_files.run(scan_ply, eval_folder, level=1)
        prev_rsdb = out_rsdb
        produced.append(out_rsdb)
    return produced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Runs the full rescan segmentation pipeline")
    ap.add_argument("scene_list", help="file listing sequence dirs, one per line")
    # reference-argv compatibility (run_segmentation_pipeline.py takes
    # scene_list binary_folder script_folder); folders are accepted and
    # used only to locate PoissonRecon/SurfaceTrimmer for model fusion
    ap.add_argument("binary_folder", nargs="?", default=None)
    ap.add_argument("script_folder", nargs="?", default=None)
    ap.add_argument("--class_file", default="nyu40_classes.txt")
    ap.add_argument("--poisson_recon", default=None)
    ap.add_argument("--surface_trimmer", default=None)
    ap.add_argument("--eval_folder", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="skip timesteps whose .rsdb checkpoint exists")
    ap.add_argument("--stage_reload", action="store_true",
                    help="reload all state from disk between stages "
                    "instead of the fused in-memory path; outputs are "
                    "byte-identical either way")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler chrome trace into this "
                    "directory, with the stages' spans as ranges "
                    "(rescan.<stage>.<span>)")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu or cuda:1 (default: every "
                    "visible card, capped by RESCAN_DEVICES)")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    devs = pmesh.resolve_devices(args.device)

    poisson, trimmer = args.poisson_recon, args.surface_trimmer
    if args.binary_folder and not poisson:
        cand_p = os.path.join(args.binary_folder, "PoissonRecon")
        cand_t = os.path.join(args.binary_folder, "SurfaceTrimmer")
        if os.path.exists(cand_p) and os.path.exists(cand_t):
            poisson, trimmer = cand_p, cand_t

    prof = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if devs[0].type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        timing.profiler_ranges(True)
        prof.__enter__()
    try:
        base = os.path.dirname(args.scene_list)
        with open(args.scene_list) as f:
            sequences = [ln.strip() for ln in f if ln.strip()]
        for seq in sequences:
            run_sequence(os.path.join(base, seq), args.class_file,
                         poisson, trimmer, args.eval_folder, args.verbose,
                         resume=args.resume,
                         in_memory=not args.stage_reload, devices=devs)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            timing.profiler_ranges(False)
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile_dir,
                                                  "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
