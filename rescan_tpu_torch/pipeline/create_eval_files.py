"""create_eval_files — convert a segmented PLY into ScanNet-format eval
files. CLI-compatible with the reference (apps/create_eval_files/main.cpp):

    create_eval_files <input_ply> <evaluation_files_folder> [-v]

Outputs (:100-249):
  semantic_label/<method>/<scan>.txt      one class id per vertex
  instance_transfer/<method>/<scan>.txt   1000*class + (inst==1024 ? 0 : inst+1)
  semantic_instance/<method>/<scan>.txt   GT: same encoding; predictions:
      index lines "predicted_masks/<scan>_NNN.txt <class> 1.0" + binary
      per-instance vertex masks
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io import paths, ply as plyio


def _scan_name(input_ply: str) -> str:
    return os.path.splitext(os.path.basename(input_ply))[0]


def write_semantic_segmentation(cloud, out_file: str) -> None:
    np.savetxt(out_file, cloud["class_ids"], fmt="%d")


def instance_transfer_ids(cloud) -> np.ndarray:
    """1000*class + (instance == 1024 ? 0 : instance + 1)
    (create_eval_files/main.cpp:148-154)."""
    inst = cloud["instance_ids"].astype(np.int64)
    new_inst = np.where(inst == 1024, 0, inst + 1)
    return 1000 * cloud["class_ids"].astype(np.int64) + new_inst


def run(input_ply: str, eval_folder: str, verbose: bool = True,
        level: int = 0) -> None:
    """``level=0`` reads raw vertices like the reference (its dataset's
    scans are pointclouds whose >= 1 cm spacing makes level 1 == level 0).
    ``level>0`` ingests through the LoD pipeline and evaluates that level's
    enumeration — needed to align mesh-GT files with level-1 predictions."""
    if level > 0:
        from ..core.pointcloud import PointCloud
        pc = PointCloud.from_ply(input_ply)
        cloud = pc.levels[level]
    else:
        cloud = plyio.load_surfel_ply(input_ply)
    method = paths.extract_method_name(input_ply)
    scan = _scan_name(input_ply)
    is_gt = method == "gt_segmentation"

    sem_dir = os.path.join(eval_folder, "semantic_label", method)
    os.makedirs(sem_dir, exist_ok=True)
    write_semantic_segmentation(cloud, os.path.join(sem_dir, scan + ".txt"))

    it_dir = os.path.join(eval_folder, "instance_transfer", method)
    os.makedirs(it_dir, exist_ok=True)
    ids = instance_transfer_ids(cloud)
    np.savetxt(os.path.join(it_dir, scan + ".txt"), ids, fmt="%d")

    si_dir = os.path.join(eval_folder, "semantic_instance", method)
    os.makedirs(si_dir, exist_ok=True)
    si_file = os.path.join(si_dir, scan + ".txt")
    if is_gt:
        # GT semantic_instance uses the encoded-id format (main.cpp:184-193)
        np.savetxt(si_file, ids, fmt="%d")
        return

    # predictions: per-instance binary masks + index file (main.cpp:196-247),
    # in first-occurrence order of instance ids < 1024
    mask_dir = os.path.join(si_dir, "predicted_masks")
    os.makedirs(mask_dir, exist_ok=True)
    inst = cloud["instance_ids"]
    cls = cloud["class_ids"]
    sel = inst < 1024
    _, first = np.unique(inst[sel], return_index=True)
    order = inst[sel][np.sort(first)]
    with open(si_file, "w") as f:
        for iid in order:
            mask = (inst == iid).astype(np.int32)
            mask_name = f"{scan}_{int(iid):03d}.txt"
            np.savetxt(os.path.join(mask_dir, mask_name), mask, fmt="%d")
            class_id = int(cls[np.argmax(inst == iid)])
            rel = os.path.join("predicted_masks", mask_name)
            f.write(f"{rel} {class_id} {1.0:f}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="create_eval_files",
        description="Converts segmented ply files to ScanNet eval .txt files")
    ap.add_argument("input_ply_filename")
    ap.add_argument("evaluation_files_folder")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--level", type=int, default=0,
                    help="LoD level to evaluate (0 = raw vertices, reference"
                         " behavior)")
    args = ap.parse_args(argv)
    run(args.input_ply_filename, args.evaluation_files_folder, args.verbose,
        level=args.level)
    return 0


if __name__ == "__main__":
    sys.exit(main())
