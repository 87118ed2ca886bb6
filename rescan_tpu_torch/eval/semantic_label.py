"""Semantic-label evaluation — the port of rescan_tpu/eval/semantic_label.py.

NYU40 confusion matrix -> per-class / mean IoU, with the semantics of the
reference's scripts/evaluate_semantic_label.py (same CLI: --pred_path,
--gt_path, --output_file, plus --device): GT labels outside 1..40 are
ignored; predictions outside 1..40 count as an UNKNOWN bucket; IoU =
tp / (tp + fp + fn) with fp counted only against valid classes. The
confusion matrix is one ``bincount`` on the device; the IoUs are host
arithmetic on its 42 x 42 Python ints.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import count_if_cpu, resolve_device

CLASS_LABELS = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor_mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower_curtain", "box", "whiteboard", "person", "night_stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop"]
VALID_CLASS_IDS = np.arange(1, 41)
UNKNOWN_ID = 41
_N = UNKNOWN_ID + 1


def accumulate_confusion(pred, gt, confusion: torch.Tensor) -> None:
    """Add one scan's (gt, pred) pairs to ``confusion``, a 42 x 42 int64
    tensor on the device the counting runs on. ``pred`` is cut to
    ``len(gt)``; GT outside 1..40 is dropped; predictions outside 1..40
    count as UNKNOWN_ID."""
    dev = confusion.device
    count_if_cpu("semantic_label.accumulate_confusion", dev)
    gt = torch.as_tensor(gt, dtype=torch.int64).to(dev)
    pred = torch.as_tensor(pred, dtype=torch.int64).to(dev)[:len(gt)]
    valid = (gt >= 1) & (gt <= 40)
    pred = torch.where((pred >= 1) & (pred <= 40), pred, UNKNOWN_ID)
    key = gt[valid] * _N + pred[valid]
    confusion += torch.bincount(key, minlength=_N * _N).view(_N, _N)


def class_iou(confusion: np.ndarray, label_id: int) -> Tuple[float, int, int]:
    tp = int(confusion[label_id, label_id])
    fn = int(confusion[label_id, :].sum()) - tp
    others = [l for l in VALID_CLASS_IDS if l != label_id]
    fp = int(confusion[others, label_id].sum())
    denom = tp + fp + fn
    if denom == 0:
        return float("nan"), 0, 0
    return tp / denom, tp, denom


def evaluate(pred_files: List[str], gt_files: List[str], device=None
             ) -> Dict[str, Tuple[float, int, int]]:
    dev = resolve_device(device)
    confusion = torch.zeros((_N, _N), dtype=torch.int64, device=dev)
    for pf, gf in zip(pred_files, gt_files):
        pred = np.loadtxt(pf, dtype=np.int64).reshape(-1)
        gt = np.loadtxt(gf, dtype=np.int64).reshape(-1)
        accumulate_confusion(pred, gt, confusion)
    confusion = confusion.cpu().numpy()
    return {name: class_iou(confusion, cid)
            for name, cid in zip(CLASS_LABELS, VALID_CLASS_IDS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_path", required=True)
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--output_file", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu or cuda:1 (default: cuda)")
    args = ap.parse_args(argv)

    pred_files = sorted(f for f in os.listdir(args.pred_path)
                        if f.endswith(".txt"))
    preds = [os.path.join(args.pred_path, f) for f in pred_files]
    gts = [os.path.join(args.gt_path, f) for f in pred_files]
    ious = evaluate(preds, gts, device=args.device)

    print("classes          IoU")
    print("----------------------------")
    vals = []
    for name, (iou, tp, denom) in ious.items():
        if denom:
            print(f"{name:<14s}: {iou:>5.3f}   ({tp:>6d}/{denom:<6d})")
            vals.append(iou)
    mean_iou = float(np.nanmean(vals)) if vals else float("nan")
    print(f"mean IoU: {mean_iou:.4f}")
    if args.output_file:
        with open(args.output_file, "w") as f:
            for name, (iou, tp, denom) in ious.items():
                f.write(f"{name} {iou} {tp} {denom}\n")
            f.write(f"mean {mean_iou}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
