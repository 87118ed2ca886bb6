"""Instance-transfer evaluation — the port of
rescan_tpu/eval/instance_transfer.py, the paper's temporal-consistency
metric.

Semantics of the reference's scripts/evaluate_instance_transfer.py: per
scan, an instance-id confusion matrix over ids encoded as
1000*class + instance (instance = id % 1000 with Python's modulo, valid
0..255); optional per-sequence id-equivalence files reorder confusion
columns; per-instance IoU averaged over the GT's instances (skipping id
0), then averaged over scans. The 257 x 257 matrix is one ``bincount`` on
the device; the equivalences and IoUs are host arithmetic on it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import count_if_cpu, resolve_device

MAX_INSTANCE = 256
_N = MAX_INSTANCE + 1


def scan_confusion(pred, gt, device=None) -> np.ndarray:
    """The (257, 257) uint64 confusion of one scan, counted on ``device``:
    rows are GT instances (id % 1000 < 256), columns predicted ones (256
    for any instance >= 256). ``pred`` is cut to ``len(gt)``."""
    dev = resolve_device(device)
    count_if_cpu("instance_transfer.scan_confusion", dev)
    gt = torch.as_tensor(gt, dtype=torch.int64).to(dev)
    pred = torch.as_tensor(pred, dtype=torch.int64).to(dev)[:len(gt)]
    # torch.remainder takes the divisor's sign, as Python's % does
    gi = torch.remainder(gt, 1000)
    pi = torch.remainder(pred, 1000)
    valid = gi < MAX_INSTANCE
    pi = torch.where(pi < MAX_INSTANCE, pi, MAX_INSTANCE)
    conf = torch.bincount(gi[valid] * _N + pi[valid], minlength=_N * _N)
    return conf.view(_N, _N).cpu().numpy().astype(np.uint64)


def apply_equivalences(conf: np.ndarray, eq_lines: List[str]) -> None:
    """reorder_confusion: for each 'base | eq...' line, swap the diagonal
    entry with the best-matching equivalent column (ids are 0-based in the
    file, +1 in the matrix)."""
    for line in eq_lines:
        vals = line.rstrip().replace("|", " ").split()
        if not vals:
            continue
        base = int(vals[0]) + 1
        eq_ids = [int(x) + 1 for x in vals[1:]]
        if not eq_ids:
            continue
        counts = [conf[base][e] for e in eq_ids]
        best = eq_ids[int(np.argmax(counts))]
        if base != best:
            conf[base][base], conf[base][best] = conf[base][best], conf[base][base]


def instance_iou(conf: np.ndarray, iid: int) -> Tuple[float, int, int]:
    tp = int(conf[iid, iid])
    fn = int(conf[iid, :].sum()) - tp
    others = [l for l in range(MAX_INSTANCE) if l != iid]
    fp = int(conf[others, iid].sum())
    denom = tp + fp + fn
    if denom == 0:
        return float("nan"), 0, 0
    return tp / denom, tp, denom


def evaluate_scan(pred_file: str, gt_file: str,
                  eq_file: Optional[str] = None, device=None) -> float:
    dev = resolve_device(device)
    pred = np.loadtxt(pred_file, dtype=np.int64).reshape(-1)
    gt = np.loadtxt(gt_file, dtype=np.int64).reshape(-1)
    conf = scan_confusion(pred, gt, dev)
    if eq_file and os.path.exists(eq_file):
        with open(eq_file) as f:
            apply_equivalences(conf, f.readlines())
    gt_t = torch.from_numpy(gt).to(dev)
    inst_ids = torch.unique(torch.remainder(gt_t[gt_t != 0], 1000)).tolist()
    if not inst_ids:
        return float("nan")
    ious = [instance_iou(conf, i)[0] for i in inst_ids]
    return float(np.nansum(ious) / len(inst_ids))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_path", required=True)
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--output_file", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu or cuda:1 (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    files = sorted(f for f in os.listdir(args.pred_path) if f.endswith(".txt"))
    total = 0.0
    out_lines = []
    for f in files:
        # eq files live at <sequence>/gt_segmentation/<scan>.txt (reference
        # resolves them relative to cwd from the scan's sequence name)
        seq = f[:f.rfind("_")] if "_" in f else f
        eq = os.path.join(seq, "gt_segmentation", f)
        miou = evaluate_scan(os.path.join(args.pred_path, f),
                             os.path.join(args.gt_path, f),
                             eq, device=dev)
        print(f"Processed scan ({f}) -> Mean IOU {miou:8.7f}")
        out_lines.append(f"{f} {miou}")
        total += miou
    avg = total / max(len(files), 1)
    print(f"\nAverage Mean IOU: {avg:8.7f}")
    if args.output_file:
        with open(args.output_file, "w") as fo:
            fo.write("\n".join(out_lines) + f"\nAverage Mean IOU: {avg}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
