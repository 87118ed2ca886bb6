"""Semantic-instance AP evaluation (ScanNet / CityScapes protocol) — the
port of rescan_tpu/eval/semantic_instance.py.

Semantics of the reference's scripts/evaluate_semantic_instance.py:
greedy pred-to-GT matching per class at overlap thresholds {0.5..0.9
step 0.05} + {0.25}; GT instances need id >= 1000 and >= 100 vertices;
unmatched predictions become false positives unless mostly covered by
void/group/small-GT vertices; AP is the step-integrated precision-recall
area; AP50/AP25 at single thresholds. Same CLI: --pred_path, --gt_path,
--output_file, plus --device.

Per scan, the predicted masks are stacked (P x N) beside the GT ids on
the device, and one ``bincount`` gives every prediction's intersection
with every GT id, from which come the GT intersections, each
prediction's vertex count and its void intersection. The matching and
the AP are host code on those counts.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from .. import count_if_cpu, resolve_device
from .semantic_label import CLASS_LABELS, VALID_CLASS_IDS

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


def _load_pred_info(pred_file: str) -> List[dict]:
    """Mask paths are validated like the reference's
    read_instance_prediction_file (scripts/util_3d.py:125-145): they must
    be relative and resolve inside the prediction directory — a prediction
    file must not be able to point the evaluator at arbitrary files."""
    out = []
    base = os.path.dirname(pred_file)
    abs_base = os.path.abspath(base)
    with open(pred_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            if os.path.isabs(parts[0]):
                raise ValueError(
                    f"invalid instance prediction file {pred_file}: mask "
                    f"path {parts[0]!r} must be relative")
            mask_file = os.path.abspath(os.path.join(base, parts[0]))
            if os.path.commonpath([mask_file, abs_base]) != abs_base:
                raise ValueError(
                    f"predicted mask {mask_file} in {pred_file} points "
                    f"outside of the prediction path")
            out.append({"mask_file": mask_file,
                        "label_id": int(float(parts[1])),
                        "conf": float(parts[2])})
    return out


def _counts(gt_ids: torch.Tensor, masks: List[np.ndarray]):
    """(ids, vert counts, P x U intersections) on the device: the GT ids
    in ascending order with their vertex counts, and for each mask the
    vertices it shares with each of them."""
    ids, inv, vert = torch.unique(gt_ids, return_inverse=True,
                                  return_counts=True)
    U = len(ids)
    if not masks:
        return ids, vert, torch.zeros((0, U), dtype=torch.int64,
                                      device=gt_ids.device)
    M = torch.from_numpy(np.stack(masks)).to(gt_ids.device)
    rows = torch.arange(len(masks), device=gt_ids.device)[:, None] * U
    inter = torch.bincount((rows + inv[None, :])[M],
                           minlength=len(masks) * U)
    return ids, vert, inter.view(len(masks), U)


def assign_instances_for_scan(pred_file: str, gt_file: str, device=None):
    dev = resolve_device(device)
    count_if_cpu("semantic_instance.assign_instances_for_scan", dev)
    gt_np = np.loadtxt(gt_file, dtype=np.int64).reshape(-1)
    id_to_label = {cid: name for cid, name in
                   zip(VALID_CLASS_IDS, CLASS_LABELS)}

    infos, masks = [], []
    for info in _load_pred_info(pred_file):
        if info["label_id"] not in id_to_label:
            continue
        mask = np.loadtxt(info["mask_file"], dtype=np.int64).reshape(-1) != 0
        if len(mask) != len(gt_np):
            raise ValueError(
                f"mask {info['mask_file']} has {len(mask)} lines but GT "
                f"{gt_file} has {len(gt_np)} vertices")
        infos.append(info)
        masks.append(mask)
    ids, vert, inter = _counts(torch.from_numpy(gt_np).to(dev), masks)
    label_of = torch.div(ids, 1000, rounding_mode="floor")
    void = ~((label_of >= 1) & (label_of <= 40))
    num = inter.sum(1)
    void_inter = inter[:, void].sum(1)
    ids, label_of, vert = ids.tolist(), label_of.tolist(), vert.tolist()
    num, void_inter, inter = num.tolist(), void_inter.tolist(), inter.tolist()

    gt_instances: Dict[str, List[dict]] = {n: [] for n in CLASS_LABELS}
    gt_col = {}
    for u, (iid, label_id) in enumerate(zip(ids, label_of)):
        if iid == 0 or label_id not in id_to_label:
            continue
        gt_instances[id_to_label[label_id]].append({
            "instance_id": iid, "label_id": label_id,
            "vert_count": vert[u], "matched_pred": []})
        gt_col[iid] = u

    pred_instances: Dict[str, List[dict]] = {n: [] for n in CLASS_LABELS}
    for k, info in enumerate(infos):
        label_name = id_to_label[info["label_id"]]
        if num[k] < MIN_REGION_SIZE:
            continue
        pred = {"filename": info["mask_file"], "label_id": info["label_id"],
                "vert_count": num[k], "confidence": info["conf"],
                "void_intersection": void_inter[k],
                "matched_gt": []}
        for gt in gt_instances[label_name]:
            n_inter = inter[k][gt_col[gt["instance_id"]]]
            if n_inter > 0:
                gt_copy = dict(gt, intersection=n_inter)
                pred_copy = dict(pred, intersection=n_inter)
                del gt_copy["matched_pred"]
                pred["matched_gt"].append(gt_copy)
                gt["matched_pred"].append(pred_copy)
        pred_instances[label_name].append(pred)
    return gt_instances, pred_instances


def _ap_from_matches(matches, label_name: str, overlap_th: float) -> float:
    y_true: List[float] = []
    y_score: List[float] = []
    hard_fn = 0
    has_gt = has_pred = False
    pred_visited = {p["filename"]: False
                    for m in matches for p in m["pred"][label_name]}
    for m in matches:
        gts = [g for g in m["gt"][label_name]
               if g["instance_id"] >= 1000 and g["vert_count"] >= MIN_REGION_SIZE]
        preds = m["pred"][label_name]
        has_gt |= bool(gts)
        has_pred |= bool(preds)

        cur_true, cur_score, cur_match = [], [], []
        for gt in gts:
            found = False
            g_true, g_score = 1.0, -float("inf")
            extra = []
            for pred in gt["matched_pred"]:
                if pred_visited[pred["filename"]]:
                    continue
                ov = pred["intersection"] / (
                    gt["vert_count"] + pred["vert_count"] - pred["intersection"])
                if ov > overlap_th:
                    conf = pred["confidence"]
                    if found:
                        # duplicate match: lower-confidence one is an FP
                        mx, mn = max(g_score, conf), min(g_score, conf)
                        g_score = mx
                        extra.append(mn)
                    else:
                        found = True
                        g_score = conf
                        pred_visited[pred["filename"]] = True
            if found:
                cur_true.append(1.0)
                cur_score.append(g_score)
            else:
                hard_fn += 1
            for e in extra:
                cur_true.append(0.0)
                cur_score.append(e)

        for pred in preds:
            found_gt = False
            for gt in pred["matched_gt"]:
                ov = gt["intersection"] / (
                    gt["vert_count"] + pred["vert_count"] - gt["intersection"])
                if ov > overlap_th:
                    found_gt = True
                    break
            if not found_gt:
                ignore = pred["void_intersection"]
                for gt in pred["matched_gt"]:
                    if gt["instance_id"] < 1000:
                        ignore += gt["intersection"]
                    if gt["vert_count"] < MIN_REGION_SIZE:
                        ignore += gt["intersection"]
                if ignore / pred["vert_count"] <= overlap_th:
                    cur_true.append(0.0)
                    cur_score.append(pred["confidence"])
        y_true.extend(cur_true)
        y_score.extend(cur_score)

    if not has_gt:
        return float("nan")
    if not has_pred:
        return 0.0

    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    order = np.argsort(y_score)
    y_true_s = y_true[order]
    y_score_s = y_score[order]
    cumsum = np.cumsum(y_true_s)
    _, uniq = np.unique(y_score_s, return_index=True)
    n = len(y_score_s)
    n_true = cumsum[-1] if n else 0
    cumsum_pad = np.append(cumsum, 0)
    precision = np.zeros(len(uniq) + 1)
    recall = np.zeros(len(uniq) + 1)
    for r, idx in enumerate(uniq):
        c = cumsum_pad[idx - 1] if idx > 0 else 0
        tp = n_true - c
        fp = n - idx - tp
        fn = c + hard_fn
        precision[r] = tp / max(tp + fp, 1e-12)
        recall[r] = tp / max(tp + fn, 1e-12)
    precision[-1] = 1.0
    recall[-1] = 0.0
    rc = np.concatenate([[recall[0]], recall, [0.0]])
    step = np.convolve(rc, [-0.5, 0, 0.5], "valid")
    return float(precision @ step)


def evaluate(pred_files: List[str], gt_files: List[str], device=None) -> dict:
    dev = resolve_device(device)
    matches = []
    for pf, gf in zip(pred_files, gt_files):
        gt2pred, pred2gt = assign_instances_for_scan(pf, gf, dev)
        matches.append({"gt": gt2pred, "pred": pred2gt})
    ap = np.zeros((len(CLASS_LABELS), len(OVERLAPS)))
    for li, name in enumerate(CLASS_LABELS):
        for oi, th in enumerate(OVERLAPS):
            ap[li, oi] = _ap_from_matches(matches, name, th)
    not25 = ~np.isclose(OVERLAPS, 0.25)
    o50 = np.isclose(OVERLAPS, 0.5)
    o25 = np.isclose(OVERLAPS, 0.25)
    import warnings
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        # classes absent from GT are all-nan rows: nanmean's "Mean of
        # empty slice" warning is the expected nan result, not a problem
        # (only that message — other RuntimeWarnings here would be bugs)
        warnings.filterwarnings("ignore", message="Mean of empty slice",
                                category=RuntimeWarning)
        result = {
            "all_ap": float(np.nanmean(ap[:, not25])),
            "all_ap_50%": float(np.nanmean(ap[:, o50])),
            "all_ap_25%": float(np.nanmean(ap[:, o25])),
            "classes": {name: {
                "ap": float(np.nanmean(ap[li, not25])),
                "ap50%": float(np.nanmean(ap[li, o50])),
                "ap25%": float(np.nanmean(ap[li, o25]))}
                for li, name in enumerate(CLASS_LABELS)},
        }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_path", required=True)
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--output_file", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu or cuda:1 (default: cuda)")
    args = ap.parse_args(argv)

    files = sorted(f for f in os.listdir(args.pred_path)
                   if f.endswith(".txt"))
    preds = [os.path.join(args.pred_path, f) for f in files]
    gts = [os.path.join(args.gt_path, f) for f in files]
    res = evaluate(preds, gts, device=args.device)
    print(f"{'what':<15}: {'AP':>12} {'AP_50%':>12} {'AP_25%':>12}")
    for name in CLASS_LABELS:
        c = res["classes"][name]
        if not np.isnan(c["ap"]) or not np.isnan(c["ap50%"]):
            print(f"{name:<15}: {c['ap']:>12.3f} {c['ap50%']:>12.3f} "
                  f"{c['ap25%']:>12.3f}")
    print(f"{'average':<15}: {res['all_ap']:>12.3f} "
          f"{res['all_ap_50%']:>12.3f} {res['all_ap_25%']:>12.3f}")
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write("class,ap,ap50,ap25\n")
            for name in CLASS_LABELS:
                c = res["classes"][name]
                f.write(f"{name},{c['ap']},{c['ap50%']},{c['ap25%']}\n")
            f.write(f"average,{res['all_ap']},{res['all_ap_50%']},"
                    f"{res['all_ap_25%']}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
