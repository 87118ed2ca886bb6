"""Seconds per rescan in pose_proposal's NMS (with the ICP prep beside it)."""


def read(record):
    vals = [r["pose_proposal"]["nms"] for r in record["rescans"]]
    return sum(vals) / len(vals) if vals else None
