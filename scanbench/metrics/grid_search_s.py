"""Seconds per rescan in pose_proposal's grid search."""


def read(record):
    vals = [r["pose_proposal"]["grid_search"] for r in record["rescans"]]
    return sum(vals) / len(vals) if vals else None
