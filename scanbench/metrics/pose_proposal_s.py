"""Seconds per rescan in pose_proposal (its timings' total)."""


def read(record):
    vals = [r["pose_proposal"]["total"] for r in record["rescans"]]
    return sum(vals) / len(vals) if vals else None
