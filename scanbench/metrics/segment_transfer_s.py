"""Seconds per rescan in segment_transfer (its timings' total)."""


def read(record):
    vals = [r["segment_transfer"]["total"] for r in record["rescans"]]
    return sum(vals) / len(vals) if vals else None
