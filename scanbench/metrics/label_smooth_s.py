"""Seconds per rescan in the label smoothing (segment_transfer's
label_smooth)."""


def read(record):
    vals = [r["segment_transfer"]["label_smooth"] for r in record["rescans"]]
    return sum(vals) / len(vals) if vals else None
