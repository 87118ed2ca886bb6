"""Seconds per rescan the stages' own thread spends building LoD levels
or waiting for a background build, over every call site (both stages'
``levels`` spans; None where the program has no such span)."""


def read(record):
    try:
        vals = [r["pose_proposal"]["levels"] + r["segment_transfer"]["levels"]
                for r in record["rescans"]]
    except KeyError:
        return None
    return sum(vals) / len(vals) if vals else None
