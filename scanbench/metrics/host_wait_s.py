"""Seconds per rescan the stages' own thread is blocked on the card: reads
from it, copies to it and synchronising operations (both stages'
``host_wait`` spans; None where the program has no such span)."""


def read(record):
    try:
        vals = [r["pose_proposal"]["host_wait"]
                + r["segment_transfer"]["host_wait"] for r in record["rescans"]]
    except KeyError:
        return None
    return sum(vals) / len(vals) if vals else None
