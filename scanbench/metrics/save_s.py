"""Seconds per rescan writing the stages' outputs: the .rsdb files and
object clouds, the pose proposals and the segmented cloud (both stages'
``io_save`` spans; None where the program has no such span)."""


def read(record):
    try:
        vals = [r["pose_proposal"]["io_save"]
                + r["segment_transfer"]["io_save"] for r in record["rescans"]]
    except KeyError:
        return None
    return sum(vals) / len(vals) if vals else None
