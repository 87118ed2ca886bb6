"""Seconds per rescan merging the parts' answers of a search over a set
of slabs (both stages' ``set_merge`` spans: the host's time to queue the
merges; None where the program has no such span, or merged nothing)."""


def read(record):
    vals = [[r[s].get("set_merge") for s in ("pose_proposal",
                                              "segment_transfer")]
            for r in record["rescans"]]
    if not any(v is not None for row in vals for v in row):
        return None
    return sum(sum(v or 0.0 for v in row) for row in vals) / len(vals)
