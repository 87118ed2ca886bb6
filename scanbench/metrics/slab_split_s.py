"""Seconds per rescan splitting an index into a set of slabs: the global
Morton sort and the parts' builds and uploads (both stages' ``slab_split``
spans; None where the program has no such span, or split nothing)."""


def read(record):
    vals = [[r[s].get("slab_split") for s in ("pose_proposal",
                                               "segment_transfer")]
            for r in record["rescans"]]
    if not any(v is not None for row in vals for v in row):
        return None
    return sum(sum(v or 0.0 for v in row) for row in vals) / len(vals)
