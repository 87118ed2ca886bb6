"""Seconds per rescan reloading the prior from its .rsdb: the database,
every object's and scene's cloud and their LoD levels (pose_proposal's
``io_load`` span; None where the program has no such span)."""


def read(record):
    try:
        vals = [r["pose_proposal"]["io_load"] for r in record["rescans"]]
    except KeyError:
        return None
    return sum(vals) / len(vals) if vals else None
