"""Seconds per rescan that no named span of the program covers: the
harness's time of the rescan less the two stages' root spans, plus each
root's time outside its substages, the spans opened directly under it
(``stage`` and ``stage_self``; a stage's ``total`` is no substage, the
spans inside it are; None where the program has no such span)."""


def read(record):
    try:
        vals = [r["seconds"]
                - sum(r[s]["stage"] - r[s]["stage_self"]
                      for s in ("pose_proposal", "segment_transfer"))
                for r in record["rescans"]]
    except KeyError:
        return None
    return sum(vals) / len(vals) if vals else None
