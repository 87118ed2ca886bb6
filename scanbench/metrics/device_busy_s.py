"""Seconds per rescan in which an operation ran on the card (the union of
the device's intervals in the traced window over its rescans)."""


def read(record):
    if "busy_s" not in record:
        return None
    return record["busy_s"] / record["n_rescans"]
