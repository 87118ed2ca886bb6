"""Seconds per rescan in the ICP: the proposals' refinement, the
arrangement's refinement to the scene and the augmentation's alignment."""


def read(record):
    vals = [r["pose_proposal"].get("icp_refine", 0.0)
            + r["segment_transfer"]["refine_to_scene"]
            + r["segment_transfer"]["aug_icp"] for r in record["rescans"]]
    return sum(vals) / len(vals) if vals else None
