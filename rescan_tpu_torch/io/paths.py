"""Filename derivation helpers (lib/rs/filepath_helpers.h)."""

from __future__ import annotations

import os


def model_folder_name(rsdb_filename: str) -> str:
    """``<dir>/<name>.rsdb`` -> ``<dir>/<name>``
    (create_model_folder_name, filepath_helpers.h:91-103)."""
    dot = rsdb_filename.rfind(".")
    return rsdb_filename[:dot] if dot >= 0 else rsdb_filename


def pose_proposal_filename(rsdb_filename: str) -> str:
    """``<dir>/<name>.rsdb`` -> ``<dir>/<name>/<name>.bin``
    (create_pose_proposal_filename, filepath_helpers.h:67-89)."""
    folder = os.path.dirname(rsdb_filename)
    base = os.path.splitext(os.path.basename(rsdb_filename))[0]
    return os.path.join(folder, base, base + ".bin")


def output_segmentation_scene_filename(model_folder: str) -> str:
    """``<dir>/<name>`` -> ``<dir>/predictions/<name>.ply`` (and makes the
    predictions dir; create_output_segmentation_scene_filename,
    filepath_helpers.h:15-38)."""
    folder = os.path.dirname(model_folder)
    base = os.path.basename(model_folder)
    pred = os.path.join(folder, "predictions")
    os.makedirs(pred, exist_ok=True)
    return os.path.join(pred, base + ".ply")


def extract_method_name(scene_name: str) -> str:
    """Middle path component used to group eval outputs
    (extract_method_name, filepath_helpers.h:40-56): the component between
    the first and last separator, or the leading component when there is
    only one separator."""
    first = scene_name.find(os.sep)
    second = scene_name.rfind(os.sep)
    if second < 0:
        return ""
    if first == second:
        return scene_name[:second]
    return scene_name[first + 1:second]
