"""The reference and the comparison that decides ``correct``: its sampling
equals the pipeline's, a sound run passes, the bfloat16 control fails, and
a run whose answers are altered where they are produced is not correct.

The runs here drive the whole harness on the CPU at a tiny room (the
port's plain versions of its kernels); the readings at the cells' own
sizes on the card are in PERF.md."""

import json
import os

import numpy as np
import pytest
import torch

from scanbench import harness, scenes
from scanbench.reference import check, levels

LIMITS = json.load(open(os.path.join(harness.HERE, "limits",
                                     "office.move2.json")))
TINY = {
    "config": {"room": {"size_m": [1.6, 1.6], "wall_height_m": 0.9,
                        "objects": [
        {"class": "chair", "center_xz_m": [0.45, 0.45],
         "size_m": [0.35, 0.5, 0.35], "rot_rad": 0.0},
        {"class": "table", "center_xz_m": [1.1, 1.0],
         "size_m": [0.5, 0.4, 0.35], "rot_rad": 0.0}]},
        "mesh_resolution": 6},
    "traffic": {"pool_seed": 5, "pool": 1,
                "proposal_sample": 4,
                "mix": {"moves": 1, "classes": [], "distance_m": [0.1, 0.25],
                        "turn_deg": [0.0, 20.0], "clearance_m": 0.05}},
    "limits": LIMITS,
}
SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(tmp_path):
    import time
    return harness.run(TINY, SEED, 0.5, False, torch.device("cpu"),
                       str(tmp_path), time.perf_counter())


def test_sampling_equals_the_pipelines():
    from rescan_tpu_torch.core import native
    from rescan_tpu_torch.core.pointcloud import uniform_resample
    room = scenes.room_of(TINY["config"])
    mesh = scenes.scene_mesh(room, 6)
    cloud = {k: v for k, v in mesh.items() if k != "faces"}
    cloud["qualities"] = np.ones(len(mesh["positions"]), np.float32)
    want = uniform_resample(cloud, mesh["faces"])
    got = levels.resample(mesh)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    for lvl in (1, 2):
        np.testing.assert_array_equal(
            levels.poisson(got["positions"], levels.VOXELS[lvl]),
            native.poisson_subsample(want["positions"], levels.VOXELS[lvl]))


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    torch.set_num_threads(4)
    return _run(tmp_path_factory.mktemp("sound"))


def test_a_sound_run_passes_and_the_control_fails(sound):
    assert sound["failed"] == 0, sound["numbers"]
    assert all(sound["numbers"][k] <= v for k, v in LIMITS.items())
    control = check.judge(sound["judged"], sound["objects"], SEED,
                          TINY["traffic"]["proposal_sample"], control=True)
    assert any(control[k] > v for k, v in LIMITS.items()), control


def test_the_references_objects_are_the_bootstraps(sound, tmp_path):
    """The objects that the reference cuts from the first scan's mesh are
    the ones the bootstrap writes, point for point."""
    from rescan_tpu_torch.pipeline import seg2rsdb
    room = scenes.room_of(TINY["config"])
    mesh = scenes.scene_mesh(room, TINY["config"]["mesh_resolution"])
    scan = str(tmp_path / "scan.ply")
    scenes.write_ply(scan, mesh)
    scenes.write_class_file(str(tmp_path / "classes.txt"))
    db = seg2rsdb.run(scan, str(tmp_path / "classes.txt"),
                      str(tmp_path / "prior.rsdb"))
    assert len(db.objects) == len(sound["objects"])
    for i, o in sound["objects"].items():
        lvl0 = db.objects[i].cloud.levels[0]
        assert db.objects[i].uidx == o["gt_id"]
        for k in ("positions", "class_ids", "instance_ids"):
            np.testing.assert_array_equal(lvl0[k], o["cloud"][k])


def _alter_scores(monkeypatch):
    from rescan_tpu_torch.ops import score
    collect = score.ScoreStream.collect
    monkeypatch.setattr(score.ScoreStream, "collect",
                        lambda self: [s + 1e-3 for s in collect(self)])


def _alter_labels(monkeypatch):
    from rescan_tpu_torch.ops import labels
    smooth = labels.smooth_labels

    def wrong(db, scene, *a, **k):
        out = smooth(db, scene, *a, **k)
        ins = scene.levels[1]["instance_ids"]
        ins[ins == scenes.FIRST_OBJECT_ID] = scenes.FLOOR_ID
        return out
    monkeypatch.setattr(labels, "smooth_labels", wrong)


def _icp_state_unchanged(monkeypatch):
    from rescan_tpu_torch.ops import icp
    # the pose and the error as they came in; every pair stops at once
    monkeypatch.setattr(icp, "_icp_tail",
                        lambda s4, wsum, cnt, c1, T, err, active, it:
                        (T, err, torch.zeros_like(active)))


def _alter_poses(monkeypatch):
    from rescan_tpu_torch.ops import icp
    align = icp.icp_align_indexed

    def shifted(*a, **k):
        T, err, active, n = align(*a, **k)
        T = T.clone()
        T[:, 0, 3] += 0.006
        return T, err, active, n
    monkeypatch.setattr(icp, "icp_align_indexed", shifted)


def _score_half_the_points(monkeypatch):
    from rescan_tpu_torch.ops import score
    prep = score.prep_points

    def half(obj_pts, obj_nrm):
        n = len(obj_pts) // 2
        return prep(obj_pts[:n], obj_nrm[:n])
    monkeypatch.setattr(score, "prep_points", half)


@pytest.mark.parametrize(
    "fault", [_alter_scores, _alter_labels, _icp_state_unchanged,
              _alter_poses, _score_half_the_points],
    ids=["score_altered", "labels_altered", "icp_state_unchanged",
         "poses_moved_6mm", "score_over_half_the_points"])
def test_an_altered_answer_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    out = _run(tmp_path)
    assert out["failed"] > 0, out["numbers"]
