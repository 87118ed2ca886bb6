"""The port's label transfer and smoothing (rescan_tpu_torch/ops/labels.py)
against the JAX package's, on the scene of tests/test_labels_unit.py."""

import copy

import numpy as np
import pytest

from rescan_tpu import config
from rescan_tpu.core.pointcloud import PointCloud
from rescan_tpu.io.rsdb import Placement, RsObject, Rsdb, RsScene
from rescan_tpu.ops import labels as jlabels
from rescan_tpu.utils import synthetic
from rescan_tpu_torch.ops import labels as tlabels


def _shift(dx, dz, theta=0.0):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(theta), np.sin(theta)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[0, 3], T[2, 3] = dx, dz
    return T


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The small room with its chair, table, wall and floor as database
    objects, and an arrangement placing each (the chair slightly off)."""
    d = tmp_path_factory.mktemp("labels")
    spec = synthetic.SceneSpec(room_size=(1.6, 1.6), wall_height=0.9,
                               objects=[
        ("chair", (0.45, 0.45), (0.35, 0.5, 0.35), 0.0),
        ("table", (1.1, 1.0), (0.5, 0.4, 0.35), 0.0)])
    path = str(d / "scene.ply")
    synthetic.save_scene_ply(path, spec, resolution=6)
    scene = PointCloud.from_ply(path)
    db = Rsdb()
    db.class_table = {n: i for i, n in enumerate(synthetic.NYU40_CLASSES)}
    L0 = scene.levels[0]
    arr = []
    for uid, pose in ((3, _shift(0.01, -0.005, 0.02)), (4, _shift(0, 0)),
                      (1, _shift(0, 0)), (0, _shift(0, 0))):
        sel = L0["instance_ids"] == uid
        cls = int(np.bincount(L0["class_ids"][sel]).argmax())
        sub = scene.extract_by_ids(0, "instance_ids", [uid],
                                   compute_levels=True)
        db.objects.append(RsObject(uidx=uid, filename=f"o{uid}.ply",
                                   class_idx=cls, cloud=sub))
        arr.append(Placement(uid, 0, len(db.objects) - 1, 0, pose, 0.9))
    db.scenes.append(RsScene(uidx=0, arrangement_idx=0, scn_filename=path,
                             cloud=scene))
    assert any(db.is_object_static(i) for i in range(len(db.objects)))
    return db, scene, arr


@pytest.mark.parametrize("which", ["dynamic_only", "with_static"])
def test_arrangement_to_labels_matches_jax(room, which):
    """Identical class and instance ids to the JAX package (whose CPU
    engine is the HashGrid): both take the nearest object point within
    the radius, then gate its |dot| at 70 degrees. With no static
    placement the 1.5x static pass covers every placement (the quirk at
    labels.py:83-85)."""
    db, scene, arr = room
    arr = arr[:2] if which == "dynamic_only" else arr
    sj, st = copy.deepcopy(scene), copy.deepcopy(scene)
    jlabels.arrangement_to_labels(db, sj, arr)
    tlabels.arrangement_to_labels(db, st, arr)
    lj, lt = sj.levels[config.LABEL_LVL], st.levels[config.LABEL_LVL]
    assert len(np.unique(lt["instance_ids"])) == len(arr) + 1
    np.testing.assert_array_equal(lt["class_ids"], lj["class_ids"])
    np.testing.assert_array_equal(lt["instance_ids"], lj["instance_ids"])


def test_smoothing_graph_matches_jax(room):
    """The port builds the graph on the native HostGrid; the JAX
    package's CPU branch uses hashgrid.radius_knn. Same edges, same
    weights."""
    _, scene, _ = room
    ej, wj = jlabels.build_smoothing_graph(scene)
    et, wt = tlabels.build_smoothing_graph(scene)
    oj = np.lexsort((ej[:, 1], ej[:, 0]))
    ot = np.lexsort((et[:, 1], et[:, 0]))
    np.testing.assert_array_equal(et[ot], ej[oj])
    np.testing.assert_allclose(wt[ot], wj[oj], rtol=1e-6, atol=0)


@pytest.mark.parametrize("engine", ["abswap", "native"])
def test_smooth_labels_matches_jax(room, engine):
    db, scene, arr = room
    sj, st = copy.deepcopy(scene), copy.deepcopy(scene)
    jlabels.arrangement_to_labels(db, sj, arr)
    tlabels.arrangement_to_labels(db, st, arr)
    before = st.levels[config.LABEL_LVL]["instance_ids"].copy()
    jlabels.smooth_labels(db, sj, engine=engine)
    tlabels.smooth_labels(db, st, engine=engine)
    lj, lt = sj.levels[config.LABEL_LVL], st.levels[config.LABEL_LVL]
    np.testing.assert_array_equal(lt["class_ids"], lj["class_ids"])
    np.testing.assert_array_equal(lt["instance_ids"], lj["instance_ids"])
    assert (lt["instance_ids"] != before).any()


def test_unported_smoothing_engine_raises(room):
    db, scene, _ = room
    with pytest.raises(ValueError):
        tlabels.smooth_labels(db, copy.deepcopy(scene), engine="jax")
