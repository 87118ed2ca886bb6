"""The port's label transfer and smoothing (rescan_tpu_torch/ops/labels.py)
against the JAX package's, on the scene of tests/test_labels_unit.py."""

import copy

import numpy as np
import pytest
import torch

from rescan_tpu import config
from rescan_tpu.core.pointcloud import PointCloud
from rescan_tpu.io.rsdb import Placement, RsObject, Rsdb, RsScene
from rescan_tpu.ops import labels as jlabels
from rescan_tpu.utils import synthetic
from rescan_tpu_torch.ops import labels as tlabels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    tlabels.arrangement_to_labels(db, st, arr, device="cpu")
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


@pytest.mark.parametrize("engine", ["abswap", "native", "jax"])
def test_smooth_labels_matches_jax(room, engine):
    """Each engine against the JAX package's engine of the same name;
    ``jax`` is the port's torch mean-field + ICM engine, run on the
    CPU."""
    db, scene, arr = room
    sj, st = copy.deepcopy(scene), copy.deepcopy(scene)
    jlabels.arrangement_to_labels(db, sj, arr)
    tlabels.arrangement_to_labels(db, st, arr, device="cpu")
    before = st.levels[config.LABEL_LVL]["instance_ids"].copy()
    jlabels.smooth_labels(db, sj, engine=engine)
    tlabels.smooth_labels(db, st, engine=engine, device="cpu")
    lj, lt = sj.levels[config.LABEL_LVL], st.levels[config.LABEL_LVL]
    np.testing.assert_array_equal(lt["class_ids"], lj["class_ids"])
    np.testing.assert_array_equal(lt["instance_ids"], lj["instance_ids"])
    assert (lt["instance_ids"] != before).any()


def test_unknown_smoothing_engine_raises(room):
    db, scene, _ = room
    with pytest.raises(ValueError, match="unknown smoothing engine"):
        tlabels.smooth_labels(db, copy.deepcopy(scene), engine="gco")


def test_smooth_engine_env_selects_torch(room, monkeypatch):
    """RESCAN_SMOOTH_ENGINE=jax selects the torch engine, as it selects
    the JAX engine in the JAX package; engine="torch" is the same."""
    db, scene, arr = room
    st = copy.deepcopy(scene)
    tlabels.arrangement_to_labels(db, st, arr, device="cpu")
    a, b = copy.deepcopy(st), copy.deepcopy(st)
    monkeypatch.setenv("RESCAN_SMOOTH_ENGINE", "jax")
    tlabels.smooth_labels(db, a, device="cpu")
    monkeypatch.delenv("RESCAN_SMOOTH_ENGINE")
    tlabels.smooth_labels(db, b, engine="torch", device="cpu")
    for k in ("class_ids", "instance_ids"):
        np.testing.assert_array_equal(a.levels[config.LABEL_LVL][k],
                                      b.levels[config.LABEL_LVL][k])


def _random_label_cloud(seed):
    """tests/test_energy_labels.py's cross-engine cloud: 600 points in a
    0.4 m cube, random normals, 4 random instance labels."""
    rng = np.random.default_rng(seed)
    n = 600
    pts = rng.random((n, 3), dtype=np.float32) * 0.4
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    init = rng.integers(0, 4, n).astype(np.int32)
    cloud = PointCloud.from_arrays({
        "positions": pts, "normals": nrm,
        "colors": np.zeros((n, 3), np.float32),
        "radii": np.full(n, 0.01, np.float32),
        "qualities": np.ones(n, np.float32),
        "class_ids": np.full(n, 5, np.int32),
        "instance_ids": init}, compute_levels=True)
    cloud.levels[1] = {k: v.copy() for k, v in cloud.levels[0].items()}
    db = Rsdb()
    db.class_table = {n_: i for i, n_ in enumerate(synthetic.NYU40_CLASSES)}
    return db, cloud


def _potts(db, scene_before, scene_after):
    """The Potts energy (rescan_tpu.ops.labels.potts_energy) of the
    labels in ``scene_after`` over the problem ``scene_before`` poses:
    unary 0 at a point's own label, else its label class's cost; the
    reference's integer edge weights."""
    lb = scene_before.levels[config.LABEL_LVL]
    la = scene_after.levels[config.LABEL_LVL]
    unl = db.class_idx("unlabelled")

    def label(L):
        return np.where(L["class_ids"] == unl, 0, L["instance_ids"] + 1)

    own, got = label(lb), label(la)
    n_labels = max(int(own.max()), int(got.max())) + 1
    cost = np.where([db.is_class_static(int(c)) for c in lb["class_ids"]],
                    config.SMOOTH_COST_STATIC, config.SMOOTH_COST_DYNAMIC)
    cost = np.where(own == 0, config.SMOOTH_COST_UNLABELLED, cost)
    U = cost[:, None] * (1.0 - np.eye(n_labels)[own])
    edges, w = tlabels.build_smoothing_graph(scene_before)
    pair_w = np.floor(w * config.SMOOTH_EDGE_COST) * config.SMOOTH_EDGE_COST
    return jlabels.potts_energy(U, edges, pair_w, got)


@pytest.mark.parametrize("seed", [12345, 7])
def test_torch_engine_agrees_with_jax_on_random_labels(seed):
    """The random-label cloud of tests/test_energy_labels.py: agreement
    with the JAX engine of at least 0.995 (the JAX package's own
    cross-engine bar), and a Potts energy at most the JAX engine's
    plus 1 %."""
    db, cloud = _random_label_cloud(seed)
    sj, st = copy.deepcopy(cloud), copy.deepcopy(cloud)
    jlabels.smooth_labels(db, sj, engine="jax")
    tlabels.smooth_labels(db, st, engine="torch", device="cpu")
    lj, lt = sj.levels[1], st.levels[1]
    assert (lt["instance_ids"] != cloud.levels[1]["instance_ids"]).mean() \
        > 0.01
    for k in ("instance_ids", "class_ids"):
        agree = float(np.mean(lt[k] == lj[k]))
        assert agree >= 0.995, (k, agree)
    assert _potts(db, cloud, st) <= 1.01 * _potts(db, cloud, sj)


def test_torch_engine_energy_on_room(room):
    """On the room fixture, the torch engine's Potts energy is at most
    the JAX engine's plus 1 %, and below the transferred labels'."""
    db, scene, arr = room
    st = copy.deepcopy(scene)
    tlabels.arrangement_to_labels(db, st, arr, device="cpu")
    sj, sn = copy.deepcopy(st), copy.deepcopy(st)
    jlabels.smooth_labels(db, sj, engine="jax")
    tlabels.smooth_labels(db, sn, engine="torch", device="cpu")
    e_t = _potts(db, st, sn)
    assert e_t <= 1.01 * _potts(db, st, sj)
    assert e_t < _potts(db, st, st)


def test_torch_engine_sums_are_order_fixed():
    """The engine's neighbour sums run along a padded CSR row: the same
    labels on every run, and whatever the node block size."""
    db, cloud = _random_label_cloud(3)
    outs = []
    for block in (tlabels._NBR_BLOCK, 97 * 8 * 16):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tlabels, "_NBR_BLOCK", block)
            for _ in range(2):
                s = copy.deepcopy(cloud)
                tlabels.smooth_labels(db, s, engine="torch", device="cpu")
                outs.append(s.levels[1]["instance_ids"])
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
