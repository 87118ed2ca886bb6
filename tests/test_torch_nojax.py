"""The port imports no JAX, builds its kernel only with nvcc and never
falls back; and its copies of the JAX package's numpy helpers give the
originals' outputs."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rescan_tpu.core.pointcloud import PointCloud
from rescan_tpu.io.rsdb import Placement, RsObject, Rsdb, RsScene
from rescan_tpu.pipeline import pose_proposal as jpp
from rescan_tpu.pipeline import segment_transfer as jst
from rescan_tpu.utils import synthetic
import rescan_tpu_torch
from rescan_tpu_torch.ops import gnn
from rescan_tpu_torch.pipeline import pose_proposal as tpp
from rescan_tpu_torch.pipeline import segment_transfer as tst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_SCRIPT = r"""
import sys
import numpy as np
import torch
import rescan_tpu_torch
from rescan_tpu_torch import sequences
from rescan_tpu_torch.ops import gnn, icp, labels, score, search
from rescan_tpu_torch.parallel import mesh
from rescan_tpu_torch.pipeline import driver, pose_proposal, segment_transfer

rng = np.random.default_rng(0)
pts = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
nrm = np.tile(np.float32([0, 1, 0]), (2000, 1))
index = search.build_index(pts, normals=nrm, tile=1024, device="cpu")
s = score.score_requests(index, [(pts[:200] - 0.5, nrm[:200],
                                  np.eye(4, dtype=np.float32)[None])],
                         0.1, 0.1)[0]
pb, nb, mb = (torch.from_numpy(a) for a in icp.pad_batch([pts[:300]],
                                                         [nrm[:300]]))
T, err = icp.icp_align_batched(pb, nb, mb, index,
                               torch.eye(4)[None], 0.1, np.deg2rad(60.0))
assert s.shape == (1,) and 0.0 < s[0] <= 1.0, s
assert torch.isfinite(T).all() and gnn.PLAIN_CALLS["nearest_gated"] > 0
m = mesh.make_mesh(4, sp=2, devices=["cpu"] * 4)
sm = score.score_requests(index, [(pts[:200] - 0.5, nrm[:200],
                                   np.eye(4, dtype=np.float32)[None])],
                          0.1, 0.1, mesh=m.flat())[0]
Tm, _ = mesh.icp_refine_indexed_dpsp(m, index, pb, nb, mb, [0], [True],
                                     np.eye(4, dtype=np.float32)[None], 0.1,
                                     np.deg2rad(60.0))
assert np.array_equal(sm, s), (sm, s)
assert np.array_equal(Tm, T.numpy()), (Tm, T)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NOJAX_OK")
"""


def test_port_imports_no_jax():
    """In a fresh interpreter without JAX_PLATFORMS (which would make
    rescan_tpu/__init__ import JAX), every port module imports, the mesh
    module included, and the CPU path scores and aligns, on one device
    and on a CPU mesh, without JAX being loaded."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout


def test_kernel_loader_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: a clear error, and no silent fallback to the CPU."""
    from torch.utils import cpp_extension
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(gnn, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(gnn, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gnn.load_library()


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rescan_tpu_torch.resolve_device("cuda")
    assert rescan_tpu_torch.resolve_device("cpu").type == "cpu"


def test_default_device_without_card_raises():
    """No device named means CUDA: without a card it raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rescan_tpu_torch.resolve_device()


@pytest.fixture(scope="module")
def room_db(tmp_path_factory):
    """The small room as a database: chair, table, wall and floor objects,
    the rescan as scene 1 with proposals for every object, and a scene-0
    arrangement."""
    d = tmp_path_factory.mktemp("helpers")
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
    rng = np.random.default_rng(9)
    poses, scores, arr = [], [], []
    for uid in (3, 4, 1, 0):
        sel = L0["instance_ids"] == uid
        cls = int(np.bincount(L0["class_ids"][sel]).argmax())
        sub = scene.extract_by_ids(0, "instance_ids", [uid],
                                   compute_levels=True)
        db.objects.append(RsObject(uidx=uid, filename=f"o{uid}.ply",
                                   class_idx=cls, cloud=sub))
        P = np.tile(np.eye(4, dtype=np.float32), (12, 1, 1))
        P[:, 0, 3] = rng.uniform(-0.3, 0.3, 12)
        P[:, 2, 3] = rng.uniform(-0.3, 0.3, 12)
        P[3] = P[2]                                  # a duplicate pose
        poses.append(P)
        scores.append(rng.uniform(0.0, 1.0, 12).astype(np.float32))
        arr.append(Placement(uid, 0, len(db.objects) - 1, 0, np.eye(4),
                             0.9))
    for i in range(2):
        db.scenes.append(RsScene(uidx=i, arrangement_idx=i,
                                 scn_filename=path, cloud=scene))
    db.arrangements = [arr, []]
    db.proposed_poses = [None, poses]
    db.proposed_scores = [None, scores]
    return db


def test_non_maxima_suppression_copy(room_db):
    props = list(zip(room_db.proposed_poses[1], room_db.proposed_scores[1]))
    for (pa, sa), (pb, sb) in zip(
            tpp.non_maxima_suppression(room_db, props),
            jpp.non_maxima_suppression(room_db, props)):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(sa, sb)


def test_scene_saliency_copy(room_db):
    a, b = copy.deepcopy(room_db), copy.deepcopy(room_db)
    tst.compute_scene_saliency(a, 1)
    jst.compute_scene_saliency(b, 1)
    qa = a.scenes[1].cloud.levels[0]["qualities"]
    np.testing.assert_array_equal(qa, b.scenes[1].cloud.levels[0]["qualities"])
    assert 0 < qa.sum() < len(qa)


def test_add_static_objects_copy(room_db):
    a, b = copy.deepcopy(room_db), copy.deepcopy(room_db)
    tst.add_static_objects(a, 1)
    jst.add_static_objects(b, 1)
    assert len(a.arrangements[1]) == len(b.arrangements[1]) == 2
    for x, y in zip(a.arrangements[1], b.arrangements[1]):
        assert (x.uidx, x.object_idx) == (y.uidx, y.object_idx)
        np.testing.assert_array_equal(x.pose, y.pose)
