"""The port imports neither JAX nor the JAX package, builds its kernel
only with nvcc and never falls back; and its copies of the JAX package's
numpy helpers give the originals' outputs."""

import ast
import copy
import glob
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

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
from rescan_tpu_torch.ops import dense_nn, gnn, hashgrid, icp, labels
from rescan_tpu_torch.ops import score, search
from rescan_tpu_torch.parallel import mesh
from rescan_tpu_torch.pipeline import driver, pose_proposal, segment_transfer

rng = np.random.default_rng(0)
pts = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
nrm = np.tile(np.float32([0, 1, 0]), (2000, 1))
index = search.build_index(pts, 0.1, normals=nrm, tile=1024, device="cpu")
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
# the mesh sums in the many-pair orders (parallel/mesh.py)
T1 = icp.icp_align_indexed(pb, nb, mb, torch.zeros(1, dtype=torch.long),
                           torch.ones(1, dtype=torch.bool), index,
                           torch.eye(4)[None], 0.1, np.deg2rad(60.0),
                           single=False)[0]
assert np.array_equal(sm, s), (sm, s)
assert np.array_equal(Tm, T1.numpy()), (Tm, T1)
# the other two engines, through the same entry points
grid = search.build_index(pts, 0.1, normals=nrm, prefer_dense=False,
                          device="cpu")
sg = score.score_requests(grid, [(pts[:200] - 0.5, nrm[:200],
                                  np.eye(4, dtype=np.float32)[None])],
                          0.1, 0.1)[0]
Tg, _ = icp.icp_align_batched(pb, nb, mb, grid, torch.eye(4)[None], 0.1,
                              np.deg2rad(60.0))
dense = dense_nn.build_dense_index(pts, nrm, device="cpu")
di, _, _ = search.nearest_gated(dense, torch.from_numpy(pts[:50]),
                                torch.from_numpy(nrm[:50]), 0.1, 0.5)
_, _, cnt = hashgrid.radius_knn(grid, torch.from_numpy(pts[:50]), 0.05, 8)
assert 0.0 < sg[0] <= 1.0 and torch.isfinite(Tg).all(), (sg, Tg)
assert (di.numpy() == np.arange(50)).all() and (cnt > 0).all()
assert min(hashgrid.PLAIN_CALLS.values()) > 0
assert dense_nn.PLAIN_CALLS["dense_nearest"] > 0
from rescan_tpu_torch.core import native
from rescan_tpu_torch.pipeline import create_eval_files, seg2rsdb
from rescan_tpu_torch.eval import (instance_transfer, semantic_instance,
                                   semantic_label)
from rescan_tpu_torch.ops import distance_field
from rescan_tpu_torch.viewer import cli, render
conf = torch.zeros((42, 42), dtype=torch.int64)
semantic_label.accumulate_confusion(np.array([5, 7]), np.array([5, 5]), conf)
df = distance_field.build_distance_field(pts, 0.1, 0.3, device="cpu")
img = render.render_points(pts, np.ones_like(pts), render.look_at(
    [2.0, 2.0, 2.0], [0.5, 0.5, 0.5]), 64, 48, device="cpu")
assert int(conf[5, 5]) == 1 and img.shape == (48, 64, 3)
assert float(df.lookup(pts[:5]).max()) == 0.0
assert native._load()._name == native.library_path(), native._load()._name
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "rescan_tpu" or m.startswith("rescan_tpu."))
assert not loaded, loaded
print("NOJAX_OK")
"""


def test_port_imports_no_jax():
    """In a fresh interpreter with JAX_PLATFORMS=cpu kept (under which
    rescan_tpu/__init__ would import JAX), every port module imports, the
    mesh module, the copied stages, the evaluators and the viewer
    included, and the CPU path scores, aligns, counts, builds a distance
    field and renders, on one device and on a CPU mesh, with neither JAX
    nor any module of the JAX package loaded, and the native library
    loaded from the port's own build."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout


def _imports_of_jax_package(path):
    """(line, module) of every import of rescan_tpu or jax in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in ("rescan_tpu", "jax")]
    return bad


def test_port_sources_import_no_jax_package():
    """No module of the port, and not chip_smoke.py, imports rescan_tpu
    (or JAX), at the top or inside a function."""
    files = sorted(glob.glob(os.path.join(ROOT, "rescan_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    found = {os.path.relpath(f, ROOT): _imports_of_jax_package(f)
             for f in files}
    assert {os.path.join("rescan_tpu_torch", *f.split("/")) for f in (
        "eval/semantic_label.py", "eval/instance_transfer.py",
        "eval/semantic_instance.py", "viewer/render.py", "viewer/cli.py",
        "ops/distance_field.py", "ops/hashgrid.py",
        "ops/dense_nn.py")} <= set(found)
    assert not {f: b for f, b in found.items() if b}


def test_import_scan_sees_every_form(tmp_path):
    """The scan above catches each way of writing such an import."""
    path = tmp_path / "m.py"
    path.write_text("import rescan_tpu\nimport rescan_tpu.io.ply as p\n"
                    "from rescan_tpu.core import native\n"
                    "from rescan_tpu import x\n"
                    "def f():\n    import jax.numpy\n"
                    "from . import config\nimport rescan_tpu_torch\n")
    assert [n for _, n in _imports_of_jax_package(str(path))] == [
        "rescan_tpu", "rescan_tpu.io.ply", "rescan_tpu.core", "rescan_tpu",
        "jax.numpy"]


def test_kernel_loader_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: a clear error, and no silent fallback to the CPU."""
    from torch.utils import cpp_extension
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(gnn, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(gnn, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gnn.load_library()


def test_grid_kernel_loader_without_nvcc_raises(tmp_path, monkeypatch):
    """The grid and dense kernels' library too: no nvcc, a clear error."""
    from torch.utils import cpp_extension
    from rescan_tpu_torch.ops import hashgrid
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(gnn, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(hashgrid, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        hashgrid.load_library()


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


def _room_db(pkg, path):
    """The small room as a database in ``pkg``'s data model, read with its
    own io: chair, table, wall and floor objects, the rescan as scene 1
    with proposals for every object, and a scene-0 arrangement."""
    PointCloud = importlib.import_module(f"{pkg}.core.pointcloud").PointCloud
    rs = importlib.import_module(f"{pkg}.io.rsdb")
    scene = PointCloud.from_ply(path)
    db = rs.Rsdb()
    db.class_table = {n: i for i, n in enumerate(synthetic.NYU40_CLASSES)}
    L0 = scene.levels[0]
    rng = np.random.default_rng(9)
    poses, scores, arr = [], [], []
    for uid in (3, 4, 1, 0):
        sel = L0["instance_ids"] == uid
        cls = int(np.bincount(L0["class_ids"][sel]).argmax())
        sub = scene.extract_by_ids(0, "instance_ids", [uid],
                                   compute_levels=True)
        db.objects.append(rs.RsObject(uidx=uid, filename=f"o{uid}.ply",
                                      class_idx=cls, cloud=sub))
        P = np.tile(np.eye(4, dtype=np.float32), (12, 1, 1))
        P[:, 0, 3] = rng.uniform(-0.3, 0.3, 12)
        P[:, 2, 3] = rng.uniform(-0.3, 0.3, 12)
        P[3] = P[2]                                  # a duplicate pose
        poses.append(P)
        scores.append(rng.uniform(0.0, 1.0, 12).astype(np.float32))
        arr.append(rs.Placement(uid, 0, len(db.objects) - 1, 0, np.eye(4),
                                0.9))
    for i in range(2):
        db.scenes.append(rs.RsScene(uidx=i, arrangement_idx=i,
                                    scn_filename=path, cloud=scene))
    db.arrangements = [arr, []]
    db.proposed_poses = [None, poses]
    db.proposed_scores = [None, scores]
    return db


@pytest.fixture(scope="module")
def room_dbs(tmp_path_factory):
    """(port database, JAX-package database) of the same room."""
    d = tmp_path_factory.mktemp("helpers")
    spec = synthetic.SceneSpec(room_size=(1.6, 1.6), wall_height=0.9,
                               objects=[
        ("chair", (0.45, 0.45), (0.35, 0.5, 0.35), 0.0),
        ("table", (1.1, 1.0), (0.5, 0.4, 0.35), 0.0)])
    path = str(d / "scene.ply")
    synthetic.save_scene_ply(path, spec, resolution=6)
    return _room_db("rescan_tpu_torch", path), _room_db("rescan_tpu", path)


def test_non_maxima_suppression_copy(room_dbs):
    db_t, db_j = room_dbs
    for (pa, sa), (pb, sb) in zip(
            tpp.non_maxima_suppression(
                db_t, list(zip(db_t.proposed_poses[1],
                               db_t.proposed_scores[1]))),
            jpp.non_maxima_suppression(
                db_j, list(zip(db_j.proposed_poses[1],
                               db_j.proposed_scores[1])))):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(sa, sb)


def test_scene_saliency_copy(room_dbs):
    a, b = (copy.deepcopy(d) for d in room_dbs)
    tst.compute_scene_saliency(a, 1)
    jst.compute_scene_saliency(b, 1)
    qa = a.scenes[1].cloud.levels[0]["qualities"]
    np.testing.assert_array_equal(qa, b.scenes[1].cloud.levels[0]["qualities"])
    assert 0 < qa.sum() < len(qa)


def test_add_static_objects_copy(room_dbs):
    a, b = (copy.deepcopy(d) for d in room_dbs)
    tst.add_static_objects(a, 1)
    jst.add_static_objects(b, 1)
    assert len(a.arrangements[1]) == len(b.arrangements[1]) == 2
    for x, y in zip(a.arrangements[1], b.arrangements[1]):
        assert (x.uidx, x.object_idx) == (y.uidx, y.object_idx)
        np.testing.assert_array_equal(x.pose, y.pose)
