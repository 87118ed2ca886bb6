"""The port's copies of the JAX package's host modules (config, io, core,
utils, ops.{voxel,planes,energy}, pipeline.{seg2rsdb,create_eval_files,
fuse_models}) against the originals: the same numpy inputs through both,
equal outputs, and byte-identical files. The native functions run from
each package's own build of native/rescan_host.cpp."""

import dataclasses
import filecmp
import importlib
import io
import os
import stat
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

JAX, PORT = "rescan_tpu", "rescan_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mods(name):
    """(original, copy) of module ``name`` (e.g. "io.ply")."""
    return tuple(importlib.import_module(f"{p}.{name}") for p in (JAX, PORT))


def _same_dirs(a, b):
    """Every file under a and b byte-identical, and the same file names."""
    names_a = sorted(os.path.relpath(os.path.join(r, f), a)
                     for r, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(r, f), b)
                     for r, _, fs in os.walk(b) for f in fs)
    assert names_a == names_b
    for n in names_a:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names_a


def _assert_equal(x, y, path="value"):
    """Recursive exact equality of arrays, dataclasses, dicts and lists
    (dataclasses compared by class name and fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        assert type(x).__name__ == type(y).__name__, path
        for f in dataclasses.fields(x):
            _assert_equal(getattr(x, f.name), getattr(y, f.name),
                          f"{path}.{f.name}")
    elif isinstance(x, dict):
        assert sorted(x) == sorted(y), path
        for k in x:
            _assert_equal(x[k], y[k], f"{path}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), path
        for i, (a, b) in enumerate(zip(x, y)):
            _assert_equal(a, b, f"{path}[{i}]")
    elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        np.testing.assert_array_equal(x, y, err_msg=path)
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
    else:
        assert x == y or (x != x and y != y), (path, x, y)


ROOM = dict(room_size=(1.6, 1.6), wall_height=0.9, objects=[
    ("chair", (0.45, 0.45), (0.35, 0.5, 0.35), 0.0),
    ("table", (1.1, 1.0), (0.5, 0.4, 0.35), 0.0)])


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The small room written by each package's synthetic + ply writer,
    and its class file; returns the original's paths (the files are
    checked byte-identical)."""
    out = {}
    for pkg in (JAX, PORT):
        d = tmp_path_factory.mktemp(f"room_{pkg}")
        syn = importlib.import_module(f"{pkg}.utils.synthetic")
        syn.save_scene_ply(str(d / "scan_000.ply"), syn.SceneSpec(**ROOM),
                           resolution=6, seed=0)
        syn.write_class_file(str(d / "nyu40_classes.txt"))
        out[pkg] = d
    _same_dirs(out[JAX], out[PORT])
    return str(out[JAX] / "scan_000.ply"), str(out[JAX] / "nyu40_classes.txt")


# ---------------------------------------------------------------------------
# config, utils
# ---------------------------------------------------------------------------

def test_config_copy():
    a, b = mods("config")
    names = [n for n in dir(a) if n.isupper()]
    assert names and names == [n for n in dir(b) if n.isupper()]
    for n in names:
        _assert_equal(getattr(a, n), getattr(b, n), n)
    _assert_equal(a.ArrangementOpts(), b.ArrangementOpts())


def test_rng_copy():
    a, b = mods("utils.rng")
    ra, rb = a.MshRand(12345), b.MshRand(12345)
    assert [ra.next_u32() for _ in range(50)] == [rb.next_u32() for _ in
                                                  range(50)]
    assert [ra.next_range(3, 99_999) for _ in range(50)] == [
        rb.next_range(3, 99_999) for _ in range(50)]
    w = np.random.default_rng(0).random(40)
    da, db = a.MshDiscreteDistribution(w, 7), b.MshDiscreteDistribution(w, 7)
    assert [da.sample() for _ in range(200)] == [db.sample() for _ in
                                                 range(200)]
    pa, pb = a.distrib2pdf(w), b.distrib2pdf(w)
    np.testing.assert_array_equal(pa, pb)
    assert [a.pdfsample_linear(pa, p) for p in np.linspace(0, 1, 33)] == [
        b.pdfsample_linear(pb, p) for p in np.linspace(0, 1, 33)]


def test_timing_copy():
    outs = []
    for m in mods("utils.timing"):
        m.reset_timings()
        buf = io.StringIO()
        with redirect_stdout(buf):
            with m.stage_timer("x", "took %fs"):
                pass
        outs.append((sorted(m.STAGE_TIMINGS), buf.getvalue()[:5]))
        m.reset_timings()
    assert outs[0] == outs[1] == (["x"], "took ")


def test_synthetic_copy():
    a, b = mods("utils.synthetic")
    assert a.NYU40_CLASSES == b.NYU40_CLASSES
    for spec in ("default", "moved", "noisy"):
        sa = {"default": a.default_scene_spec, "noisy": a.noisy_scene_spec,
              "moved": lambda: a.moved_scene_spec(a.default_scene_spec())}
        sb = {"default": b.default_scene_spec, "noisy": b.noisy_scene_spec,
              "moved": lambda: b.moved_scene_spec(b.default_scene_spec())}
        xa, xb = sa[spec](), sb[spec]()
        _assert_equal(xa, xb, spec)
        _assert_equal(a.make_scene_mesh(xa, resolution=5),
                      b.make_scene_mesh(xb, resolution=5), spec)


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_paths_copy():
    a, b = mods("io.paths")
    for name in ("/d/roomA/scan_001.rsdb", "x/scan_000_pp.rsdb", "s.rsdb"):
        for f in ("model_folder_name", "pose_proposal_filename"):
            assert getattr(a, f)(name) == getattr(b, f)(name)
    assert a.output_segmentation_scene_filename("/d/roomA/scan_001") == \
        b.output_segmentation_scene_filename("/d/roomA/scan_001")
    for s in ("/d/roomA/gt_segmentation/scan_000.ply",
              "/d/roomA/predictions/scan_001.ply"):
        assert a.extract_method_name(s) == b.extract_method_name(s)


def test_ply_copy(room, tmp_path):
    """Reads equal; the surfel writer's files byte-identical."""
    ply, _ = room
    a, b = mods("io.ply")
    ca, cb = a.load_surfel_ply(ply), b.load_surfel_ply(ply)
    _assert_equal(ca, cb)
    _assert_equal(a.read_ply(ply), b.read_ply(ply))
    a.save_surfel_ply(str(tmp_path / "a.ply"), ca)
    b.save_surfel_ply(str(tmp_path / "b.ply"), cb)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    pos = ca["positions"]
    faces = np.random.default_rng(1).integers(0, len(pos), (100, 3)).astype(
        np.int32)
    np.testing.assert_array_equal(a.compute_vertex_normals(pos, faces),
                                  b.compute_vertex_normals(pos, faces))


def test_seg2rsdb_and_rsdb_copy(room, tmp_path, monkeypatch):
    """seg2rsdb's .rsdb and object .ply files byte-identical; the .rsdb
    codec, the database loader, pose proposals and arrangement blobs read
    equal and write byte-identical."""
    ply, classes = room
    dbs = {}
    for pkg in (JAX, PORT):
        s2r = importlib.import_module(f"{pkg}.pipeline.seg2rsdb")
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        with redirect_stdout(io.StringIO()):
            assert s2r.main([ply, classes, "scan_000.rsdb"]) == 0
        dbs[pkg] = d
    files = _same_dirs(dbs[JAX], dbs[PORT])
    assert "scan_000.rsdb" in files and len(files) > 2

    ra, rb = mods("io.rsdb")
    path = str(dbs[JAX] / "scan_000.rsdb")
    da, db = ra.load_rsdb(path), rb.load_rsdb(path)
    _assert_equal(da, db)
    ga, gb = mods("core.database")
    monkeypatch.chdir(dbs[JAX])
    la, lb = ga.load_database(path), gb.load_database(path)
    assert len(la.objects) == len(lb.objects) > 2
    for oa, ob in zip(la.objects + la.scenes, lb.objects + lb.scenes):
        _assert_equal(oa.cloud.levels, ob.cloud.levels)

    rng = np.random.default_rng(3)
    poses = [rng.normal(size=(k, 4, 4)).astype(np.float32) for k in (3, 0, 2)]
    scores = [rng.random(len(p)).astype(np.float32) for p in poses]
    arr_a = [ra.Placement(4, 0, 1, 2, poses[0][1], 0.75)]
    arr_b = [rb.Placement(4, 0, 1, 2, poses[0][1], 0.75)]
    for m, d, arr in ((ra, da, arr_a), (rb, db, arr_b)):
        out = tmp_path / m.__name__
        out.mkdir()
        monkeypatch.chdir(out)   # the .rsdb records its model folder
        d.arrangements[0] = arr
        m.save_rsdb("db.rsdb", d, save_objects=False)
        m.save_pose_proposals("pp.bin", poses, scores)
        m.save_arrangement("arr.bin", arr)
        _assert_equal(m.load_pose_proposals("pp.bin"), (poses, scores))
    _same_dirs(tmp_path / ra.__name__, tmp_path / rb.__name__)
    _assert_equal(ra.load_arrangement(str(tmp_path / ra.__name__ / "arr.bin")),
                  rb.load_arrangement(str(tmp_path / rb.__name__ / "arr.bin")))


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

def test_pointcloud_copy(room, tmp_path):
    """LoD levels equal, and what the stages call on a cloud."""
    ply, _ = room
    a, b = mods("core.pointcloud")
    pa, pb = a.PointCloud.from_ply(ply), b.PointCloud.from_ply(ply)
    assert len(pa.levels) == len(pb.levels) == 5
    _assert_equal(list(pa.levels), list(pb.levels))
    _assert_equal(pa.bbox, pb.bbox)
    for lvl in (0, 2):
        np.testing.assert_array_equal(pa.centroid(lvl), pb.centroid(lvl))
        np.testing.assert_array_equal(pa.covariance(lvl), pb.covariance(lvl))
    oa = pa.extract_by_ids(0, "instance_ids", [3], compute_levels=True)
    ob = pb.extract_by_ids(0, "instance_ids", [3], compute_levels=True)
    _assert_equal(list(oa.levels), list(ob.levels))
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.02, 0.0, -0.01]
    assert oa.pt2pt_alignment_score(pa, T, 0.05, 2) == \
        ob.pt2pt_alignment_score(pb, T, 0.05, 2)
    oa.transform(T, compute_levels=True)
    ob.transform(T, compute_levels=True)
    _assert_equal(list(oa.levels), list(ob.levels))
    _assert_equal(list(oa.merge_with(pa).levels[:1]),
                  list(ob.merge_with(pb).levels[:1]))
    oa.save_ply(str(tmp_path / "a.ply"))
    ob.save_ply(str(tmp_path / "b.ply"))
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    deferred = b.PointCloud.from_ply(ply, defer_levels_from=3)
    _assert_equal(list(pa.levels), list(deferred.levels))


def _native_cases():
    """name -> f(native module) -> outputs, on seeded inputs (each call
    makes its own inputs, so both modules get the same)."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    pts[1500:1600] = pts[:100]
    nrm = rng.normal(size=(3000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    n_l = 6
    lab = rng.integers(0, n_l, 3000).astype(np.int32)
    U = (rng.integers(0, 3, (3000, n_l)) * 15).astype(np.float32)
    U[np.arange(3000), lab] = 0
    src = rng.integers(0, 3000, 9000).astype(np.int32)
    dst = rng.integers(0, 3000, 9000).astype(np.int32)
    w = np.floor(rng.random(9000) * 4).astype(np.float32) * 2
    cents = rng.normal(size=(50, 3))
    sig = rng.normal(size=(50, 3, 3))
    sig = np.ascontiguousarray(sig @ sig.transpose(0, 2, 1) + np.eye(3))
    weights = rng.random(200)

    def graph(nat):
        idx, d2, cnt = nat.HostGrid(pts, 0.05).radius_search(pts, 0.05, 8)
        return idx, d2, cnt, nat.smooth_graph(idx, d2, nrm, np.float32(0.0025),
                                              2, 4)

    def cov(nat):
        r = np.random.default_rng(8)
        cnt = r.integers(0, 3, 4000).astype(np.int32)
        old = np.unique(r.integers(0, 4000, 300)).astype(np.int64)
        new = np.unique(r.integers(0, 4000, 300)).astype(np.int64)
        return nat.cov_update(cnt, old, new), cnt

    def icm(nat):
        off, nbr, ww = nat.csr_from_edges(src, dst, w, 3000)
        q0 = np.eye(n_l, dtype=np.float32)[lab]
        mask = np.random.default_rng(2).random((4, 3000)) < 0.5
        return nat.meanfield_icm(U, off, nbr, ww, 10, 0.25, q0, mask)

    def swap(nat):
        off, nbr, ww = nat.csr_from_edges(src, dst, w, 3000)
        return nat.abswap(U, off, nbr, ww, lab, n_cycles=2)

    cases = {
        "poisson_subsample": lambda nat: nat.poisson_subsample(pts, 0.03),
        "resample_stream": lambda nat: nat.resample_stream(
            weights[:100], 5000, 11, 13),
        "plane_counts": lambda nat: nat.plane_counts(
            pts, (lab > 1).astype(np.uint8), nrm[:40], pts[:40, 1], 0.02),
        "plane_gather": lambda nat: nat.plane_gather(
            pts, nrm, pts[:20], nrm[:20], 0.8, 0.03),
        "alias_build": lambda nat: nat.alias_build(weights),
        "radius_search+smooth_graph": graph,
        "csr_from_edges": lambda nat: nat.csr_from_edges(src, dst, w, 3000),
        "pair_penalties": lambda nat: nat.pair_penalties(
            np.ascontiguousarray(cents[0]), np.ascontiguousarray(sig[0]),
            cents, sig, 1.5),
        "cov_update": cov,
        "ransac_triplets": lambda nat: [
            nat.ransac_triplets(*nat.alias_build(weights), 5, 300, r)
            for r in (False, True)],
        "overlap_counts": lambda nat: [
            nat.overlap_counts(pts[:1500], pts[1400:] + 0.01,
                               np.float32([-0.2, -0.2, -0.2]),
                               np.int32([30, 30, 30]), 0.05, inside)
            for inside in (False, True)],
        "merge_shuffle": lambda nat: nat.merge_shuffle(5000, 99),
        "meanfield_icm": icm,
        "abswap": swap,
        "union_find": lambda nat: nat.union_find(
            3000, src[:2000].astype(np.int64), dst[:2000].astype(np.int64)),
    }
    return cases


NATIVE = _native_cases()


@pytest.mark.parametrize("name", sorted(NATIVE))
def test_native_copy(name):
    """Each native function the port calls: the port's library (its own
    g++ build) gives the JAX package's library's outputs."""
    a, b = mods("core.native")
    assert b._load()._name == b.library_path()
    assert os.path.dirname(b.library_path()).endswith(
        os.path.join("rescan_tpu_torch", "_build"))
    _assert_equal(NATIVE[name](a), NATIVE[name](b))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises with the compiler's stderr."""
    _, b = mods("core.native")
    src = tmp_path / "bad.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(b, "_SRC", str(src))
    monkeypatch.setattr(b, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        b._bind(b.library_path())


# ---------------------------------------------------------------------------
# ops: voxel, planes, energy on the room
# ---------------------------------------------------------------------------

def _room_db(pkg, ply):
    """tests/test_energy_fast.py's database shape on the small room, in
    ``pkg``'s data model: chair and table with proposals, two past
    arrangements."""
    PointCloud = importlib.import_module(f"{pkg}.core.pointcloud").PointCloud
    rs = importlib.import_module(f"{pkg}.io.rsdb")
    syn = importlib.import_module(f"{pkg}.utils.synthetic")
    scene = PointCloud.from_ply(ply)
    db = rs.Rsdb()
    db.class_table = {n: i for i, n in enumerate(syn.NYU40_CLASSES)}
    for k, inst in enumerate([3, 4]):
        sub = scene.extract_by_ids(0, "instance_ids", [inst],
                                   compute_levels=True)
        db.objects.append(rs.RsObject(uidx=inst, filename=f"o{inst}.ply",
                                      class_idx=5 + k, cloud=sub))
    for s in range(3):
        db.scenes.append(rs.RsScene(uidx=s, arrangement_idx=s,
                                    scn_filename=ply, cloud=scene))

    def T(dx, dz):
        m = np.eye(4, dtype=np.float32)
        m[0, 3], m[2, 3] = dx, dz
        return m

    poses = [np.stack([T(0, 0), T(0.3, 0.1), T(-0.2, 0.4)]),
             np.stack([T(0, 0), T(0.1, -0.3)])]
    scores = [np.array([0.9, 0.7, 0.6], np.float32),
              np.array([0.8, 0.65], np.float32)]
    db.arrangements = [[rs.Placement(3, 0, 0, 0, T(0.05, 0.0), 0.9)],
                       [rs.Placement(3, 0, 0, 1, T(0.25, 0.1), 0.7),
                        rs.Placement(4, 0, 1, 0, T(0.0, 0.0), 0.6)], []]
    db.proposed_poses = [None, None, poses]
    db.proposed_scores = [None, None, scores]
    return db


def test_voxel_copy(room):
    ply, _ = room
    a, b = mods("ops.voxel")
    da, db = _room_db(JAX, ply), _room_db(PORT, ply)
    oa, ob = da.objects[0].cloud, db.objects[0].cloud
    pose = db.proposed_poses[2][0][1]
    wa, ba = a.posed_points(oa, pose)
    wb, bb = b.posed_points(ob, pose)
    _assert_equal((wa, ba), (wb, bb))
    origin, res = a.grid_shape(*ba, 0.05)
    _assert_equal((origin, res), b.grid_shape(*bb, 0.05))
    ga = a.rasterize_boundary(oa.pos(1), pose, origin, res, 0.05)
    gb = b.rasterize_boundary(ob.pos(1), pose, origin, res, 0.05)
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(a.fill_occupancy(ga), b.fill_occupancy(gb))
    for engine in ("native", "numpy"):
        for inside in (True, False):
            fa = a.overlap_factor(oa, np.eye(4), da.objects[1].cloud, pose,
                                  voxelize_inside=inside, engine=engine)
            fb = b.overlap_factor(ob, np.eye(4), db.objects[1].cloud, pose,
                                  voxelize_inside=inside, engine=engine)
            assert fa == fb
        assert a.overlap_factor(oa, np.eye(4), oa, pose, engine=engine) == \
            b.overlap_factor(ob, np.eye(4), ob, pose, engine=engine) > 0


def test_planes_copy(room):
    """Plane detection, features, classes and the wall/floor relabel."""
    ply, _ = room
    a, b = mods("ops.planes")
    out = []
    for m, pkg in ((a, JAX), (b, PORT)):
        db = _room_db(pkg, ply)
        scene = db.scenes[2].cloud
        models = m.detect_planes(scene)
        m.compute_plane_features(scene, models)
        m.classify_planes(scene, models)
        m.relabel_walls_and_floors(db, scene, models)
        out.append((models, scene.levels[1]))
    assert len(out[0][0]) > 0
    _assert_equal(out[0], out[1])


def test_energy_copy(room):
    """Context, every term, greedy and simulated annealing (native loop)."""
    ply, _ = room
    a, b = mods("ops.energy")
    ca, cb = mods("config")
    res = []
    for m, cfg, pkg in ((a, ca, JAX), (b, cb, PORT)):
        db = _room_db(pkg, ply)
        ctx = m.build_context(db, 2, db.proposed_poses[2],
                              db.proposed_scores[2])
        rs = importlib.import_module(f"{pkg}.io.rsdb")
        arr = [rs.Placement(3, 2, 0, 1, db.proposed_poses[2][0][1], 0.7),
               rs.Placement(4, 2, 1, 0, db.proposed_poses[2][1][0], 0.8)]
        terms = (m.coverage_score(ctx, db, arr), m.geometry_score(arr),
                 m.intersection_score(ctx, db, arr),
                 m.hysteresis_score(db, arr, 2),
                 m.scene_alignment_score(ctx, db, arr,
                                         cfg.ENERGY_WEIGHTS_SA, 2))
        opts = cfg.ArrangementOpts(n_sa_iter=300, n_past_steps=2)
        m.greedy_optimize(ctx, db, 2, opts)
        greedy = list(db.arrangements[2])
        m.simulated_annealing(ctx, db, 2, opts)
        res.append((ctx, terms, greedy, db.arrangements[2]))
    assert len(res[0][3]) > 0
    _assert_equal(res[0], res[1])


# ---------------------------------------------------------------------------
# pipeline: create_eval_files, fuse_models
# ---------------------------------------------------------------------------

def test_create_eval_files_copy(room, tmp_path):
    ply, _ = room
    seq = tmp_path / "roomA" / "gt_segmentation"
    seq.mkdir(parents=True)
    (seq / "scan_000.ply").write_bytes(open(ply, "rb").read())
    for m in mods("pipeline.create_eval_files"):
        out = tmp_path / m.__name__
        with redirect_stdout(io.StringIO()):
            assert m.main([str(seq / "scan_000.ply"), str(out)]) == 0
            m.run(str(seq / "scan_000.ply"), str(out / "lvl1"), level=1)
    files = _same_dirs(tmp_path / "rescan_tpu.pipeline.create_eval_files",
                       tmp_path / "rescan_tpu_torch.pipeline."
                       "create_eval_files")
    assert len(files) >= 4


_FAKE_RECON = """#!{py}
import shutil, sys
a = sys.argv
shutil.copy(a[a.index("--in") + 1], a[a.index("--out") + 1])
print("Cycle[0] Depth[7/8] 0.1 s 12")
"""
_FAKE_TRIM = """#!{py}
import sys
a = sys.argv
open(a[a.index("--out") + 1], "w").write("trim " + a[a.index("--trim") + 1])
"""


def test_fuse_models_copy(tmp_path):
    """The Poisson/trimmer driving: the same commands, the same depth
    parsed from the recon's output, the same files."""
    exes = []
    for name, src in (("recon", _FAKE_RECON), ("trim", _FAKE_TRIM)):
        p = tmp_path / name
        p.write_text(src.format(py=sys.executable))
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
        exes.append(str(p))
    logs = []
    for m in mods("pipeline.fuse_models"):
        d = tmp_path / m.__name__
        d.mkdir()
        for k in range(2):
            (d / f"m{k}.ply").write_text(f"model {k}\n")
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert m.run_poisson_recon(exes[0], str(d / "m0.ply"),
                                       str(d / "r.ply")) == 7
            m.fuse_models(*exes, str(d))
        logs.append(buf.getvalue().replace(str(d), "<d>"))
    assert logs[0] == logs[1] and "TRIMMER_CMD" in logs[0]
    _same_dirs(tmp_path / "rescan_tpu.pipeline.fuse_models",
               tmp_path / "rescan_tpu_torch.pipeline.fuse_models")


@pytest.mark.parametrize("cap", [None, 2])
def test_build_grid_copy(room, cap):
    """hashgrid.build_grid's host build: the same sorted points, normals,
    permutation, cell offsets, origin, dims and cap, on the room's
    level-1 points and on no points at all."""
    from rescan_tpu.ops import hashgrid as jh
    from rescan_tpu_torch.ops import hashgrid as th
    ply, _ = room
    cloud = importlib.import_module(f"{PORT}.core.pointcloud") \
        .PointCloud.from_ply(ply)
    for pts, nrm in ((cloud.pos(1), cloud.nrm(1)),
                     (np.zeros((0, 3), np.float32), None)):
        a = jh.build_grid(pts, 0.05, normals=nrm, cap=cap)
        b = th.build_grid(pts, 0.05, normals=nrm, cap=cap, device="cpu")
        assert (a.cell, a.dims, a.cap) == (b.cell, b.dims, b.cap)
        for f in ("points", "normals", "perm", "cell_start", "origin"):
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert b.origin_host == tuple(np.asarray(a.origin).tolist())


@pytest.mark.parametrize("tile", [2048, 256])
def test_build_dense_index_copy(room, tile):
    """dense_nn.build_dense_index's host build: the same centred, padded
    points and normals, count and centre."""
    from rescan_tpu.ops import dense_nn as jd
    from rescan_tpu_torch.ops import dense_nn as td
    ply, _ = room
    cloud = importlib.import_module(f"{PORT}.core.pointcloud") \
        .PointCloud.from_ply(ply)
    for nrm in (cloud.nrm(1), None):
        a = jd.build_dense_index(cloud.pos(1), nrm, tile=tile)
        b = td.build_dense_index(cloud.pos(1), nrm, tile=tile, device="cpu")
        assert int(a.n_valid) == b.n_valid and a.tile == b.tile
        for f in ("points", "normals", "center"):
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
