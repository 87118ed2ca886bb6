"""The port's single-process mesh (rescan_tpu_torch/parallel/mesh.py) on 8
CPU shard slots, against the port's single-device path and against the
JAX package's mesh on conftest's 8 virtual CPU devices."""

import copy
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu import config
from rescan_tpu.core.pointcloud import PointCloud
from rescan_tpu.io import rsdb as jrsdb
from rescan_tpu.ops import hashgrid, icp as jicp, labels as jlabels, pallas_nn
from rescan_tpu.parallel import mesh as jmesh
from rescan_tpu.pipeline import pose_proposal as jpp
from rescan_tpu.utils import synthetic
from rescan_tpu_torch import sequences
from rescan_tpu_torch.core.pointcloud import PointCloud as TPointCloud
from rescan_tpu_torch.io import rsdb as trsdb
from rescan_tpu_torch.ops import gnn, icp as ticp, labels as tlabels, pairsum
from rescan_tpu_torch.ops import score as tscore
from rescan_tpu_torch.parallel import mesh as tmesh
from rescan_tpu_torch.pipeline import driver as tdriver
from rescan_tpu_torch.pipeline import pose_proposal as tpp

CPU8 = ["cpu"] * 8
MAX_ANGLE = float(np.deg2rad(60.0))
REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_small_ref.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface(rng, n):
    """A wavy surface with analytic normals (non-degenerate for pt2pl)."""
    xy = rng.uniform(0, 2, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(3.0 * xy[:, 1])
    pts = np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32)
    nrm = np.stack([-0.6 * np.cos(2.0 * xy[:, 0]),
                    0.6 * np.sin(3.0 * xy[:, 1]), np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def _rigid(theta, t):
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[:3, 3] = t
    return m


def _slab_pair(pts, nrm, tile=1024):
    """One slab on both sides: JAX's, and the port's copy of it."""
    js = pallas_nn.build_sorted_slab(pts, nrm, tile=tile)
    return js, gnn.slab_from_numpy(
        np.asarray(js.slab), np.asarray(js.tile_bounds), np.asarray(js.perm),
        int(js.n_valid), np.asarray(js.center), js.tile, device="cpu")


def _residual(p, Ta, Tb):
    a = p @ Ta[:3, :3].T + Ta[:3, 3]
    b = p @ Tb[:3, :3].T + Tb[:3, 3]
    return float(np.abs(a - b).mean())


# ---------------------------------------------------------------------------
# Mesh layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pairs,n_points,n_devices", [
    (16, 8192, 8), (5, 8192, 8), (4, 8192, 8), (2, 8192, 8), (1, 8192, 8),
    (1, 1024, 8), (1, 512, 8), (2, 1024, 4), (3, 4096, 4), (1, 2048, 4),
    (1, 1536, 8), (7, 65536, 16), (0, 1024, 2), (2, 8192, 1),
])
def test_refine_sp_factor_matches_jax(n_pairs, n_points, n_devices):
    assert (tmesh.refine_sp_factor(n_pairs, n_points, n_devices)
            == jmesh.refine_sp_factor(n_pairs, n_points, n_devices))


def test_mesh_layout():
    """(dp, sp) row-major over the slot list, as make_mesh reshapes the
    JAX devices; a flat view keeps the slots."""
    m = tmesh.make_mesh(8, sp=2, devices=CPU8)
    jm = jmesh.make_mesh(8, sp=2)
    assert m.shape == {"dp": jm.shape["dp"], "sp": jm.shape["sp"]}
    assert m.flat().shape == {"dp": 8, "sp": 1}
    assert tmesh.make_mesh(6, sp=4, devices=CPU8).size == 4
    assert tmesh.make_flat_mesh(3, devices=CPU8).size == 3
    with pytest.raises(ValueError):
        tmesh.Mesh(["cpu"] * 6, sp=4)


def test_resolve_devices():
    assert tmesh.resolve_devices("cpu") == [torch.device("cpu")]
    assert tmesh.resolve_devices(None, CPU8) == [torch.device("cpu")] * 8
    with pytest.raises(ValueError):
        tmesh.resolve_devices("cpu", [])


def test_default_devices_without_card_raise(monkeypatch):
    """No device named and no card: the stages and the driver raise
    before doing any work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("RESCAN_DEVICES", "4")
    for call in (lambda: tmesh.resolve_devices(),
                 lambda: tmesh.make_flat_mesh(),
                 lambda: tpp.run("missing.rsdb", "missing.ply", "out.rsdb"),
                 lambda: tdriver.run_sequence("missing", "classes.txt")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cross_sum_under_thread_switching():
    """16 slots (more than the cores) chaining rank-dependent runs of
    points for many rounds with a tiny switch interval: every rank gets
    every round's exact total, and the launch counter loses no update."""
    n, rounds = 16, 60
    m = tmesh.Mesh(["cpu"] * n, sp=n)
    group = tmesh._CrossSum(m, range(n))
    spec = [(pairsum.WINDOW, 0, pairsum.ONE)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    gnn.reset_counts()
    try:
        def work(i):
            hook = group.hook(i)
            got = []
            for k in range(rounds):
                t = hook(torch.full((3, 1, 1), float(i * rounds + k)), spec)
                got.append(t[:, 0].clone())
                gnn._count(gnn.PLAIN_CALLS, "gated_min")
            return torch.stack(got)
        out = m.run(work)
    finally:
        sys.setswitchinterval(old)
    want = torch.tensor([sum(i * rounds + k for i in range(n))
                         for k in range(rounds)], dtype=torch.float32)
    for t in out:
        torch.testing.assert_close(t, want[:, None].expand(-1, 3),
                                   rtol=0, atol=0)
    assert gnn.PLAIN_CALLS["gated_min"] == n * rounds


def test_failed_rank_does_not_hang_its_row():
    """A rank that raises aborts its row's barrier: the others fail fast
    and the first real error is the one raised."""
    m = tmesh.Mesh(["cpu"] * 4, sp=4)
    group = tmesh._CrossSum(m, range(4))

    def work(i):
        try:
            if i == 2:
                raise KeyError("rank 2")
            return group.hook(i)(torch.ones(1, 1, 1),
                                 [(pairsum.WINDOW, 0, pairsum.ONE)])
        except BaseException:
            group.barrier.abort()
            raise

    raised = []

    def drive():
        try:
            m.run(work)
        except Exception as e:
            raised.append(e)

    t = threading.Thread(target=drive)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(raised) == 1 and isinstance(raised[0], KeyError)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def score_case():
    rng = np.random.default_rng(0)
    pts, nrm = _surface(rng, 6000)
    pts = pts[:, [0, 2, 1]]
    nrm = nrm[:, [0, 2, 1]]
    js, slab = _slab_pair(pts, nrm, tile=2048)
    objs = [tscore.prep_points(pts[k * 400:k * 400 + 150] - [1, 0, 1],
                               nrm[k * 400:k * 400 + 150])
            for k in range(3)]
    H = 240
    hyps = np.tile(np.eye(4, dtype=np.float32), (H, 1, 1))
    ang = rng.uniform(-0.2, 0.2, H)
    hyps[:, 0, 0] = np.cos(ang)
    hyps[:, 0, 2] = np.sin(ang)
    hyps[:, 2, 0] = -np.sin(ang)
    hyps[:, 2, 2] = np.cos(ang)
    hyps[:, :3, 3] = [1, 0, 1] + rng.uniform(-0.05, 0.05, (H, 3))
    owner = rng.integers(0, 3, H)
    tabs = tuple(np.stack([o[k] for o in objs]) for k in range(3))
    return pts, nrm, js, slab, tabs, hyps, owner


def test_score_multi_sharded(score_case):
    """Hypotheses over 8 slots: bit-identical to the port's one launch,
    and within 1e-6 of JAX's score_multi_sharded on 8 devices (same slab,
    Pallas in interpret mode; pose transforms and reductions round in
    another order, as in test_torch_score)."""
    _, _, js, slab, tabs, hyps, owner = score_case
    m = tmesh.make_flat_mesh(devices=CPU8)
    T = [torch.from_numpy(a) for a in tabs]
    got = m.gather(tmesh.score_multi_sharded(
        m, slab, *T, hyps, owner, 0.1, 0.1)).numpy()
    single = tscore._score_multi(slab, *T, torch.from_numpy(hyps),
                                 torch.from_numpy(owner), 0.1, 0.1).numpy()
    np.testing.assert_array_equal(got, single)
    ref = np.asarray(jmesh.score_multi_sharded(
        jmesh.make_flat_mesh(8), js, *(jnp.asarray(a) for a in tabs),
        jnp.asarray(hyps), jnp.asarray(owner.astype(np.int32)), 0.1, 0.1))
    assert (ref > 0.3).sum() > 50
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_score_stream_mesh_matches_single(score_case, monkeypatch):
    """The mesh ScoreStream (full slices rounded down to 8, tails padded
    up to 8, several groups and slices) returns the single-device
    stream's scores bit for bit."""
    pts, nrm, _, slab, _, _, _ = score_case
    rng = np.random.default_rng(2)
    monkeypatch.setattr(tscore, "MAX_QUERIES_PER_LAUNCH", 128 * 21)
    reqs = []
    for k, n in enumerate((100, 300, 90, 250, 600)):
        # a compact patch of the surface, moved to the origin
        c = rng.uniform(0.4, 1.6, 2)
        sel = np.argsort(((pts[:, [0, 2]] - c) ** 2).sum(1))[:n]
        o = pts[sel] - [c[0], 0, c[1]]
        h = np.tile(np.eye(4, dtype=np.float32), (5 + 7 * k, 1, 1))
        h[:, :3, 3] = [c[0], 0, c[1]] + rng.uniform(-0.03, 0.03,
                                                    (len(h), 3))
        reqs.append((o, nrm[sel], h))
    single = tscore.score_requests(slab, reqs, 0.1, 0.1)
    got = tscore.score_requests(slab, reqs, 0.1, 0.1,
                                mesh=tmesh.make_flat_mesh(devices=CPU8))
    assert sum((s > 0.3).sum() for s in single) > 20
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a, b)


def test_score_hypotheses_sharded(score_case):
    """Hypotheses over dp = 4, object points over sp = 2, partial sums
    added over sp: within 1e-5 of JAX's score_hypotheses_sharded on its
    (4, 2) mesh and of the port's single launch."""
    pts, nrm, _, slab, _, hyps, _ = score_case
    obj = pts[:500] - [1, 0, 1] + np.float32([0.01, 0.005, 0.0])
    objn = nrm[:500]
    h = hyps[:13]
    got = tmesh.score_hypotheses_sharded(
        tmesh.make_mesh(8, sp=2, devices=CPU8), slab, obj, objn, h, 0.1,
        0.1)
    # JAX's function takes the HashGrid (its shard_map checks the Pallas
    # kernel's outputs for mesh-axis annotations the slab path lacks)
    ref = jmesh.score_hypotheses_sharded(
        jmesh.make_mesh(8, sp=2), hashgrid.build_grid(pts, 0.1, normals=nrm),
        obj, objn, h, 0.1, 0.1)
    P, N, M = tscore.prep_points(obj, objn)
    single = tscore._score_multi(
        slab, torch.from_numpy(P[None]), torch.from_numpy(N[None]),
        torch.from_numpy(M[None]), torch.from_numpy(h),
        torch.zeros(len(h), dtype=torch.int64), 0.1, 0.1).numpy()
    assert (ref > 0.3).sum() > 3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def icp_case():
    """Five well-conditioned pairs: 900-point patches of the surface moved
    off their place, two objects shared among the pairs."""
    rng = np.random.default_rng(12345)
    scene_pts, scene_nrm = _surface(rng, 2500)
    moves = [_rigid(0.04, [0.03, -0.02, 0.01]), _rigid(0.02, [0.02, 0.01, 0]),
             _rigid(-0.03, [0.0, 0.025, 0.005])]
    objs = []
    for k, T in enumerate(moves[:2]):
        inv = np.linalg.inv(T)
        src = slice(k * 900, k * 900 + 900)
        objs.append(((scene_pts[src] @ inv[:3, :3].T + inv[:3, 3])
                     .astype(np.float32),
                     (scene_nrm[src] @ inv[:3, :3].T).astype(np.float32)))
    upts, unrm, umask = ticp.prep_unique_batch([o[0] for o in objs],
                                               [o[1] for o in objs])
    own = np.array([0, 1, 0, 1, 0], np.int32)
    val = np.ones(5, bool)
    T0 = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    T0[2] = moves[2]
    T0[3, :3, 3] = [0.005, 0.0, -0.004]
    js, slab = _slab_pair(scene_pts, scene_nrm)
    return objs, (upts, unrm, umask, own, val, T0), js, slab


def test_icp_indexed_sharded(icp_case):
    """Pairs over 8 slots: identical to the port's single loop, and within
    1e-6 of JAX's single-device loop, which stops at the port's iteration
    count. JAX's icp_refine_indexed_sharded on 8 devices hands each device
    one pair, and XLA compiles a launch of one pair with other sums
    (ops/pairsum.py), more than 1e-5 away from its own single-device loop
    here (1.1e-4 on pairs 0 and 4): the port's ICP of each pair alone,
    which takes the one-pair orders, is within 1e-5 of it (same slab).
    The port's mesh keeps the many-pair orders: the stages mesh only
    batches that the JAX package pads to 256 pairs."""
    _, (upts, unrm, umask, own, val, T0), js, slab = icp_case
    m = tmesh.make_flat_mesh(devices=CPU8)
    T_sh, err_sh = tmesh.icp_refine_indexed_sharded(
        m, slab, upts, unrm, umask, own, val, T0, 0.1, MAX_ANGLE)
    tT, terr, tact, n_iter = ticp.icp_align_indexed(
        *(torch.from_numpy(a) for a in (upts, unrm, umask, own, val)), slab,
        torch.from_numpy(T0), 0.1, MAX_ANGLE)
    assert not tact.any() and 5 < n_iter < 40
    np.testing.assert_array_equal(T_sh, tT.numpy())
    np.testing.assert_array_equal(err_sh, terr.numpy())
    jT, _ = jmesh.icp_refine_indexed_sharded(
        jmesh.make_flat_mesh(8), js, upts, unrm, umask, own, val, T0, 0.1,
        MAX_ANGLE)
    T_one = np.stack([ticp.icp_align_indexed(
        *(torch.from_numpy(a) for a in (upts, unrm, umask, own[k:k + 1],
                                        val[k:k + 1])), slab,
        torch.from_numpy(T0[k:k + 1]), 0.1, MAX_ANGLE)[0][0].numpy()
        for k in range(len(T0))])
    np.testing.assert_allclose(T_one, jT, rtol=0, atol=1e-5)
    jargs = (jnp.asarray(upts), jnp.asarray(unrm), jnp.asarray(umask),
             jnp.asarray(own), jnp.asarray(val), js, jnp.asarray(T0), 0.1,
             MAX_ANGLE)
    jS = np.asarray(jicp.icp_align_indexed(*jargs)[0])
    np.testing.assert_allclose(T_sh, jS, rtol=0, atol=1e-6)
    # JAX's mesh is not its single-device loop
    assert np.abs(np.asarray(jT) - jS).max() > 1e-5
    _, _, jact = jicp.icp_align_indexed(*jargs, max_iter=n_iter)
    assert not np.asarray(jact).any()
    _, _, jact = jicp.icp_align_indexed(*jargs, max_iter=n_iter - 1)
    assert np.asarray(jact).any()


def test_icp_batched_sharded(icp_case):
    """The materialised batch over 8 slots: identical to the port's
    icp_align_batched, and within 1e-6 of JAX's icp_align_batched; with
    the one-pair orders of JAX's 8 devices (each pair alone, see
    test_icp_indexed_sharded), within 1e-5 of JAX's icp_refine_sharded."""
    _, (upts, unrm, umask, own, _, T0), js, slab = icp_case
    pb, nb, mb = upts[own], unrm[own], umask[own]
    m = tmesh.make_flat_mesh(devices=CPU8)
    T_sh, err_sh = tmesh.icp_refine_sharded(m, slab, pb, nb, mb, T0, 0.1,
                                            MAX_ANGLE)
    tT, terr = ticp.icp_align_batched(
        *(torch.from_numpy(a) for a in (pb, nb, mb)), slab,
        torch.from_numpy(T0), 0.1, MAX_ANGLE)
    np.testing.assert_array_equal(T_sh, tT.numpy())
    np.testing.assert_array_equal(err_sh, terr.numpy())
    jS, _ = jicp.icp_align_batched(jnp.asarray(pb), jnp.asarray(nb),
                                   jnp.asarray(mb), js, jnp.asarray(T0), 0.1,
                                   MAX_ANGLE)
    np.testing.assert_allclose(T_sh, np.asarray(jS), rtol=0, atol=1e-6)
    jT, _ = jmesh.icp_refine_sharded(jmesh.make_mesh(8), js, pb, nb, mb, T0,
                                     0.1, MAX_ANGLE)
    T_one = np.stack([ticp.icp_align_batched(
        *(torch.from_numpy(a[k:k + 1]) for a in (pb, nb, mb)), slab,
        torch.from_numpy(T0[k:k + 1]), 0.1, MAX_ANGLE)[0][0].numpy()
        for k in range(len(T0))])
    np.testing.assert_allclose(T_one, jT, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_slots,sp", [(8, 2), (8, 4), (4, 2)])
def test_icp_dpsp(n_slots, sp):
    """Pairs over dp, each pair's points over sp, per-pair sums added over
    sp: mean aligned-point residual under 1e-3 against the port's single
    loop and against JAX's icp_refine_indexed_dpsp (the bar of
    tests/test_parallel.py), on tests/test_parallel.py's scene."""
    r = np.random.default_rng(7)
    pts = r.uniform(0, 2, (8000, 3)).astype(np.float32)
    pts[:, 1] *= 0.1
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (8000, 1))
    js, slab = _slab_pair(pts, nrm)
    objs = [pts[:1024] + np.array([0.02, 0.01, 0], np.float32),
            pts[2000:3024] + np.array([0.015, 0.0, 0.01], np.float32)]
    nrms = [nrm[:1024], nrm[2000:3024]]
    upts, unrm, umask = ticp.prep_unique_batch(objs, nrms)
    own = np.array([0, 1, 0], np.int32)
    val = np.ones(3, bool)
    T0 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    tT, _, _, _ = ticp.icp_align_indexed(
        *(torch.from_numpy(a) for a in (upts, unrm, umask, own, val)), slab,
        torch.from_numpy(T0), 0.1, MAX_ANGLE)
    T_sh, _ = tmesh.icp_refine_indexed_dpsp(
        tmesh.make_mesh(n_slots, sp=sp, devices=CPU8), slab, upts, unrm,
        umask, own, val, T0, 0.1, MAX_ANGLE)
    jT, _ = jmesh.icp_refine_indexed_dpsp(
        jmesh.make_mesh(n_slots, sp=sp), js, upts, unrm, umask, own, val, T0,
        0.1, MAX_ANGLE)
    for k in range(3):
        p = objs[own[k]]
        assert _residual(p, tT.numpy()[k], T_sh[k]) < 1e-3
        assert _residual(p, np.asarray(jT)[k], T_sh[k]) < 1e-3


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def test_propose_poses_for_object_with_mesh(tmp_path):
    """The grid search of one object through the production stage code,
    sharded over 8 slots: the single-device result bit for bit, and
    against JAX's propose_poses_for_object (same slab) the same count,
    poses within 1e-6 and scores within 1e-5 (tests/test_parallel.py's
    bars)."""
    spec = synthetic.SceneSpec(room_size=(1.2, 1.2), wall_height=0.7,
                               objects=[("chair", (0.4, 0.4),
                                         (0.3, 0.4, 0.3), 0.0)])
    ply = str(tmp_path / "scene.ply")
    synthetic.save_scene_ply(ply, spec, resolution=5)
    # each package reads the scene with its own io
    scene_j, scene = PointCloud.from_ply(ply), TPointCloud.from_ply(ply)
    obj = scene.extract_by_ids(0, "instance_ids", [3], compute_levels=True)
    obj_j = scene_j.extract_by_ids(0, "instance_ids", [3],
                                   compute_levels=True)
    slvl = config.SCORE_SEARCH_LVL
    js, slab = _slab_pair(scene.pos(slvl), scene.nrm(slvl), tile=2048)
    occ = tpp.SceneOccupancy(scene.pos(slvl),
                             config.SCORE_SEARCH_RADII[slvl],
                             scene_nrm=scene.nrm(slvl))
    occ_j = jpp.SceneOccupancy(scene_j.pos(slvl),
                               config.SCORE_SEARCH_RADII[slvl],
                               scene_nrm=scene_j.nrm(slvl))
    p_1, s_1 = tpp.propose_poses_for_object(obj, slab, scene.bbox,
                                            occupancy=occ)
    p_m, s_m = tpp.propose_poses_for_object(
        obj, slab, scene.bbox, occupancy=occ,
        mesh=tmesh.make_flat_mesh(devices=CPU8))
    assert len(p_1) > 0
    np.testing.assert_array_equal(p_m, p_1)
    np.testing.assert_array_equal(s_m, s_1)
    p_j, s_j = jpp.propose_poses_for_object(obj_j, js, scene_j.bbox,
                                            occupancy=occ_j)
    assert len(p_m) == len(p_j)
    np.testing.assert_allclose(p_m, p_j, atol=1e-6)
    np.testing.assert_allclose(s_m, s_j, atol=1e-5)


def test_label_transfer_sharded(tmp_path):
    """arrangement_to_labels with the query axis over 8 slots: the
    single-device ids, and the JAX package's."""
    spec = synthetic.SceneSpec(room_size=(1.6, 1.6), wall_height=0.9,
                               objects=[
        ("chair", (0.45, 0.45), (0.35, 0.5, 0.35), 0.0),
        ("table", (1.1, 1.1), (0.4, 0.35, 0.3), 0.2)])
    ply = str(tmp_path / "scene.ply")
    synthetic.save_scene_ply(ply, spec, resolution=6)

    def build(Cloud, rs):
        """The database, scene and arrangement in one package's model."""
        scene = Cloud.from_ply(ply)
        db = rs.Rsdb()
        db.class_table = {n: i for i, n in
                          enumerate(synthetic.NYU40_CLASSES)}
        arr = []
        for k, uidx in enumerate((3, 4, 0)):
            sub = scene.extract_by_ids(0, "instance_ids", [uidx],
                                       compute_levels=True)
            db.objects.append(rs.RsObject(uidx=uidx, filename=f"o{uidx}.ply",
                                          class_idx=5 + k, cloud=sub))
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = 0.01 * k
            arr.append(rs.Placement(uidx, 0, k, 0, pose, 0.9))
        db.scenes.append(rs.RsScene(uidx=0, arrangement_idx=0,
                                    scn_filename=ply, cloud=scene))
        return db, scene, arr

    db, scene, arr = build(TPointCloud, trsdb)
    db_j, sj, arr_j = build(PointCloud, jrsdb)
    out = {}
    for name, kw in (("single", {}),
                     ("mesh", {"mesh": tmesh.make_flat_mesh(devices=CPU8)})):
        s = copy.deepcopy(scene)
        tlabels.arrangement_to_labels(db, s, arr, device="cpu", **kw)
        out[name] = s.levels[config.LABEL_LVL]
    jlabels.arrangement_to_labels(db_j, sj, arr_j)
    lj = sj.levels[config.LABEL_LVL]
    assert len(np.unique(out["mesh"]["instance_ids"])) == len(arr) + 1
    for k in ("class_ids", "instance_ids"):
        np.testing.assert_array_equal(out["mesh"][k], out["single"][k])
        np.testing.assert_array_equal(out["mesh"][k], lj[k])


def test_small_sequence_on_cpu_mesh(tmp_path, monkeypatch):
    """The port's driver over the small 2-scan sequence on 8 CPU slots
    (scoring, ICP and label transfer sharded; the refine-to-scene ICP in
    its dp x sp mode when its pairs cannot fill the slots), held to the
    committed JAX outputs as chip_smoke.py holds the card."""
    class_file = sequences.write_small_sequence(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    calls = []
    real = tmesh.icp_refine_indexed_dpsp

    def spy(mesh2d, *a, **k):
        calls.append(mesh2d.shape)
        return real(mesh2d, *a, **k)

    monkeypatch.setattr(tmesh, "icp_refine_indexed_dpsp", spy)
    gnn.reset_counts()
    tdriver.run_sequence(sequences.SEQ_NAME, class_file, devices=CPU8)
    assert gnn.PLAIN_CALLS["gated_min"] > 0
    assert gnn.PLAIN_CALLS["nearest_gated"] > 0
    assert calls and all(c["dp"] * c["sp"] == 8 for c in calls)
    got = sequences.read_outputs(str(tmp_path))
    assert sequences.compare_outputs(dict(np.load(REF)), got) == []
