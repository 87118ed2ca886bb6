"""The port's scoring (rescan_tpu_torch/ops/score.py) against the JAX
package's, and its copied numpy helpers against the originals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu.ops import pallas_nn, score as jscore
from rescan_tpu.pipeline import pose_proposal as jpp
from rescan_tpu_torch.ops import gnn, score as tscore
from rescan_tpu_torch.pipeline import pose_proposal as tpp


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
    xy = rng.uniform(0, 2, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(3.0 * xy[:, 1])
    pts = np.stack([xy[:, 0], z, xy[:, 1]], 1).astype(np.float32)
    nrm = np.stack([-0.6 * np.cos(2.0 * xy[:, 0]), np.ones(n),
                    0.6 * np.sin(3.0 * xy[:, 1])], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


@pytest.mark.parametrize("bmin,bmax", [
    ((0.0, 0.0, 0.0), (1.6, 0.9, 1.6)),
    ((-0.37, -0.1, 0.21), (3.93, 2.5, 4.05)),
])
def test_grid_search_hypotheses_copy(bmin, bmax):
    a = tscore.grid_search_hypotheses(np.array(bmin, np.float32),
                                      np.array(bmax, np.float32))
    b = jscore.grid_search_hypotheses(np.array(bmin, np.float32),
                                      np.array(bmax, np.float32))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [1, 50, 128, 300, 700, 2100])
def test_prep_points_copy(n):
    rng = np.random.default_rng(n)
    p = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 3)).astype(np.float32)
    for x, y in zip(tscore.prep_points(p, q), jscore.prep_points(p, q)):
        np.testing.assert_array_equal(x, y)


def _score_case(seed=0):
    rng = np.random.default_rng(seed)
    pts, nrm = _surface(rng, 6000)
    js = pallas_nn.build_sorted_slab(pts, nrm)
    slab = gnn.slab_from_numpy(np.asarray(js.slab),
                               np.asarray(js.tile_bounds),
                               np.asarray(js.perm), int(js.n_valid),
                               np.asarray(js.center), js.tile,
                               device="cpu")
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
    return js, slab, objs, hyps, owner


def test_score_multi_matches_jax():
    """Scores within 1e-6 of rescan_tpu.ops.score._score_multi on one slab
    (Pallas in interpret mode): the kernel results are bit-identical, and
    the pose transforms and reductions round in another order."""
    js, slab, objs, hyps, owner = _score_case()
    P = np.stack([o[0] for o in objs])
    N = np.stack([o[1] for o in objs])
    M = np.stack([o[2] for o in objs])
    ref = np.asarray(jscore._score_multi(
        js, jnp.asarray(P), jnp.asarray(N), jnp.asarray(M),
        jnp.asarray(hyps), jnp.asarray(owner.astype(np.int32)), 0.1, 0.1))
    got = tscore._score_multi(
        slab, torch.from_numpy(P), torch.from_numpy(N), torch.from_numpy(M),
        torch.from_numpy(hyps), torch.from_numpy(owner), 0.1, 0.1).numpy()
    assert (ref > 0.3).sum() > 50
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_score_stream_matches_single_launch(monkeypatch):
    """ScoreStream's grouping and slicing (several slices per group,
    mixed point counts, requests interleaved across groups) returns what
    one _score_multi launch per request returns."""
    rng = np.random.default_rng(2)
    pts, nrm = _surface(rng, 4000)
    slab = gnn.build_sorted_slab(pts, nrm, device="cpu")
    monkeypatch.setattr(tscore, "MAX_QUERIES_PER_LAUNCH", 128 * 7)
    reqs = []
    for k, n in enumerate((100, 300, 90, 250)):
        o = pts[k * 500:k * 500 + n] - [1, 0, 1]
        h = np.tile(np.eye(4, dtype=np.float32), (5 + 4 * k, 1, 1))
        h[:, :3, 3] = [1, 0, 1] + rng.uniform(-0.03, 0.03, (len(h), 3))
        reqs.append((o, nrm[k * 500:k * 500 + n], h))
    got = tscore.score_requests(slab, reqs, 0.1, 0.1)
    for (o, on, h), s in zip(reqs, got):
        P, N, M = tscore.prep_points(o, on)
        ref = tscore._score_multi(
            slab, torch.from_numpy(P[None]), torch.from_numpy(N[None]),
            torch.from_numpy(M[None]), torch.from_numpy(h),
            torch.zeros(len(h), dtype=torch.int64), 0.1, 0.1).numpy()
        assert len(s) == len(h)
        np.testing.assert_array_equal(s, ref)


def test_select_cell_best_copy():
    rng = np.random.default_rng(4)
    for n in (0, 1, 37, 5000):
        s = rng.choice([0.1, 0.3, 0.3, 0.5, 0.9], n).astype(np.float32)
        cell = np.repeat(np.arange((n + 9) // 10), 10)[:n]
        for thr in (0.25, 0.4):
            np.testing.assert_array_equal(
                tpp._select_cell_best(s, cell, thr),
                jpp._select_cell_best(s, cell, thr))


def test_scene_occupancy_copy():
    rng = np.random.default_rng(6)
    pts, nrm = _surface(rng, 5000)
    obj = pts[:300] - pts[:300].mean(0)
    onrm = nrm[:300]
    hyps = jscore.grid_search_hypotheses(pts.min(0), pts.max(0))[0][::7]
    a = tpp.SceneOccupancy(pts, 0.1, scene_nrm=nrm)
    b = jpp.SceneOccupancy(pts, 0.1, scene_nrm=nrm)
    np.testing.assert_array_equal(a.score_upper_bound(obj, hyps, onrm),
                                  b.score_upper_bound(obj, hyps, onrm))
    np.testing.assert_array_equal(a.score_upper_bound(obj, hyps),
                                  b.score_upper_bound(obj, hyps))
