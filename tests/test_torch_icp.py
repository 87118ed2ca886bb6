"""The port's batched ICP (rescan_tpu_torch/ops/icp.py) against the JAX
package's, on the fixtures of tests/test_icp.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu.ops import hashgrid, icp as jicp, pallas_nn
from rescan_tpu_torch.ops import gnn, icp as ticp, search as tsearch

MAX_ANGLE = np.deg2rad(60.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_surface(rng, n=3000):
    """A wavy surface with analytic normals (non-degenerate for pt2pl)."""
    xy = rng.uniform(0, 2, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(3.0 * xy[:, 1])
    pts = np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32)
    gx = 0.6 * np.cos(2.0 * xy[:, 0])
    gy = -0.6 * np.sin(3.0 * xy[:, 1])
    nrm = np.stack([-gx, -gy, np.ones(n, np.float32)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def _rigid(theta, t):
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[:3, 3] = t
    return m


def _indexed_case(seed):
    """tests/test_icp.py's two-object, 8-pair indexed batch with offsets
    of varying difficulty."""
    rng = np.random.default_rng(seed)
    scene_pts, scene_nrm = _make_surface(rng, 2500)
    uobjs = [(scene_pts[:700], scene_nrm[:700]),
             (scene_pts[900:1500], scene_nrm[900:1500])]
    upts, unrm, umask = ticp.prep_unique_batch([o[0] for o in uobjs],
                                               [o[1] for o in uobjs])
    B = 8
    own = np.array([k % 2 for k in range(B)], np.int32)
    val = np.ones(B, bool)
    val[-1] = False                       # a padding pair stays put
    T0 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for k in range(B):
        T0[k] = _rigid(0.002 * (k + 1) ** 2, [0.004 * k, -0.003 * k, 0.0])
    return scene_pts, scene_nrm, (upts, unrm, umask, own, val, T0)


def _slab_pair(scene_pts, scene_nrm):
    js = pallas_nn.build_sorted_slab(scene_pts, scene_nrm, tile=1024)
    slab = gnn.slab_from_numpy(np.asarray(js.slab),
                               np.asarray(js.tile_bounds),
                               np.asarray(js.perm), int(js.n_valid),
                               np.asarray(js.center), js.tile,
                               device="cpu")
    return js, slab


def test_icp_step_matches_jax_slab_engine():
    """One iteration from the same state on both sides (same slab, Pallas
    in interpret mode), at the states of JAX's first four iterations:
    every pair within 1e-6, and the same active set. The correspondences
    are bit-identical, and the port forms every sum, product and the 6x6
    solve in the order XLA compiles them (ops/pairsum.py, ops/lu6.py):
    measured bit-identical at all four states, ill-conditioned pairs
    included; the rotation's cos and sin are XLA's own too
    (ops/xla_math.py)."""
    scene_pts, scene_nrm, (upts, unrm, umask, own, val, T0) = \
        _indexed_case(12345)
    js, slab = _slab_pair(scene_pts, scene_nrm)
    J = jnp.asarray
    obj_pts = torch.from_numpy(upts)[own]
    obj_nrm = torch.from_numpy(unrm)[own]
    obj_mask = torch.from_numpy(umask)[own] & torch.from_numpy(val)[:, None]
    scene_p, scene_n = tsearch.index_arrays(slab)
    T, err = J(T0), J(np.full(len(T0), 1e6, np.float32))
    active = J(umask[own].any(1) & val)
    dist = np.float32(0.10)
    for k in range(4):
        jT, jerr, jact = (np.asarray(x) for x in jicp.icp_align_indexed(
            J(upts), J(unrm), J(umask), J(own), J(val), js, T, dist,
            MAX_ANGLE, max_iter=k + 1, err_init=err, it_init=k))
        tT, terr, tact = ticp._icp_step(
            obj_pts, obj_nrm, obj_mask, slab, scene_p, scene_n,
            torch.from_numpy(np.array(T)), torch.from_numpy(np.array(err)),
            dist, torch.from_numpy(np.array(active)), k,
            ticp.cos_gate_of(MAX_ANGLE))
        dT = np.abs(tT.numpy() - jT).max(axis=(1, 2))
        assert dT.max() < 1e-6, (k, dT)
        np.testing.assert_allclose(terr.numpy(), jerr, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(tact.numpy(), jact)
        T, err, active = J(jT), J(jerr), J(jact)
        dist = np.maximum(np.float32(dist * np.float32(0.95)),
                          np.float32(0.05))


def _step_from_jax_state(k):
    """One port step from JAX's state after k iterations and the JAX
    step from the same state, both on the same slab, the port's call
    counts reset just before its step: ((T, err, active) of the port,
    the same of JAX)."""
    from rescan_tpu_torch.ops import pairsum
    scene_pts, scene_nrm, (upts, unrm, umask, own, val, T0) = \
        _indexed_case(12345)
    js, slab = _slab_pair(scene_pts, scene_nrm)
    J = jnp.asarray
    jargs = (J(upts), J(unrm), J(umask), J(own), J(val), js)
    dist = np.float32(0.10)
    T, err, active = J(T0), J(np.full(len(T0), 1e6, np.float32)), None
    if k:
        T, err, active = jicp.icp_align_indexed(*jargs, T, dist, MAX_ANGLE,
                                                max_iter=k)
        for _ in range(k):
            dist = np.maximum(np.float32(dist * np.float32(0.95)),
                              np.float32(0.05))
    active = np.array(active) if k else umask[own].any(1) & val
    assert active.sum() >= 6
    want = tuple(np.asarray(x) for x in jicp.icp_align_indexed(
        *jargs, T, dist, MAX_ANGLE, max_iter=k + 1, err_init=err,
        it_init=k))
    scene_p, scene_n = tsearch.index_arrays(slab)
    pairsum.reset_counts()
    got = ticp._icp_step(
        torch.from_numpy(upts)[own], torch.from_numpy(unrm)[own],
        torch.from_numpy(umask)[own] & torch.from_numpy(val)[:, None], slab,
        scene_p, scene_n, torch.from_numpy(np.array(T)),
        torch.from_numpy(np.array(err)), dist, torch.from_numpy(active), k,
        ticp.cos_gate_of(MAX_ANGLE))
    return tuple(v.numpy() for v in got), want


@pytest.mark.parametrize("k", [0, 6])
def test_icp_step_with_split_tail_matches_jax_bit_for_bit(k):
    """One iteration from JAX's state after k iterations (the first, and
    the first that tests convergence), both sides on the same slab: the
    step's tail runs as its own function (``_icp_tail``, here its plain
    version ``_icp_tail_ref``, once per step), and every pose, error and
    active flag equals the JAX step's bit for bit."""
    from rescan_tpu_torch.ops import pairsum
    got, want = _step_from_jax_state(k)
    assert pairsum.PLAIN_CALLS["icp_tail"] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [0, 6])
def test_icp_step_with_split_head_matches_jax_bit_for_bit(k, monkeypatch):
    """The same step with its head split: the per-point work between the
    rounds of sums runs as ``_icp_head``'s four forms in order (here the
    plain version ``_icp_head_ref``, each once per step), every form's
    operands and outputs are of the shapes the kernel takes, and every
    pose, error and active flag equals the JAX step's bit for bit."""
    from rescan_tpu_torch.ops import pairsum
    forms = []
    real = ticp._icp_head

    def spy(form, *args):
        out = real(form, *args)
        forms.append(form)
        dims = {"B": args[0].shape[0], "N": args[0].shape[1],
                "M": args[4].shape[0] if form == ticp.HEAD_A else 0}
        ops = args[:len(ticp._HEAD_OPERANDS[form])]
        for v, (shape, dtype) in zip(ops + out, ticp._HEAD_OPERANDS[form]
                                     + ticp._HEAD_OUTPUTS[form]):
            assert tuple(v.shape) == tuple(dims.get(d, d) for d in shape)
            assert v.dtype == dtype
        return out

    monkeypatch.setattr(ticp, "_icp_head", spy)
    got, want = _step_from_jax_state(k)
    assert forms == list(ticp.HEAD_FORMS)
    assert pairsum.PLAIN_CALLS["icp_head"] == len(ticp.HEAD_FORMS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_indexed_icp_matches_jax_slab_engine():
    """The whole loop on the two-object, 8-pair batch: every live pair
    within 1e-6 of JAX's pose and 1e-7 of its error, the same final
    active set, the padding pair untouched, and the same number of
    iterations: JAX's loop is still running after the port's count less
    one and done after the port's count (pair 1, the ill-conditioned
    one, runs 9). Measured bit-identical, pair 1 included (it drifted by
    3.1e-4 while the sums were a fixed tree; see
    test_icp_step_matches_jax_slab_engine)."""
    scene_pts, scene_nrm, (upts, unrm, umask, own, val, T0) = \
        _indexed_case(12345)
    js, slab = _slab_pair(scene_pts, scene_nrm)
    jargs = (jnp.asarray(upts), jnp.asarray(unrm), jnp.asarray(umask),
             jnp.asarray(own), jnp.asarray(val), js, jnp.asarray(T0), 0.10,
             MAX_ANGLE)
    jT, jerr, jact = (np.asarray(x) for x in jicp.icp_align_indexed(*jargs))
    tT, terr, tact, n_iter = ticp.icp_align_indexed(
        torch.from_numpy(upts), torch.from_numpy(unrm),
        torch.from_numpy(umask), torch.from_numpy(own),
        torch.from_numpy(val), slab, torch.from_numpy(T0), 0.10, MAX_ANGLE)
    np.testing.assert_allclose(tT.numpy()[val], jT[val], rtol=0, atol=1e-6)
    np.testing.assert_allclose(terr.numpy()[val], jerr[val], rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(tact.numpy(), jact)
    np.testing.assert_array_equal(tT.numpy()[~val], T0[~val])
    assert n_iter == 9
    _, _, act_short = jicp.icp_align_indexed(*jargs, max_iter=n_iter - 1)
    assert np.asarray(act_short)[1]
    _, _, act_done = jicp.icp_align_indexed(*jargs, max_iter=n_iter)
    assert not np.asarray(act_done).any()


@pytest.mark.parametrize("seed,theta,t", [
    (12345, 0.04, [0.03, -0.02, 0.01]),
    (7, 0.02, [0.02, 0.01, 0.0]),
])
def test_icp_matches_jax_slab_engine_well_conditioned(seed, theta, t):
    """One well-conditioned pair (a 900-point patch of the surface moved
    off its place), both sides on the same slab: poses within 1e-5, errors
    within 1e-6, and the same number of iterations — JAX's loop is still
    active after the port's count less one and done after the port's
    count."""
    rng = np.random.default_rng(seed)
    scene_pts, scene_nrm = _make_surface(rng, 2500)
    inv = np.linalg.inv(_rigid(theta, t))
    moved = (scene_pts[:900] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    moved_n = (scene_nrm[:900] @ inv[:3, :3].T).astype(np.float32)
    upts, unrm, umask = ticp.prep_unique_batch([moved], [moved_n])
    own, val = np.zeros(1, np.int32), np.ones(1, bool)
    T0 = np.eye(4, dtype=np.float32)[None]
    js, slab = _slab_pair(scene_pts, scene_nrm)
    jargs = (jnp.asarray(upts), jnp.asarray(unrm), jnp.asarray(umask),
             jnp.asarray(own), jnp.asarray(val), js, jnp.asarray(T0), 0.10,
             MAX_ANGLE)
    tT, terr, tact, n_iter = ticp.icp_align_indexed(
        *(torch.from_numpy(a) for a in (upts, unrm, umask, own, val)), slab,
        torch.from_numpy(T0), 0.10, MAX_ANGLE)
    assert not tact.any() and 5 < n_iter < 30
    jT, jerr, jact = (np.asarray(x) for x in
                      jicp.icp_align_indexed(*jargs, max_iter=n_iter))
    assert not jact.any()
    np.testing.assert_allclose(tT.numpy(), jT, rtol=0, atol=1e-5)
    np.testing.assert_allclose(terr.numpy(), jerr, rtol=0, atol=1e-6)
    _, _, act_short = jicp.icp_align_indexed(*jargs, max_iter=n_iter - 1)
    assert np.asarray(act_short).all()


@pytest.mark.parametrize("n_pts,seed", [(100, 1), (200, 3)])
def test_one_pair_icp_of_few_points_matches_jax_slab_engine(n_pts, seed):
    """One pair padded to 128 or 256 points (the augmentation ICP's
    smallest placements, segment_transfer.py:204-209): XLA folds the
    one-pair sums' vector lanes there (pairsum's FOLDED kinds); the
    port's whole loop equals the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    scene_pts, scene_nrm = _make_surface(rng, 2500)
    inv = np.linalg.inv(_rigid(0.03, [0.02, -0.01, 0.01]))
    sel = rng.choice(2500, n_pts, replace=False)
    moved = (scene_pts[sel] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    moved_n = (scene_nrm[sel] @ inv[:3, :3].T).astype(np.float32)
    upts, unrm, umask = ticp.pad_batch([moved], [moved_n])
    assert upts.shape[1] == (128 if n_pts <= 128 else 256)
    own, val = np.zeros(1, np.int32), np.ones(1, bool)
    T0 = np.eye(4, dtype=np.float32)[None]
    js, slab = _slab_pair(scene_pts, scene_nrm)
    jT, jerr, jact = (np.asarray(x) for x in jicp.icp_align_indexed(
        jnp.asarray(upts), jnp.asarray(unrm), jnp.asarray(umask),
        jnp.asarray(own), jnp.asarray(val), js, jnp.asarray(T0), 0.10,
        MAX_ANGLE))
    tT, terr, tact, _ = ticp.icp_align_indexed(
        *(torch.from_numpy(a) for a in (upts, unrm, umask, own, val)), slab,
        torch.from_numpy(T0), 0.10, MAX_ANGLE)
    np.testing.assert_array_equal(tT.numpy(), jT)
    np.testing.assert_array_equal(terr.numpy(), jerr)
    np.testing.assert_array_equal(tact.numpy(), jact)


def test_batched_icp_matches_jax_default_engine():
    """Against JAX's CPU default engine (the HashGrid), which computes d2
    with other roundings than the slab kernel: a correspondence can flip
    at the radius or gate edge, so poses are held to 1e-4 (the recovered
    transform itself is checked to 5 mm as in tests/test_icp.py)."""
    rng = np.random.default_rng(12345)
    scene_pts, scene_nrm = _make_surface(rng, 2500)
    obj_pts, obj_nrm = scene_pts[:900], scene_nrm[:900]
    true_T = _rigid(0.04, [0.03, -0.02, 0.01])
    inv = np.linalg.inv(true_T)
    moved = (obj_pts @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    moved_n = (obj_nrm @ inv[:3, :3].T).astype(np.float32)
    pts_b, nrm_b, mask_b = ticp.pad_batch([moved], [moved_n])
    T0 = np.eye(4, dtype=np.float32)[None]

    grid = hashgrid.build_grid(scene_pts, 0.10, normals=scene_nrm)
    jT, jerr = jicp.icp_align_batched(
        jnp.asarray(pts_b), jnp.asarray(nrm_b), jnp.asarray(mask_b), grid,
        jnp.asarray(T0), 0.10, MAX_ANGLE)
    slab = gnn.build_sorted_slab(scene_pts, scene_nrm, tile=1024,
                                 device="cpu")
    tT, terr = ticp.icp_align_batched(
        torch.from_numpy(pts_b), torch.from_numpy(nrm_b),
        torch.from_numpy(mask_b), slab, torch.from_numpy(T0), 0.10,
        MAX_ANGLE)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-4)
    T = tT.numpy()[0]
    res = moved @ T[:3, :3].T + T[:3, 3] - obj_pts
    assert float(np.abs(res).mean()) < 0.005
    assert float(terr[0]) < 0.01


def test_icp_no_correspondences():
    """Disjoint clouds: the transform comes back unchanged."""
    rng = np.random.default_rng(12345)
    a, an = _make_surface(rng, 500)
    b = a + np.array([100.0, 0, 0], np.float32)
    slab = gnn.build_sorted_slab(a, an, device="cpu")
    pts_b, nrm_b, mask_b = ticp.pad_batch([b], [an])
    T0 = np.eye(4, dtype=np.float32)[None]
    T, _ = ticp.icp_align_batched(
        torch.from_numpy(pts_b), torch.from_numpy(nrm_b),
        torch.from_numpy(mask_b), slab, torch.from_numpy(T0), 0.10,
        MAX_ANGLE)
    np.testing.assert_array_equal(T.numpy()[0], T0[0])


@pytest.mark.parametrize("sizes,n_min", [
    ((50,), 1), ((700, 130, 1), 1), ((3000, 40), 1), ((10, 20), 900),
])
def test_batch_padding_copies(sizes, n_min):
    rng = np.random.default_rng(len(sizes) + n_min)
    P = [rng.uniform(-1, 1, (k, 3)).astype(np.float32) for k in sizes]
    N = [rng.normal(size=(k, 3)).astype(np.float32) for k in sizes]
    for x, y in zip(ticp.pad_batch(P, N, n_min=n_min),
                    jicp.pad_batch(P, N, n_min=n_min)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(ticp.prep_unique_batch(P, N, n_min=n_min),
                    jicp.prep_unique_batch(P, N, n_min=n_min)):
        np.testing.assert_array_equal(x, y)
