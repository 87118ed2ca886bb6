"""The port's split index (rescan_tpu_torch/ops/gnn.py ``SlabSet``) against
the JAX package's (rescan_tpu/ops/pallas_nn.py ``SlabSet``).

Past ``MAX_SLAB_COLS * 0.94`` points both packages cut an index into
Morton-contiguous parts, each a slab about its own centre, and merge the
parts' answers with a strict ``<`` on d2. The limit is lowered here in
both packages, so that a few thousand points make two or three parts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu.ops import pallas_nn, score as jscore, search as jsearch
from rescan_tpu_torch.ops import gnn, score as tscore, search
from rescan_tpu_torch.utils import timing
from scanbench import harness
from test_torch_gnn_emulated import _run, emu  # noqa: F401 (a fixture)

RADIUS = 0.15
# the float64 search and the f32 one about each part's centre pick the
# same neighbour wherever the two best qualifying d2 differ by more than
# this, and no point lies this close to the radius or the gate: points
# and queries lie in [0, 2] m, so each coordinate about a centre is
# rounded to f32 by at most 2^-24 x 2 m = 1.2e-7 m, a difference by at
# most 2.4e-7 m, and at |d| <= r = 0.15 m a d2 by at most
# 2 x 0.15 x sqrt(3) x 2.4e-7 + a last rounding of 2^-24 x r^2, about
# 1.3e-7 m^2; the normal dot's three f32 products by a few 1e-7
D2_TOL = 1e-6
DOT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n=3000, m=700, dup=200):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    pts[n // 2:n // 2 + dup] = pts[:dup]            # duplicates force ties
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(0, 2, (m, 3)).astype(np.float32)
    q[:50] = pts[:50]                               # d2 == 0 against a tie
    q = q[gnn.morton_order(q)]
    qn = rng.normal(size=(m, 3)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    return pts, nrm, q, qn


def _lower_limit(monkeypatch, n: int, parts: int) -> None:
    """Both packages' limit, lowered so that ``n`` points make ``parts``
    parts."""
    cols = int(np.ceil(n / (0.94 * (parts - 0.5))))
    assert int(np.ceil(n / (cols * 0.94))) == parts
    monkeypatch.setattr(pallas_nn, "MAX_SLAB_COLS", cols)
    monkeypatch.setattr(gnn, "MAX_SLAB_COLS", cols)


def _both(pts, nrm, tile=1024):
    js = pallas_nn.build_sorted_slab(pts, nrm, tile=tile)
    ts = search.build_index(pts, RADIUS, normals=nrm, tile=tile,
                            device="cpu")
    assert isinstance(js, pallas_nn.SlabSet) and isinstance(ts, gnn.SlabSet)
    assert len(ts.slabs) == len(js.slabs) and ts.n_total == js.n_total
    return js, ts


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _emulated(lib):
    """``gnn._launch`` through the emulated kernel, on CPU tensors."""
    def launch(slab, q_pos, q_nrm, radius, cos_gate, use_abs_dot, want_idx):
        return _run(lib, slab, q_pos.contiguous(), q_nrm.contiguous(),
                    radius, cos_gate, use_abs_dot, want_idx)
    return launch


@pytest.mark.parametrize("use_abs_dot,cos_gate", [(False, 0.5),
                                                  (True, 0.5)])
@pytest.mark.parametrize("parts", [2, 3])
def test_set_bit_identical_to_jax(monkeypatch, emu, parts,  # noqa: F811
                                  use_abs_dot, cos_gate):
    """K2's (idx, d2, dot) and K1's (d2, dot) over the set equal the JAX
    package's ``nearest_gated_set`` / ``gated_min_set``, through the plain
    version and through the kernel's source on the emulated card; so do
    the set's points and normals in original order."""
    pts, nrm, q, qn = _data(11 + parts, m=500)
    _lower_limit(monkeypatch, len(pts), parts)
    js, ts = _both(pts, nrm)
    jq, jqn = jnp.asarray(q), jnp.asarray(qn)
    ref = pallas_nn.nearest_gated_set(js, jq, jqn, RADIUS, cos_gate,
                                      use_abs_dot=use_abs_dot, bq=128)
    ref1 = pallas_nn.gated_min_set(js, jq, jqn, RADIUS, cos_gate,
                                   use_abs_dot=use_abs_dot, bq=128)
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    assert (np.asarray(ref[0]) >= 0).sum() > 200
    # every part answers some queries best
    owner = np.searchsorted(np.cumsum([s.n_valid for s in ts.slabs]),
                            np.argsort(np.concatenate(
                                [s.perm[s.perm >= 0].numpy()
                                 for s in ts.slabs])), side="right")
    found = np.asarray(ref[0])[np.asarray(ref[0]) >= 0]
    assert len(set(owner[found])) == parts

    gnn.reset_counts()
    plain = search.nearest_gated(ts, qt, qnt, RADIUS, cos_gate, use_abs_dot)
    plain1 = search.gated_min(ts, qt, qnt, RADIUS, cos_gate, use_abs_dot)
    assert gnn.PLAIN_CALLS == {"gated_min": parts, "nearest_gated": parts,
                               "gated_min_set": 1, "nearest_gated_set": 1}
    monkeypatch.setattr(gnn, "_check_device", lambda q_pos: True)
    monkeypatch.setattr(gnn, "_launch", _emulated(emu))
    card = search.nearest_gated(ts, qt, qnt, RADIUS, cos_gate, use_abs_dot)
    card1 = gnn.gated_min(ts, qt, qnt, RADIUS, cos_gate, use_abs_dot)
    assert gnn.LAUNCHES["gated_min_set"] == gnn.LAUNCHES[
        "nearest_gated_set"] == 1
    for got in (plain, card):
        for a, b in zip(ref, got):
            _same_bits(a, b.numpy())
    for a, b in zip(ref1, card1):
        _same_bits(a, b.numpy())
    for a, b in zip(ref1, plain1):
        _same_bits(a, b.numpy())
    for a, b in zip(jsearch.index_arrays(js), search.index_arrays(ts)):
        _same_bits(a, b.numpy())


def _brute_force(pts, nrm, q, qn, radius, cos_gate):
    """Every (query, point) pair in float64: the qualifying points' d2
    (inf where a point does not qualify) and how near each pair lies to
    the radius or the gate."""
    p = torch.from_numpy(pts).double()
    d = torch.from_numpy(q).double()[:, None, :] - p[None]
    d2 = (d * d).sum(-1)
    dot = (torch.from_numpy(qn).double() @ torch.from_numpy(nrm).double().T
           ).clamp_min(0.0)
    thr = np.float64(np.float32(np.float32(cos_gate) - np.float32(1e-6)))
    ok = (d2 < radius * radius) & (dot >= thr)
    edge = (((d2 - radius * radius).abs() <= D2_TOL)
            | (((dot - thr).abs() <= DOT_TOL)
               & (d2 < radius * radius + D2_TOL))).any(1)
    return torch.where(ok, d2, torch.inf), edge


@pytest.mark.parametrize("parts", [2, 3])
def test_set_agrees_with_a_float64_brute_force(monkeypatch, parts):
    """A plain float64 search of all points, in torch ops alone, finds
    the set's neighbour wherever its two best qualifying d2 lie more than
    D2_TOL apart and no pair of the query lies within the tolerances of
    the radius or the gate."""
    pts, nrm, q, qn = _data(31 + parts, m=900)
    _lower_limit(monkeypatch, len(pts), parts)
    ts = search.build_index(pts, RADIUS, normals=nrm, device="cpu")
    assert len(ts.slabs) == parts
    idx, d2, dot = search.nearest_gated(ts, torch.from_numpy(q),
                                        torch.from_numpy(qn), RADIUS, 0.5)
    bd2, edge = _brute_force(pts, nrm, q, qn, RADIUS, 0.5)
    two = bd2.topk(2, dim=1, largest=False)
    clear = ((two.values[:, 1] - two.values[:, 0] > D2_TOL)
             | torch.isinf(two.values[:, 0])) & ~edge
    assert clear.sum() > 0.8 * len(q)
    hit = clear & torch.isfinite(two.values[:, 0])
    assert hit.sum() > 300
    want = torch.where(torch.isfinite(two.values[:, 0]), two.indices[:, 0],
                       -1)
    np.testing.assert_array_equal(idx[clear].numpy(),
                                  want[clear].numpy().astype(np.int32))
    np.testing.assert_allclose(d2[hit].double().numpy(),
                               two.values[hit, 0].numpy(), rtol=0,
                               atol=D2_TOL)


def test_scoring_over_a_split_scene_matches_jax(monkeypatch):
    """One object's hypotheses scored through ``ScoreStream`` against a
    scene index split in two equal the JAX package's scores on its own
    split index at the same limit, bit for bit."""
    rng = np.random.default_rng(0)
    xz = rng.uniform(0, 2, (6000, 2)).astype(np.float32)
    y = 0.3 * np.sin(2.0 * xz[:, 0]) + 0.2 * np.cos(3.0 * xz[:, 1])
    pts = np.stack([xz[:, 0], y, xz[:, 1]], 1).astype(np.float32)
    nrm = np.stack([-0.6 * np.cos(2.0 * xz[:, 0]), np.ones(6000),
                    0.6 * np.sin(3.0 * xz[:, 1])], 1)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    _lower_limit(monkeypatch, len(pts), 2)
    js = pallas_nn.build_sorted_slab(pts, nrm)
    ts = search.build_index(pts, 0.1, normals=nrm, device="cpu")
    assert isinstance(ts, gnn.SlabSet) and len(js.slabs) == 2
    # an object across the cut between the parts
    near = np.abs(pts[:, 0] - np.median(pts[:, 0])) < 0.4
    obj = pts[near][:200] - [1, 0, 1]
    obj_n = nrm[near][:200]
    H = 96
    hyps = np.tile(np.eye(4, dtype=np.float32), (H, 1, 1))
    ang = rng.uniform(-0.2, 0.2, H)
    hyps[:, 0, 0] = np.cos(ang)
    hyps[:, 0, 2] = np.sin(ang)
    hyps[:, 2, 0] = -np.sin(ang)
    hyps[:, 2, 2] = np.cos(ang)
    hyps[:, :3, 3] = [1, 0, 1] + rng.uniform(-0.05, 0.05, (H, 3))
    P, N, M = jscore.prep_points(obj, obj_n)
    ref = np.asarray(jscore._score_multi(
        js, jnp.asarray(P[None]), jnp.asarray(N[None]), jnp.asarray(M[None]),
        jnp.asarray(hyps), jnp.zeros(H, jnp.int32), 0.1, 0.1))
    gnn.reset_counts()
    (got,) = tscore.score_requests(ts, [(obj, obj_n, hyps)], 0.1, 0.1)
    assert gnn.PLAIN_CALLS["gated_min_set"] == 1
    assert (ref > 0.3).sum() > 20
    np.testing.assert_array_equal(got, ref)


def test_an_index_at_the_limit_is_the_single_slab(monkeypatch):
    """Up to ``int(MAX_SLAB_COLS * 0.94)`` points (369,623 by default, the
    JAX package's limit) ``build_index`` builds the one slab it built
    before the split existed; one point more makes a set."""
    assert int(gnn.MAX_SLAB_COLS * 0.94) == int(pallas_nn.MAX_SLAB_COLS
                                               * 0.94) == 369623
    pts, nrm, _, _ = _data(3)
    monkeypatch.setattr(gnn, "MAX_SLAB_COLS", 2000)
    n = int(2000 * 0.94)
    one = search.build_index(pts[:n], RADIUS, normals=nrm[:n], device="cpu")
    assert isinstance(one, gnn.SortedSlab)
    monkeypatch.setattr(gnn, "MAX_SLAB_COLS", 10 ** 9)
    before = search.build_index(pts[:n], RADIUS, normals=nrm[:n],
                                device="cpu")
    for f in ("slab", "tile_bounds", "perm", "center", "run_bounds"):
        assert torch.equal(getattr(one, f), getattr(before, f)), f
    assert one.n_valid == before.n_valid == n
    monkeypatch.setattr(gnn, "MAX_SLAB_COLS", 2000)
    two = search.build_index(pts[:n + 1], RADIUS, normals=nrm[:n + 1],
                             device="cpu")
    assert isinstance(two, gnn.SlabSet) and len(two.slabs) == 2


def test_the_split_is_traced_and_read_by_the_benchmark(monkeypatch):
    """Inside a stage the split's seconds (``slab_split``), its parts
    (``slab_parts``), the merges' seconds (``set_merge``) and the query
    rows searched again (``gated_min_set_requeries``) reach the stage's
    timings, and the benchmark's readers take them from a record."""
    pts, nrm, q, qn = _data(5)
    _lower_limit(monkeypatch, len(pts), 3)
    timings = {}
    with timing.stage("pose_proposal", timings):
        ts = search.build_index(pts, RADIUS, normals=nrm, device="cpu")
        search.gated_min(ts, torch.from_numpy(q), torch.from_numpy(qn),
                         RADIUS, 0.5)
        search.nearest_gated(ts, torch.from_numpy(q), torch.from_numpy(qn),
                             RADIUS, 0.5)
    assert timings["slab_parts"] == 3
    # K1's alone: K2's set calls add to no count
    assert timings["gated_min_set_requeries"] == 2 * len(q)
    assert not any(k.startswith("nearest_gated") for k in timings)
    assert timings["slab_split"] > 0 and timings["set_merge"] > 0
    folder = harness.HERE
    rec = {"rescans": [{"pose_proposal": timings, "segment_transfer": {}}],
           "launches": [("gated_min", len(q), s.n_valid) for s in ts.slabs],
           "kernel_s": {"void gnn_kernel<false, false>": 1e-3}}
    assert harness.reader("slab_split_s", folder)(rec) == \
        timings["slab_split"]
    assert harness.reader("set_merge_s", folder)(rec) == timings["set_merge"]
    # one search of the whole index: the queries once, every point once
    want = 100.0 * (len(q) * 32 + len(pts) * 24) / 3.35e12 / 1e-3
    assert harness.reader("k1_set_roofline", folder)(rec) == \
        pytest.approx(want, rel=1e-12)
    # a program that splits nothing gives none of the three
    bare = {"rescans": [{"pose_proposal": {}, "segment_transfer": {}}],
            "launches": rec["launches"], "kernel_s": rec["kernel_s"]}
    for name in ("slab_split_s", "set_merge_s", "k1_set_roofline"):
        assert harness.reader(name, folder)(bare) is None
