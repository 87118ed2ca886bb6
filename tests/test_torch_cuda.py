"""The CUDA kernels (gated NN; per-pair sums, fma chains, the 6x6 solve,
XLA's f32 math, scoring's per-point terms, the ICP step's head and tail)
against their plain PyTorch versions, and the port's paths that run them,
on the card.

Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every test here needs a CUDA device and skips without one.
"""

import numpy as np
import pytest
import torch

from rescan_tpu_torch.ops import gnn, pairsum

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the distances of the edge-case slab: r, and the largest f32 below r
EDGE_R = 0.125
EDGE_IN = float(np.float32(1.125) - np.float32(2.0 ** -23)) - 1.0


def edge_slab(mixed: bool):
    """A slab laid out by hand (centre 0, tile 1024 = 32 runs of 32) whose
    columns sit on run boundaries at distance r or just inside it from the
    query point (the origin), with every other column of their runs
    farther out, so a run test without its margin drops them:

    - column 32, first of run 1: (r, 0, 0), d2 == r^2 exactly (not < r^2);
      the run's other columns lie at x > r, so its min x is r;
    - column 95, last of run 2: (-EDGE_IN, 0, 0), d2 < r^2, the answer;
      the run's other columns at x < -r, so its max x is -EDGE_IN;
    - column 96, first of run 3: (0, 0, EDGE_IN), the same d2 (a tie the
      lower column wins);
    - column 1024, first of tile 2: a duplicate of column 95, in a run
      laid out like run 2.

    Returns the slab's arrays (slab, tile_bounds, perm, n_valid, center,
    tile) and queries (pos, nrm): 133 at the origin (not a multiple of
    the 128-query block), or with ``mixed`` queries 100-127 at FAR so one
    block mixes real and padding queries."""
    tile, n_pad = 1024, 2048
    rng = np.random.default_rng(17)
    xyz = np.full((n_pad, 3), gnn.FAR, np.float32)
    nrm = np.zeros((n_pad, 3), np.float32)
    perm = np.full(n_pad, -1, np.int32)
    valid = np.r_[0:700, 1024:1500]
    far = rng.uniform(0.3, 1.0, (len(valid), 3)) * rng.choice([-1, 1], (
        len(valid), 3))
    xyz[valid] = far.astype(np.float32)
    nrm[valid] = [0, 1, 0]
    perm[valid] = np.arange(len(valid), dtype=np.int32)[::-1]
    xyz[33:64] = np.c_[np.linspace(0.13, 0.2, 31), np.zeros((31, 2))]
    xyz[64:95] = np.c_[-np.linspace(0.2, 0.13, 31), np.zeros((31, 2))]
    xyz[97:128] = np.c_[np.zeros((31, 2)), np.linspace(0.13, 0.2, 31)]
    xyz[32] = [EDGE_R, 0, 0]
    xyz[95] = [-EDGE_IN, 0, 0]
    xyz[96] = [0, 0, EDGE_IN]
    xyz[1024] = xyz[95]
    xyz[1025:1056] = xyz[64:95]
    slab = np.zeros((8, n_pad), np.float32)
    slab[0:3] = xyz.T
    slab[3] = np.where(perm >= 0, (xyz * xyz).sum(1), 3e12)
    slab[4:7] = nrm.T
    tb = np.zeros((2, 8), np.float32)
    for t in range(2):
        v = perm[t * tile:(t + 1) * tile] >= 0
        c = xyz[t * tile:(t + 1) * tile][v]
        tb[t, 0:3], tb[t, 4:7] = c.min(0), c.max(0)
    q = np.zeros((133, 3), np.float32)
    if mixed:
        q[100:128] = gnn.FAR
    qn = np.tile(np.float32([0, 1, 0]), (len(q), 1))
    return (slab, tb, perm, len(valid), np.zeros(3, np.float32), tile), q, qn


def _fixture(seed, n, m):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    pts[n // 2:n // 2 + 300] = pts[:300]          # duplicates force ties
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(-0.1, 2.1, (m, 3)).astype(np.float32)
    q[:200] = pts[:200]                            # exact hits: d2 == 0
    q[-100:] = gnn.FAR                             # padding-like queries
    qn = rng.normal(size=(m, 3)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    return pts, nrm, q, qn


@pytest.mark.parametrize("tile,radius,cos_gate,use_abs_dot", [
    (2048, 0.1, float(np.cos(np.deg2rad(np.float32(35.0)))), False),
    (1024, 0.1, 0.5, False),
    (1024, 0.075, 0.5, True),
    (2048, 0.15, -1.0, True),
])
def test_kernel_bit_identical_to_plain(cuda, tile, radius, cos_gate,
                                       use_abs_dot):
    pts, nrm, q, qn = _fixture(7, 30000, 20000)
    slab = gnn.build_sorted_slab(pts, nrm, tile=tile, device=cuda)
    qt, qnt = torch.from_numpy(q).to(cuda), torch.from_numpy(qn).to(cuda)
    gnn.reset_counts()
    i_k, d_k, t_k = gnn.nearest_gated(slab, qt, qnt, radius, cos_gate,
                                      use_abs_dot)
    d1_k, t1_k = gnn.gated_min(slab, qt, qnt, radius, cos_gate, use_abs_dot)
    torch.cuda.synchronize()
    assert gnn.LAUNCHES == {"gated_min": 1, "nearest_gated": 1,
                            "gated_min_set": 0, "nearest_gated_set": 0}
    assert gnn.PLAIN_CALLS == {"gated_min": 0, "nearest_gated": 0,
                               "gated_min_set": 0, "nearest_gated_set": 0}
    i_p, d_p, t_p = gnn.nearest_gated_ref(slab, qt, qnt, radius, cos_gate,
                                          use_abs_dot)
    assert (i_p >= 0).sum() > 1000
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(t_k, t_p)
    assert torch.equal(d1_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(t1_k, t_p)


def test_kernel_empty_and_ragged(cuda):
    pts, nrm, q, qn = _fixture(3, 5000, 1000)
    slab = gnn.build_sorted_slab(pts, nrm, device=cuda)
    for m in (0, 1, 127, 129):
        qt = torch.from_numpy(q[:m]).to(cuda)
        qnt = torch.from_numpy(qn[:m]).to(cuda)
        k = gnn.nearest_gated(slab, qt, qnt, 0.2, 0.0)
        p = gnn.nearest_gated_ref(slab, qt, qnt, 0.2, 0.0)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
    empty = gnn.build_sorted_slab(np.zeros((0, 3), np.float32),
                                  np.zeros((0, 3), np.float32), device=cuda)
    idx, d2, _ = gnn.nearest_gated(empty, torch.from_numpy(q).to(cuda),
                                   torch.from_numpy(qn).to(cuda), 0.2, 0.0)
    assert (idx == -1).all() and torch.isinf(d2).all()


@pytest.mark.parametrize("use_abs_dot,cos_gate", [(False, 0.5),
                                                  (True, -1.0)])
@pytest.mark.parametrize("parts", [2, 3])
def test_set_kernel_bit_identical_to_plain(cuda, monkeypatch, parts,
                                           use_abs_dot, cos_gate):
    """K2 and K1 over a split index on the card (a launch a part, merged
    on the card) equal the plain version over the same parts."""
    pts, nrm, q, qn = _fixture(9, 30000, 20000)
    monkeypatch.setattr(gnn, "MAX_SLAB_COLS",
                        int(np.ceil(len(pts) / (0.94 * (parts - 0.5)))))
    sset = gnn.build_sorted_slab(pts, nrm, tile=2048, device=cuda)
    assert isinstance(sset, gnn.SlabSet) and len(sset.slabs) == parts
    qt, qnt = torch.from_numpy(q).to(cuda), torch.from_numpy(qn).to(cuda)
    gnn.reset_counts()
    card = gnn.nearest_gated(sset, qt, qnt, 0.1, cos_gate, use_abs_dot)
    card1 = gnn.gated_min(sset, qt, qnt, 0.1, cos_gate, use_abs_dot)
    torch.cuda.synchronize()
    assert gnn.LAUNCHES == {"gated_min": parts, "nearest_gated": parts,
                            "gated_min_set": 1, "nearest_gated_set": 1}
    plain = gnn.nearest_gated(sset.to("cpu"), qt.cpu(), qnt.cpu(), 0.1,
                              cos_gate, use_abs_dot)
    assert gnn.PLAIN_CALLS["nearest_gated_set"] == 1
    assert (plain[0] >= 0).sum() > 1000
    for a, b in zip(card, plain):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    for a, b in zip(card1, plain[1:]):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def _mesh_devices(cuda, n):
    """n shard slots: on every visible card in turn (all on one card when
    there is only one)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


@pytest.mark.parametrize("n_slots", [4, 8])
def test_mesh_launches_match_single(cuda, n_slots):
    """The query axis split over shard slots (several on one card, or over
    the cards): one kernel launch per slot, each on its slot's device,
    and results gathered on the lead that equal one launch bit for bit."""
    from rescan_tpu_torch.parallel import mesh as pmesh
    pts, nrm, q, qn = _fixture(11, 30000, 256 * n_slots)
    devs = _mesh_devices(cuda, n_slots)
    m = pmesh.Mesh(devs)
    slab = gnn.build_sorted_slab(pts, nrm, device=devs[0])
    reps = m.replicate(slab)
    assert [r.device for r in reps] == devs
    gnn.reset_counts()
    parts = pmesh.nearest_gated_sharded(m, slab, q, qn, 0.1, 0.5)
    assert [p[0].device for p in parts] == devs
    got = m.gather(parts)
    assert gnn.LAUNCHES["nearest_gated"] == n_slots
    assert gnn.PLAIN_CALLS["nearest_gated"] == 0
    want = gnn.nearest_gated(slab, torch.from_numpy(q).to(devs[0]),
                             torch.from_numpy(qn).to(devs[0]), 0.1, 0.5)
    assert (want[0] >= 0).sum() > 100
    for a, b in zip(got, want):
        assert a.device == devs[0]
        assert torch.equal(a, b)


@pytest.mark.parametrize("mixed", [False, True])
def test_kernel_keeps_columns_at_r_on_run_boundaries(cuda, mixed):
    """The hand-laid slab of ``edge_slab``: kernel and plain version bit
    for bit, every origin query finds column 95 just inside r."""
    arrays, q, qn = edge_slab(mixed)
    slab = gnn.slab_from_numpy(*arrays, device=cuda)
    qt, qnt = torch.from_numpy(q).to(cuda), torch.from_numpy(qn).to(cuda)
    for use_abs, gate in ((False, 0.5), (True, -1.0)):
        k = gnn.nearest_gated(slab, qt, qnt, EDGE_R, gate, use_abs)
        k1 = gnn.gated_min(slab, qt, qnt, EDGE_R, gate, use_abs)
        p = gnn.nearest_gated_ref(slab, qt, qnt, EDGE_R, gate, use_abs)
        real = q[:, 0] == 0
        assert (p[0].cpu().numpy()[real] == arrays[2][95]).all()
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        for a, b in zip(k1, p[1:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("want_idx", [False, True])
@pytest.mark.parametrize("use_abs_dot", [False, True])
def test_kernel_resides_without_spills(cuda, want_idx, use_abs_dot):
    """Every instantiation keeps its state in registers and shared memory
    (no local memory) and fits at least 16 CTAs on an SM, its launch
    bound."""
    info = gnn.kernel_info(want_idx, use_abs_dot, cuda)
    assert info["local_bytes"] == 0
    assert info["ctas_per_sm"] >= 16
    assert 0 < info["registers"] <= 128


def test_kernel_far_from_the_slab_centre(cuda):
    """Queries up to 30 m from the slab centre, where an f32 rounding of
    |q - p|^2 is far larger than at the origin."""
    rng = np.random.default_rng(4)
    n = 200_000
    pts = np.c_[rng.uniform(0, 60, n), rng.uniform(0, 0.5, (n, 2))].astype(
        np.float32)
    pts[n // 2:n // 2 + 5000] = pts[:5000]
    nrm = np.tile(np.float32([0, 1, 0]), (n, 1))
    q = (pts[::4] + rng.normal(0, 0.03, (n // 4, 3))).astype(np.float32)
    q = q[gnn.morton_order(q)]
    slab = gnn.build_sorted_slab(pts, nrm, tile=1024, device=cuda)
    qt = torch.from_numpy(q).to(cuda)
    qnt = torch.from_numpy(nrm[:len(q)]).to(cuda)
    k = gnn.nearest_gated(slab, qt, qnt, 0.1, 0.5)
    p = gnn.nearest_gated_ref(slab, qt, qnt, 0.1, 0.5)
    assert (p[0] >= 0).sum() > 0.9 * len(q)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _eval_files(root, rng):
    """Two 3000-vertex scans of ScanNet-format eval files (label noise, a
    merged instance, ids < 0 and >= 256) under ``root``."""
    import os
    for s, scan in enumerate(["scan_000", "scan_001"]):
        gt = np.repeat(np.int64([1000, 5001, 5002, 7003]), 750)
        pred = gt.copy()
        flip = rng.random(len(gt)) < 0.1
        pred[flip] = rng.choice([5001, 5002, 7003, 1000, -7, 5300],
                                int(flip.sum()))
        if s:
            pred[1500:1700] = 5001
        for task in ("semantic_label", "instance_transfer",
                     "semantic_instance"):
            for kind, ids in (("gt_segmentation", gt), ("predictions", pred)):
                d = os.path.join(root, task, kind)
                os.makedirs(d, exist_ok=True)
                if task == "semantic_instance" and kind == "predictions":
                    os.makedirs(os.path.join(d, "predicted_masks"),
                                exist_ok=True)
                    with open(os.path.join(d, f"{scan}.txt"), "w") as f:
                        for iid in (5001, 5002, 7003):
                            m = f"predicted_masks/{scan}_{iid}.txt"
                            np.savetxt(os.path.join(d, m),
                                       (ids == iid).astype(np.int64), "%d")
                            f.write(f"{m} {iid // 1000} 0.{iid % 7 + 2}\n")
                    continue
                vals = ids // 1000 if task == "semantic_label" else ids
                np.savetxt(os.path.join(d, f"{scan}.txt"), vals, "%d")


def test_evaluators_on_card_match_cpu(cuda, tmp_path):
    """The three evaluators' device counting on the card against the
    same calls on the CPU: equal results."""
    import glob
    from rescan_tpu_torch.eval import (instance_transfer, semantic_instance,
                                       semantic_label)
    _eval_files(str(tmp_path), np.random.default_rng(2))

    def files(task):
        p = sorted(glob.glob(str(tmp_path / task / "predictions" / "*.txt")))
        return p, [f.replace("predictions", "gt_segmentation") for f in p]

    for dev in (cuda, "cpu"):
        got = (semantic_label.evaluate(*files("semantic_label"), device=dev),
               [instance_transfer.evaluate_scan(p, g, device=dev)
                for p, g in zip(*files("instance_transfer"))],
               semantic_instance.evaluate(*files("semantic_instance"),
                                          device=dev))
        if dev == "cpu":
            assert repr(got) == repr(want)
        want = got
    assert 0.0 < want[1][0] < 1.0


def test_renders_on_card_match_cpu(cuda):
    """Splat (fixed and surfel sizes), EDL, overlays, the colour map and
    the distance field on the card against the CPU: images and the field
    equal, EDL within one level on at most 0.1 % of pixels."""
    from rescan_tpu_torch.ops import distance_field
    from rescan_tpu_torch.viewer import render
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 2, (200_000, 3)).astype(np.float32)
    pts[100_000:] = pts[:100_000]                 # equal-depth ties
    cols = rng.uniform(0, 1, (len(pts), 3))
    nrm = rng.normal(size=(len(pts), 3))
    radii = rng.uniform(0.002, 0.02, len(pts)).astype(np.float32)
    view = render.look_at([3.0, 2.5, 3.5], [1.0, 1.0, 1.0])
    segs = render.grid_segments(pts.min(0), pts.max(0), y=0.0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        img, z = render.render_points(pts, cols, view, 1024, 768,
                                      shade_normals=nrm, radii=radii,
                                      return_zbuf=True, device=dev)
        render.draw_segments(img, z, view, segs,
                             np.full((len(segs), 3), 90, np.uint8), px=2)
        df = distance_field.build_distance_field(pts[:20000], 0.05, 0.5,
                                                 device=dev)
        out[dev.type] = (img.cpu(), z.cpu(),
                         render.apply_edl(img, z, 1.0).cpu(),
                         render.diverging_colors(np.linspace(0, 1, 999),
                                                 device=dev).cpu(),
                         df.dist.cpu(), df.lookup(pts[::7]).cpu())
    a, b = out["cuda"], out["cpu"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    d = (a[2].long() - b[2].long()).abs().amax(-1)
    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 0.001 * d.numel()
    assert (a[3] - b[3]).abs().max() < 1e-12
    assert torch.equal(a[4].view(torch.int32), b[4].view(torch.int32))
    assert torch.equal(a[5], b[5])


# ---------------------------------------------------------------------------
# The per-pair sums and the ICP on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,parts", [(128, 1), (256, 2), (1024, 1),
                                     (4096, 1), (4096, 4), (2048, 8),
                                     (16384, 1), (32768, 4)])
def test_pairsum_kernel_bit_identical_to_plain(cuda, n, parts):
    """ops/csrc/pairsum.cu against the plain version on the card: every
    kind, over the whole axis and chained over runs of points (from 16384
    points the slice trees' cascades); the states bit for bit."""
    from rescan_tpu_torch.ops import pairsum
    from rescan_tpu_torch.ops.pairsum import (BLOCKED, BLOCKED_TAIL, CHAIN,
                                              LANES, LANES_TAIL, ONE, WINDOW)
    spec = [(WINDOW, 0, ONE), (CHAIN, 0, 1), (BLOCKED, 1, 2),
            (WINDOW, 3, ONE), (CHAIN, 2, 3), (LANES, 0, 1),
            (LANES_TAIL, 2, 3), (LANES_TAIL, 1, ONE), (BLOCKED_TAIL, 0, 3)]
    rng = np.random.default_rng(n + parts)
    x = torch.from_numpy((rng.normal(size=(9, n, 4))
                          * (rng.random((9, n, 4)) < 0.8)).astype(
                              np.float32)).to(cuda)
    pairsum.reset_counts()
    m = n // parts
    sk = sp = None
    for k in range(parts):
        xs = x[:, k * m:(k + 1) * m].contiguous()
        sk = pairsum.pairsum(xs, spec, k * m, n, sk)
        sp = pairsum.pairsum_ref(xs, spec, k * m, n, sp)
    assert pairsum.LAUNCHES["pairsum"] == parts
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


def lu6_systems(kind: str, seed: int = 0, count: int = 2000):
    """``count`` (C, b) systems for the ICP's 6x6 solve (ops/lu6.py):
    ``spd`` random normal matrices J J^T; ``icp`` the ICP's damped
    J^T W J with a nearly dependent column (cond up to ~1e7); ``general``
    unsymmetric; ``singular`` with zero rows and columns. Rows and columns
    are scaled over 4 decades."""
    rng = np.random.default_rng(seed)
    cs = []
    for _ in range(count):
        if kind == "spd":
            a = rng.normal(size=(6, 12))
            m = a @ a.T
        elif kind == "icp":
            j = rng.normal(size=(200, 6))
            j[:, 2] = j[:, 0] * 0.999 + rng.normal(size=200) * 10 ** \
                rng.uniform(-5, -2)
            m = j.T @ (j * rng.random((200, 1)))
        elif kind == "general":
            m = rng.normal(size=(6, 6))
        else:
            m = rng.normal(size=(6, 6))
            k = rng.integers(0, 6, rng.integers(1, 3))
            m[k] = 0
            m[:, k] = 0
        s = 10 ** rng.uniform(-2, 2, 6)
        cs.append(m * s[:, None] * s[None, :])
    c = np.asarray(cs, np.float32)
    if kind in ("spd", "icp"):
        # the step's damping (icp.py:160-161, as XLA folds it)
        tr = np.zeros(count, np.float32)
        for i in range(6):
            tr = (tr + c[:, i, i]).astype(np.float32)
        damp = (tr * np.float32(1.66666666e-07) + np.float32(1e-20)).astype(
            np.float32)
        c = (c + np.eye(6, dtype=np.float32) * damp[:, None, None]).astype(
            np.float32)
    b = rng.normal(size=(count, 6)).astype(np.float32)
    return c, b


def icp_tail_inputs(rng, b: int, device="cpu"):
    """The ICP tail's inputs (ops/icp.py ``_icp_tail``) for ``b`` pairs:
    seeded random states (round 4's C of the ICP's J^T W J kind, general
    or with a zero row and column, scaled over 4 decades; b, e2, weight
    totals, counts, centroids, poses, errors, the active mask) and, from
    12 pairs on, the edge rows first: a singular C; a NaN and an inf on
    C's diagonal (damp non-finite, so every entry NaN) and an inf off it;
    -0.0 off the diagonal under a positive and a negative trace; a NaN in
    b (a NaN solution, zeroed); no correspondences; a weight total at
    exactly 1e-7 as float32, and one of NaN; an inactive pair; an error
    within the convergence delta; angles past sin and cos's fast
    reduction (500, -4e5, 1e20) and in its middle range (90); signed
    zeros (a diagonal C with -0.0 off it, zero and -0.0 in b and c1, T
    the identity)."""
    f32 = np.float32
    cs = []
    for _ in range(b):
        kind = rng.integers(0, 3)
        if kind == 0:
            j = rng.normal(size=(200, 6))
            m = j.T @ (j * rng.random((200, 1)))
        else:
            m = rng.normal(size=(6, 6))
            if kind == 2:
                k = rng.integers(0, 6)
                m[k] = 0
                m[:, k] = 0
        s = 10 ** rng.uniform(-2, 2, 6)
        cs.append(m * s[:, None] * s[None, :])
    C = np.asarray(cs, f32)
    nb = rng.normal(size=(b, 6)).astype(f32) * f32(0.01)   # -b
    wsum = rng.uniform(0.5, 100.0, b).astype(f32)
    e2 = (wsum * rng.uniform(1e-6, 1e-3, b)).astype(f32)
    cnt = rng.integers(1, 4096, b).astype(np.int64)
    c1 = rng.normal(size=(b, 3)).astype(f32)
    T = np.tile(np.eye(4, dtype=f32), (b, 1, 1))
    T[:, :3] = rng.normal(size=(b, 3, 4)).astype(f32)
    err = rng.uniform(0.0, 0.1, b).astype(f32)
    active = rng.random(b) < 0.9
    if b >= 12:
        C[0, 2] = 0
        C[0, :, 2] = 0
        C[1, 3, 3] = np.nan
        C[2, 0, 0] = np.inf
        C[3, 1, 4] = np.inf
        for r, sign in ((4, 1), (5, -1)):
            C[r] = sign * np.diag(rng.uniform(1, 2, 6)).astype(f32)
            C[r, 0, 1:] = -0.0
            C[r, 3:, 1] = -0.0
        nb[6, 2] = np.nan
        cnt[7] = 0
        wsum[8] = np.float32(1e-7)
        wsum[9] = np.nan
        active[10] = False
        active[11] = True
        new_err = np.sqrt(e2[11].astype(np.float64) / wsum[11])
        err[11] = f32(new_err + 4e-6)
    if b >= 14:
        # x = C^-1 b with C = 0.01 I (damping aside): angles of these sizes
        C[12] = C[13] = np.eye(6, dtype=f32) * f32(0.01)
        nb[12, :3] = -np.array([500.0, -4e5, 1e20], f32) * f32(0.01)
        nb[13, :3] = -np.array([90.0, -90.0, 0.0], f32) * f32(0.01)
    if b >= 16:
        # signed zeros through the solve and the products: a diagonal C
        # with -0.0 off it, b, c1 and the angles of zero and -0.0, T the
        # identity (positive and negative trace)
        for r, sign in ((14, 1), (15, -1)):
            C[r] = np.where(np.eye(6, dtype=bool), sign * rng.uniform(
                1, 2, (6, 6)), -0.0).astype(f32)
            nb[r] = [0.0, -0.0, -0.0, 0.0, -0.0, 0.0]
            c1[r] = [0.0, -0.0, 0.0]
            T[r] = np.eye(4, dtype=f32)
    s4 = np.concatenate([C.reshape(b, 36), nb, e2[:, None]], 1)
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for v in (s4, wsum, cnt, c1, T, err, active))


def icp_head_inputs(rng, b: int, n: int, m: int = 1000) -> dict:
    """The ICP head's operands (ops/icp.py ``_icp_head``) for ``b`` pairs of
    ``n`` points against ``m`` scene rows, form by form (CPU tensors, dist
    after form A's): seeded K2 results (a fifth of idx -1, the mask a
    random prefix of each pair), per-pair totals formed from the points
    (in float64, rounded: any totals are valid operands), and the edge
    rows: in every pair idx -1 under the mask, a masked point with a
    match, d2 of 0 and -0.0, a dot of -0.0 and a subnormal one; from 8
    pairs on, pairs with no correspondence (all idx -1), inactive (q at
    2e6, no match), all masked, all d2 equal (std 0), one correspondence
    whose std is f32(1e-6) exactly and one whose std is the next float
    above it, d2 at 2.5 * std and one float either side, a count of 0
    beside correspondences (its floor of 1); round 3's totals
    with weight totals of 0, -0.0, 1e-31 (below the 1e-30 floor),
    subnormal, below 1e-7 and NaN, and centroids of 0 and -0.0 where the
    points make the cross product cancel (q parallel to n2); weights of
    -0.0, 1e-30 against normals of 1e-10 (subnormal products), p2 equal
    to its centroid, and -0.0 in q and n2."""
    from rescan_tpu_torch.ops import icp
    f32 = np.float32

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(f32)

    def t(*xs):
        return [torch.from_numpy(np.array(x)) for x in xs]

    dist = f32(0.1)
    scene_pts = rng.normal(size=(m, 3)).astype(f32)
    scene_nrm = unit(rng.normal(size=(m, 3)))
    scene_pts[0] = [1e-40, -0.0, 0.0]
    scene_nrm[1] = [-0.0, 0.0, -1.0]
    idx = rng.integers(0, m, (b, n)).astype(np.int32)
    idx[rng.random((b, n)) < 0.2] = -1
    mask = np.arange(n)[None] < rng.integers(n // 2, n + 1, (b, 1))
    d2 = (rng.random((b, n)) * dist * dist).astype(f32)
    dot = rng.uniform(0.5, 1.0, (b, n)).astype(f32)
    q = rng.normal(size=(b, n, 3)).astype(f32)
    idx[:, :2] = [-1, 7]
    mask[:, :6] = [True, False, True, True, True, True]
    d2[:, 2:4] = [0.0, -0.0]
    dot[:, 4:6] = [-0.0, 1e-40]
    if b >= 8:
        idx[1] = -1
        q[2] = 2e6
        idx[2] = -1
        mask[3] = False
        d2[4] = d2[4, 0]
    ops = {icp.HEAD_A: (*t(idx, d2, dot, mask, scene_pts, scene_nrm), dist)}
    x1, w0, p2, n2 = (v.numpy().copy() for v in
                      icp._icp_head_ref(icp.HEAD_A, *ops[icp.HEAD_A]))
    ok = x1[..., 0] > 0
    s1 = np.stack([ok.sum(1), x1[..., 1].astype(np.float64).sum(1)],
                  1).astype(f32)
    if b >= 8:
        # a count of 0 beside correspondences: the count's floor of 1
        s1[0] = [0.0, 0.5]
    ops[icp.HEAD_B] = tuple(t(x1, s1))
    x2, _ = icp._icp_head_ref(icp.HEAD_B, *ops[icp.HEAD_B])
    s2 = x2.numpy().astype(np.float64).sum(1).astype(f32)
    if b >= 8:
        # std exactly f32(1e-6) and the next float above it, from one
        # correspondence; then d2 at sigmas * std and a float either side
        v = f32(np.float64(f32(1e-6)) ** 2)
        assert np.sqrt(np.float64(v)).astype(f32) == f32(1e-6)
        s1[5:8] = [[1.0, 0.0]] * 3
        s2[5:8, 0] = [v, np.nextafter(v * f32(1.01), f32(1)), f32(1e-4)]
        sd = np.sqrt(np.float64(s2[7, 0])).astype(f32)
        edge = f32(2.5) * sd
        x1[7, 6:9] = [[1.0, np.nextafter(edge, f32(0))], [1.0, edge],
                      [1.0, np.nextafter(edge, f32(1))]]
        w0[7, 6:9] = 0.5
    ops[icp.HEAD_C] = tuple(t(x1, w0, s1, s2, q, p2))
    x3, = (v.numpy().copy() for v in
           icp._icp_head_ref(icp.HEAD_C, *ops[icp.HEAD_C]))
    s3 = np.concatenate([x3[..., :1].astype(np.float64).sum(1),
                         (x3[..., :1] * x3[..., 1:]).astype(np.float64).sum(
                             1)], 1).astype(f32)
    x3[:, :40:8, 0] = -0.0
    x3[:, 8:40:8, 0] = 1e-30
    n2[:, 8:40:8] = 1e-10
    n2[:, 16] = [-0.0, 0.0, -0.0]
    x3[:, 24, 1:4] = -0.0
    if b >= 8:
        s3[:7, 0] = [0.0, -0.0, 1e-31, 1e-40, 5e-8, np.nan, 1e-7]
        s3[0, 1:] = 0.0
        s3[1, 1:] = -0.0
        # p = q - 0 parallel to n2: the cross product's products cancel
        x3[:2, 40:80, 1:4] = n2[:2, 40:80] * rng.uniform(
            0.5, 2.0, (2, 40, 1)).astype(f32)
        # p2 at its centroid: p2 - c2 is 0
        x3[3, :10, 4:7] = s3[3, 4:7] / max(s3[3, 0], f32(1e-30))
    ops[icp.HEAD_D] = tuple(t(x3, n2, s3))
    return ops


def chain_cases(rng, device="cpu"):
    """fma_chains' shapes on the step's and scoring's operands: the two
    transforms (R broadcast over the points, t added), the cross product
    (negated first product, strided views, outputs into a (..., 3)
    tensor's columns), 3x3 and 4x4 products, a one-term product broadcast
    from a column, and fma(a, b, c) as the chain c * 1, then a * b;
    operands with products that cancel (parallel p and n, an addend
    against its product), subnormal entries, products of two tiny values
    below FLT_MIN, and huge entries."""
    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)
    b, n = 6, 300
    R, t, p, nr = f(b, 3, 3), f(b, 3), f(b, n, 3), f(b, n, 3)
    p[0, :20] = 1e-20
    nr[0, :20] = -2e-20                  # products of ~-2e-40
    p[2, :20] = 1e-40                    # subnormal entries
    nr[3, 10:30] = -3e-39
    R[4] *= 1e-21                        # R p of ~1e-21, R R^T of ~1e-42
    nr[1, :20] = 3e30
    nr[5, :40] = p[5, :40] * (1 + 1e-7 * f(40, 1))   # p x n cancels
    A, B4 = f(b, 4, 4), f(b, 4, 4)
    c = -(p[..., 0] * nr[..., 1]) * (1 + 1e-7 * f(b, n))
    c[:, 100:150] = 1e-40
    one = torch.ones((), device=device)
    out3 = torch.empty(b, n, 3, device=device)
    cases = []
    terms = [(R[:, None, :, j], p[..., j, None]) for j in range(3)]
    nterms = [(R[:, None, :, j], nr[..., j, None]) for j in range(3)]
    cases.append(([pairsum.Chain(terms, add=t[:, None, :]),
                   pairsum.Chain(nterms)], p.shape, None))
    cases.append(([pairsum.Chain([(p[..., k], nr[..., i]),
                                  (p[..., i], nr[..., k])], neg_first=True)
                   for i, k in ((1, 2), (2, 0), (0, 1))], p.shape[:-1],
                  list(out3.unbind(-1))))
    for a, bb in ((R, R.transpose(1, 2)), (A, B4)):
        mt = [(a[..., :, k, None], bb[..., None, k, :])
              for k in range(a.shape[-1])]
        cases.append(([pairsum.Chain(mt)], a.shape, None))
    cases.append(([pairsum.Chain([(c, one), (p[..., 0], nr[..., 1])]),
                   pairsum.Chain([(f(b, 1), p[..., 2])])], (b, n), None))
    return cases


def xla_math_args(rng, n: int = 20000) -> torch.Tensor:
    """Arguments over what the pipeline gives XLA's exp, arccos, cos and
    sin, and their edges: the clamps of exp, 0 and +-1, subnormals, NaN,
    +-inf, the reduction ranges of sin and cos."""
    edges = np.array([0.0, -0.0, 1.0, -1.0, 1e-45, -1e-40, 1.1754942e-38,
                      np.inf, -np.inf, np.nan, 3.4e38, -87.8, -87.5, -88.0,
                      -104.0, 88.7, 88.8, 89.0, 0.75, 0.74999994, 2 ** -12,
                      119.5, 120.0, -1e30, 0.4375, 2.4375], np.float32)
    x = np.concatenate([rng.uniform(-5, 0, n // 4), rng.uniform(0, 1, n // 4),
                        rng.uniform(-0.3, 0.3, n // 4),
                        rng.uniform(-1, 1, n // 4) * 10.0 ** rng.uniform(
                            -8, 6, n // 4), edges]).astype(np.float32)
    return torch.from_numpy(x)


def score_inputs(rng, h: int = 40, pp: int = 256, device="cpu"):
    """K1-like per-point inputs: d2 up to r^2, dots over [-0.2, 1.1] (the
    clamp's both sides) with a few NaNs, a third not found, padding
    masked."""
    d2 = torch.from_numpy((rng.random((h, pp)) * 0.01).astype(np.float32))
    dot = torch.from_numpy(rng.uniform(-0.2, 1.1, (h, pp)).astype(
        np.float32))
    dot[0, :3] = float("nan")
    found = torch.from_numpy(rng.random((h, pp)) < 0.67)
    mask = torch.from_numpy(np.arange(pp)[None] < rng.integers(
        100, pp + 1, (h, 1)))
    return tuple(t.to(device) for t in (d2, dot, found, mask))


@pytest.mark.parametrize("n,parts", [(256, 1), (4096, 4), (32768, 8)])
def test_pairsum_small_shape_bit_identical_to_plain(cuda, n, parts):
    """The kernel's small shape (a few sums over few columns, as scoring's
    means) on the card, whole axis and chained runs."""
    from rescan_tpu_torch.ops.pairsum import (BLOCKED_TAIL, CHAIN, LANES_TAIL,
                                              ONE, WINDOW)
    spec = [(WINDOW, 0, ONE), (CHAIN, 0, 1), (LANES_TAIL, 1, 2),
            (BLOCKED_TAIL, 2, 3)]
    assert pairsum._shape(4, len(spec)) == "small"
    rng = np.random.default_rng(n + parts)
    x = torch.from_numpy((rng.normal(size=(40, n, 4))
                          * (rng.random((40, n, 4)) < 0.8)).astype(
                              np.float32)).to(cuda)
    m = n // parts
    sk = sp = None
    for k in range(parts):
        xs = x[:, k * m:(k + 1) * m].contiguous()
        sk = pairsum.pairsum(xs, spec, k * m, n, sk)
        sp = pairsum.pairsum_ref(xs.cpu(), spec, k * m, n, sp)
    assert torch.equal(sk.cpu().view(torch.int32), sp.view(torch.int32))


@pytest.mark.parametrize("n", [128, 256])
def test_pairsum_folded_bit_identical_to_plain(cuda, n):
    """The one-pair kinds of 128 and 256 points (FOLDED, FOLDED_TAIL)
    beside the chained ones, on the card against the plain version."""
    from rescan_tpu_torch.ops.pairsum import (BLOCKED, CHAIN, FOLDED,
                                              FOLDED_TAIL, ONE, WINDOW)
    spec = [(FOLDED, 0, 1), (FOLDED_TAIL, 2, 3), (FOLDED_TAIL, 4, ONE),
            (WINDOW, 0, ONE), (BLOCKED, 1, 4), (CHAIN, 3, 2)]
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.normal(size=(5, n, 5))
                          * (rng.random((5, n, 5)) < 0.8)).astype(
                              np.float32)).to(cuda)
    got = pairsum.pairsum(x, spec)
    want = pairsum.pairsum_ref(x.cpu(), spec)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_fma_chains_bit_identical_to_plain(cuda):
    """fma_chain_kernel (one launch per case: the two transforms, the
    cross product into a tensor's columns, 3x3 and 4x4 products, a
    one-term product and an fma with an addend) against the plain chains
    on the CPU, bit for bit."""
    for chains, shape, outs in chain_cases(np.random.default_rng(11), cuda):
        pairsum.reset_counts()
        got = pairsum.fma_chains(chains, shape, outs)
        assert pairsum.LAUNCHES["fma"] == 1
        for g, c in zip(got, chains):
            cpu = pairsum.Chain(
                [(a.cpu(), b.cpu()) for a, b in c.terms], c.neg_first,
                None if c.add is None else c.add.cpu())
            w = cpu.plain(torch.Size(shape))
            assert torch.equal(g.cpu().view(torch.int32),
                               w.view(torch.int32))


def test_xla_math_kernel_bit_identical_to_plain(cuda):
    """xla_math_kernel (exp, arccos, cos and sin together) on the card
    against the plain versions on the CPU, bit for bit (a NaN equal to
    any NaN)."""
    from rescan_tpu_torch.ops import lu6, xla_math
    x = xla_math_args(np.random.default_rng(12), 200_000)
    xc = x.to(cuda)
    assert lu6.same_bits(xla_math.exp(xc).cpu(), xla_math.exp_ref(x))
    assert lu6.same_bits(xla_math.acos(xc).cpu(), xla_math.acos_ref(x))
    cs = xla_math.sincos(xc).cpu()
    assert lu6.same_bits(cs[0], xla_math.cos_ref(x))
    assert lu6.same_bits(cs[1], xla_math.sin_ref(x))


def test_score_terms_bit_identical_to_plain(cuda):
    """score_terms_kernel on the card against ops/score.py's
    per_point_ref on the CPU, bit for bit."""
    from rescan_tpu_torch.ops import lu6, score
    inputs = score_inputs(np.random.default_rng(13), 4096, 256)
    want = score.per_point_ref(*inputs, 0.1)
    pairsum.reset_counts()
    got = score.per_point(*(t.to(cuda) for t in inputs), 0.1)
    assert pairsum.LAUNCHES["score_terms"] == 1
    assert lu6.same_bits(got.cpu(), want)


def test_fma_and_lu6_kernels_bit_identical_to_plain(cuda):
    """The library's fma chains and solve on the card: a one-term chain
    with an addend (a * b, then + c) and fma(a, b, c) (the chain c * 1,
    then a * b) on a broadcast operand, in one launch, against a * b + c
    and gnn._fma32; and ``lu6.solve`` against ``lu6.solve_ref`` on
    tests/test_torch_lu6.py's systems of every kind."""
    from rescan_tpu_torch.ops import lu6, pairsum
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(64, 1)).astype(np.float32)).to(cuda)
    b, c = (torch.from_numpy(rng.normal(size=(64, 4096)).astype(np.float32))
            .to(cuda) for _ in "bc")
    one = torch.ones((), device=cuda)
    pairsum.reset_counts()
    prod, fused = pairsum.fma_chains(
        [pairsum.Chain([(a, b)], add=c), pairsum.Chain([(c, one), (a, b)])],
        b.shape)
    assert pairsum.LAUNCHES["fma"] == 1
    want = a.expand_as(b) * b + c
    assert torch.equal(prod.view(torch.int32), want.view(torch.int32))
    want = gnn._fma32(a.expand_as(b), b, c)
    assert torch.equal(fused.view(torch.int32), want.view(torch.int32))
    for kind in ("spd", "icp", "general", "singular"):
        cm, rhs = (torch.from_numpy(v).to(cuda) for v in lu6_systems(kind, 3))
        assert lu6.same_bits(lu6.solve(cm, rhs), lu6.solve_ref(cm, rhs)), kind
    assert pairsum.LAUNCHES["lu6"] == 4


@pytest.mark.parametrize("it", [5, 6])
@pytest.mark.parametrize("b", [1, 69, 256])
def test_icp_tail_kernel_bit_identical_to_plain(cuda, b, it):
    """icp_tail_kernel (ops/icp.py ``_icp_tail`` on the card, one launch)
    against ``_icp_tail_ref`` on the CPU, bit for bit (a NaN equal to any
    NaN), on ``icp_tail_inputs``' states and edge rows, with round 4's
    totals and the weight totals read through strided views."""
    from rescan_tpu_torch.ops import icp, pairsum
    args = icp_tail_inputs(np.random.default_rng(b), b)
    want = icp._icp_tail_ref(*args, it)
    s4, wsum, *rest = (a.to(cuda) for a in args)
    wide = torch.cat([torch.zeros(b, 5, device=cuda), s4, wsum[:, None]], 1)
    pairsum.reset_counts()
    got = icp._icp_tail(wide[:, 5:5 + s4.shape[1]], wide[:, -1], *rest, it)
    assert pairsum.LAUNCHES["icp_tail"] == 1
    assert icp.same_tail([g.cpu() for g in got], want)


def _wavy_surface(rng, n):
    """tests/test_torch_icp.py's surface: points on a wavy sheet with its
    analytic normals."""
    xy = rng.uniform(0, 2, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(3.0 * xy[:, 1])
    pts = np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32)
    nrm = np.stack([-0.6 * np.cos(2.0 * xy[:, 0]),
                    0.6 * np.sin(3.0 * xy[:, 1]),
                    np.ones(n, np.float32)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def _icp_case():
    """tests/test_torch_icp.py's two-object, 8-pair batch (an
    ill-conditioned pair among them, a padding pair): the scene's points
    and normals, then the padded objects, each pair's object and
    validity, and the start poses."""
    from rescan_tpu_torch.ops import icp
    rng = np.random.default_rng(12345)
    scene_pts, scene_nrm = _wavy_surface(rng, 2500)
    upts, unrm, umask = icp.prep_unique_batch(
        [scene_pts[:700], scene_pts[900:1500]],
        [scene_nrm[:700], scene_nrm[900:1500]])
    own = np.array([k % 2 for k in range(8)], np.int32)
    val = np.ones(8, bool)
    val[-1] = False
    T0 = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    for k in range(8):
        a = 0.002 * (k + 1) ** 2
        T0[k, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T0[k, :3, 3] = [0.004 * k, -0.003 * k, 0.0]
    return scene_pts, scene_nrm, (upts, unrm, umask, own, val), T0


def test_icp_on_card_matches_cpu(cuda):
    """tests/test_torch_icp.py's two-object, 8-pair batch (an
    ill-conditioned pair among them, a padding pair) through the ICP on
    the card (K2, pairsum, fma, the head and the tail) and on the CPU
    (their plain versions): every pose and error bit for bit, the same
    iteration count and final active set, and per iteration four head
    launches (one per form) and one tail launch in place of the
    standalone solve and math kernels. The rotation's cos and sin are
    XLA's on both (ops/xla_math.py)."""
    from rescan_tpu_torch.ops import icp, pairsum
    scene_pts, scene_nrm, objs, T0 = _icp_case()
    out = {}
    for dev in ("cpu", cuda):
        slab = gnn.build_sorted_slab(scene_pts, scene_nrm, tile=1024,
                                     device=dev)
        gnn.reset_counts()
        pairsum.reset_counts()
        T, err, act, n_iter = icp.icp_align_indexed(
            *(torch.from_numpy(a).to(dev) for a in objs),
            slab, torch.from_numpy(T0).to(dev), 0.10, np.deg2rad(60.0))
        launched = gnn.LAUNCHES["nearest_gated"] and min(
            pairsum.LAUNCHES[k] for k in ("pairsum", "fma", "icp_head",
                                          "icp_tail"))
        assert bool(launched) == (dev != "cpu")
        assert pairsum.LAUNCHES["lu6"] == pairsum.LAUNCHES["xla_math"] == 0
        assert pairsum.LAUNCHES["icp_tail"] == (n_iter if dev != "cpu"
                                                else 0)
        assert pairsum.LAUNCHES["icp_head"] == (
            len(icp.HEAD_FORMS) * n_iter if dev != "cpu" else 0)
        out[str(dev)] = (T.cpu().numpy(), err.cpu().numpy(),
                         act.cpu().numpy(), n_iter)
    (tc, ec, ac, nc), (tg, eg, ag, ng) = out.values()
    assert nc == ng and 6 < nc < 100
    np.testing.assert_array_equal(ag, ac)
    np.testing.assert_array_equal(tg, tc)
    np.testing.assert_array_equal(eg, ec)


def shifted(v: torch.Tensor, device=None) -> torch.Tensor:
    """A contiguous copy of ``v`` (on ``device``) that starts one element
    into its storage: for float32 and int32 not 16-byte aligned."""
    flat = torch.empty(v.numel() + 1, dtype=v.dtype,
                       device=device or v.device)
    out = flat[1:].view(v.shape)
    out.copy_(v)
    return out


# the ICP head at shapes whose 128-point tiles span pairs or end a launch
# part full (N not a multiple of 128; the last tile of 7 x 150 holds 26
# points, so its copies end off a float4; from 8 pairs on with the edge
# rows of no correspondence and of NaN and subnormal weight totals)
HEAD_TILE_EDGES = [(3, 200), (5, 64), (7, 150), (8, 200), (12, 96)]


@pytest.mark.parametrize("b,n,shift", [(1, 128, False), (8, 1024, False),
                                       (69, 4096, False)]
                         + [(b, n, False) for b, n in HEAD_TILE_EDGES]
                         + [(8, 1024, True), (8, 200, True)])
def test_icp_head_kernel_bit_identical_to_plain(cuda, b, n, shift):
    """icp_head_kernel's four forms (ops/icp.py ``_icp_head`` on the card,
    one launch each) against ``_icp_head_ref`` on the CPU, bit for bit (a
    NaN equal to any NaN), on ``icp_head_inputs``' operands and edge rows:
    tiles in one pair, tiles across pairs and a part-full last tile, and
    (``shift``) every operand one element off 16-byte alignment, which
    ``head_operands`` copies to aligned storage for the float4 copies."""
    from rescan_tpu_torch.ops import icp, lu6
    ops = icp_head_inputs(np.random.default_rng(b * n), b, n)
    pairsum.reset_counts()
    for form in icp.HEAD_FORMS:
        want = icp._icp_head_ref(form, *ops[form])
        got = icp._icp_head(form, *(
            (shifted(v, cuda) if shift else v.to(cuda))
            if torch.is_tensor(v) else v for v in ops[form]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype
            g = g.cpu()
            assert (lu6.same_bits(g, w) if g.is_floating_point()
                    else torch.equal(g, w)), form
    assert pairsum.LAUNCHES["icp_head"] == len(icp.HEAD_FORMS)
    assert pairsum.PLAIN_CALLS["icp_head"] == 0


@pytest.mark.parametrize("form", range(4))
def test_icp_head_resides_without_spills(cuda, form):
    """Every icp_head_kernel form keeps its state in registers and shared
    memory (no local memory: its tile's rows, at most 25 floats a point,
    and the pair's scalars) and fits at least 8 CTAs of 128 threads on an
    SM."""
    from rescan_tpu_torch.ops import icp
    info = icp.head_info(form, cuda)
    assert info["local_bytes"] == 0
    assert info["shared_bytes"] <= 128 * 25 * 4 + 64
    assert info["ctas_per_sm"] >= 8
    assert 0 < info["registers"] <= 64


def test_icp_step_makes_no_host_sync(cuda):
    """One single-device ICP step on the card (the 8-pair batch, after a
    step that fills the wrappers' caches) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in it makes the
    host wait on the card (the loop's ``bool(active.any())`` is outside
    the step), and it runs K2, the four head forms, four rounds of sums
    and the tail."""
    from rescan_tpu_torch.ops import icp, search
    scene_pts, scene_nrm, (upts, unrm, umask, own, val), T0 = _icp_case()
    slab = gnn.build_sorted_slab(scene_pts, scene_nrm, tile=1024,
                                 device=cuda)
    scene_p, scene_n = search.index_arrays(slab)
    own_t = torch.from_numpy(own).long().to(cuda)
    args = (torch.from_numpy(upts).to(cuda)[own_t],
            torch.from_numpy(unrm).to(cuda)[own_t],
            torch.from_numpy(umask).to(cuda)[own_t]
            & torch.from_numpy(val).to(cuda)[:, None], slab, scene_p,
            scene_n)
    T = torch.from_numpy(T0).to(cuda)
    err = torch.full((8,), 1e6, device=cuda)
    active = torch.from_numpy(val).to(cuda)
    gate = icp.cos_gate_of(np.deg2rad(60.0))
    dist = np.float32(0.1)
    state = icp._icp_step(*args, T, err, dist, active, 0, gate)
    torch.cuda.synchronize()
    gnn.reset_counts()
    pairsum.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = icp._icp_step(*args, *state[:2], dist, state[2], 1, gate)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in got[:2])
    assert gnn.LAUNCHES["nearest_gated"] == 1
    assert pairsum.LAUNCHES["icp_head"] == len(icp.HEAD_FORMS)
    assert pairsum.LAUNCHES["pairsum"] == 4
    assert pairsum.LAUNCHES["icp_tail"] == 1


def test_host_syncs_count_every_wait_of_a_rescan(cuda, tmp_path,
                                                 monkeypatch):
    """One rescan of the small sequence on the card (the prior reloaded
    from its .rsdb, after ``driver.run_sequence`` builds the kernels and warms
    every shape) under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronising calls PyTorch warns of are the stages' ``host_syncs``,
    so every wait of the host on the card is spanned (utils/timing.py)."""
    import contextlib
    import io
    import os
    import warnings
    from rescan_tpu_torch import sequences
    from rescan_tpu_torch.pipeline import (driver, pose_proposal,
                                           segment_transfer)
    dev = torch.device("cuda", 0)
    class_file = sequences.write_small_sequence(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    seq = sequences.SEQ_NAME
    waits = []

    def show(message, *_):
        # not set_sync_debug_mode's own notice, which names the mode
        if "called a synchronizing CUDA operation" in str(message):
            waits.append(message)

    with contextlib.redirect_stdout(io.StringIO()):
        driver.run_sequence(seq, class_file, devices=[dev])
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                db = pose_proposal.run(
                    os.path.join(seq, "scan_000.rsdb"),
                    os.path.join(seq, "gt_segmentation", "scan_001.ply"),
                    os.path.join(seq, "again_pp.rsdb"), devices=[dev])
                db = segment_transfer.run(
                    os.path.join(seq, "again_pp.rsdb"),
                    os.path.join(seq, "again.rsdb"), db=db, devices=[dev])
            finally:
                torch.cuda.set_sync_debug_mode(0)
    counted = (db.last_pose_proposal_timings["host_syncs"]
               + db.last_segment_transfer_timings["host_syncs"])
    assert counted > 0
    assert len(waits) == counted


# ---------------------------------------------------------------------------
# the grid and dense engines (ops/hashgrid.py, ops/dense_nn.py)
# ---------------------------------------------------------------------------

def grid_case(name: str):
    """(points, normals, queries, query normals, radius, cap): random
    points with duplicates and exact hits, a lattice of exact distance
    ties, queries outside the grid and FAR-padded, or runs cut by a small
    cap."""
    rng = np.random.default_rng(23)
    cap, radius = None, 0.1
    if name == "lattice":
        g = np.arange(12, dtype=np.float32) / 16
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        pts = pts[rng.permutation(len(pts))]
        q = np.concatenate([pts[:300], pts[300:600] + np.float32(1 / 32)])
        radius = 0.125
    else:
        pts = rng.uniform(0, 1.5, (20000, 3)).astype(np.float32)
        pts[10000:12000] = pts[:2000]
        q = rng.uniform(-0.2, 1.7, (5003, 3)).astype(np.float32)
        q[:500] = pts[:500]
        if name == "outside":
            q[500:504] = [[1e12, 0.5, 0.5], [0.5, -3e9, 0.5],
                          [-gnn.FAR] * 3, [0.5, 0.5, 1.65]]
            q[-200:] = gnn.FAR
        if name == "small_cap":
            cap = 4
    nrm = rng.normal(size=(len(pts), 3)).astype(np.float32)
    qn = rng.normal(size=(len(q), 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    return pts, nrm, q, qn, radius, cap


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g.cpu(), w.cpu())


GRID_CASES = ("random", "lattice", "outside", "small_cap")


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_radius_knn_bit_identical_to_plain(cuda, case, k):
    from rescan_tpu_torch.ops import hashgrid
    pts, nrm, q, _, radius, cap = grid_case(case)
    grid = hashgrid.build_grid(pts, radius, normals=nrm, cap=cap,
                               device=cuda)
    qt = torch.from_numpy(q).to(cuda)
    n0 = hashgrid.LAUNCHES["grid_radius_knn"]
    got = hashgrid.radius_knn(grid, qt, radius, k)
    assert hashgrid.LAUNCHES["grid_radius_knn"] == n0 + 1
    _same(got, hashgrid.radius_knn_ref(grid, qt, radius, k))
    assert (got[2] > 0).sum() > 100


@pytest.mark.parametrize("use_abs,gate", [(False, 0.5), (True, -1.0)])
@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_nearest_gated_bit_identical_to_plain(cuda, case, use_abs,
                                                   gate):
    from rescan_tpu_torch.ops import hashgrid
    pts, nrm, q, qn, radius, cap = grid_case(case)
    grid = hashgrid.build_grid(pts, radius, normals=nrm, cap=cap,
                               device=cuda)
    qt, qnt = torch.from_numpy(q).to(cuda), torch.from_numpy(qn).to(cuda)
    n0 = hashgrid.LAUNCHES["grid_nearest_gated"]
    got = hashgrid.nearest_gated(grid, qt, qnt, radius, gate, use_abs)
    assert hashgrid.LAUNCHES["grid_nearest_gated"] == n0 + 1
    _same(got, hashgrid.nearest_gated_ref(grid, qt, qnt, radius, gate,
                                          use_abs))
    assert (got[0] >= 0).sum() > 100


@pytest.mark.parametrize("use_abs,gate", [(False, 0.5), (True, -1.0)])
@pytest.mark.parametrize("case", ("random", "lattice", "outside"))
def test_dense_kernel_bit_identical_to_plain(cuda, case, use_abs, gate):
    from rescan_tpu_torch.ops import dense_nn
    pts, nrm, q, qn, radius, _ = grid_case(case)
    index = dense_nn.build_dense_index(pts, nrm, device=cuda)
    qt, qnt = torch.from_numpy(q).to(cuda), torch.from_numpy(qn).to(cuda)
    n0 = dense_nn.LAUNCHES["dense_nearest"]
    got = dense_nn.nearest_gated_dense(index, qt, qnt, radius, gate, use_abs)
    assert dense_nn.LAUNCHES["dense_nearest"] == n0 + 1
    _same(got, dense_nn.nearest_gated_dense_ref(index, qt, qnt, radius, gate,
                                                use_abs))
    assert (got[0] >= 0).sum() > 100


def test_smoothing_graph_on_card_matches_cpu(cuda):
    """The smoothing graph's search on the card gives the CPU's graph."""
    from types import SimpleNamespace
    from rescan_tpu_torch import config
    from rescan_tpu_torch.ops import hashgrid, labels
    pts, nrm, _, _, _, _ = grid_case("random")
    lvl = config.LABEL_LVL
    scene = SimpleNamespace(pos=lambda l: pts if l == lvl else None,
                            nrm=lambda l: nrm if l == lvl else None)
    n0 = hashgrid.LAUNCHES["grid_radius_knn"]
    e_card, w_card = labels.build_smoothing_graph(scene, device=cuda)
    assert hashgrid.LAUNCHES["grid_radius_knn"] == n0 + 1
    e_cpu, w_cpu = labels.build_smoothing_graph(scene, device="cpu")
    np.testing.assert_array_equal(e_card, e_cpu)
    np.testing.assert_array_equal(w_card.view(np.int32), w_cpu.view(np.int32))


# ---------------------------------------------------------------------------
# the LoD levels (ops/levels.py, ops/csrc/levels.cu)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_scans(tmp_path_factory):
    """bench.py's two scans (resolution 16) and their class file."""
    import os
    from rescan_tpu_torch import sequences
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = str(tmp_path_factory.mktemp("bench_levels"))
    class_file = sequences.write_bench_sequence(root)
    gt = os.path.join(root, sequences.SEQ_NAME, "gt_segmentation")
    return [os.path.join(gt, f"scan_{i:03d}.ply") for i in (0, 1)], class_file


def _same_levels(got, want):
    from rescan_tpu_torch import config
    from rescan_tpu_torch.core import pointcloud
    for lvl in range(config.N_LEVELS):
        for k in pointcloud._FIELDS:
            np.testing.assert_array_equal(got.levels[lvl][k],
                                          want.levels[lvl][k],
                                          err_msg=f"level {lvl} {k}")


def test_levels_on_card_equal_the_native_pass(cuda, bench_scans):
    """The bench scan's pyramid, and an object merged as ``aug_merge``
    merges one (the scan's extraction moved, merged into the object's
    cloud), built on the card equal the native pass's, every field of
    every level."""
    from rescan_tpu_torch.core import pointcloud
    from rescan_tpu_torch.ops import levels
    PointCloud = pointcloud.PointCloud
    scans, _ = bench_scans
    levels.reset_counts()
    card = PointCloud.from_ply(scans[1], defer_levels_from=3, device=cuda)
    assert levels.LAUNCHES["poisson_levels"] == 1
    assert levels.PLAIN_CALLS["poisson_levels"] == 0
    assert 1 <= max(levels.ROUNDS) <= 10, levels.ROUNDS
    host = PointCloud.from_ply(scans[1])
    _same_levels(card, host)
    ids, n = np.unique(host.levels[1]["instance_ids"], return_counts=True)
    uid = int(ids[ids > 0][np.argmax(n[ids > 0])])
    model = PointCloud.from_ply(scans[0]).extract_by_ids(
        0, "instance_ids", [uid], compute_levels=True)
    seen = host.extract_by_ids(1, "instance_ids", [uid])
    xform = np.eye(4, dtype=np.float32)
    xform[:3, 3] = [0.02, -0.01, 0.0]
    seen.transform(xform)
    _same_levels(seen.merge_with(model, device=cuda), seen.merge_with(model))
    assert levels.LAUNCHES["poisson_levels"] == 2


def test_studio_levels_on_card_equal_the_native_pass(cuda, tmp_path):
    """The studio cell's first scan (scanbench's studio-6x6-10obj, ~1.75M
    points, the largest pyramid the card builds): the card's levels equal
    the native pass's at all four voxels, and level 1 is past the index's
    split limit."""
    import json
    import os
    from rescan_tpu_torch.core import pointcloud
    from rescan_tpu_torch.ops import levels
    from scanbench import scenes
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "scanbench", "configs",
                           "studio-6x6-10obj.json")) as f:
        cfg = json.load(f)
    path = str(tmp_path / "studio.ply")
    scenes.write_ply(path, scenes.scene_mesh(scenes.room_of(cfg),
                                             cfg["mesh_resolution"]))
    levels.reset_counts()
    card = pointcloud.PointCloud.from_ply(path, defer_levels_from=3,
                                          device=cuda)
    assert levels.LAUNCHES["poisson_levels"] == 1
    assert levels.PLAIN_CALLS["poisson_levels"] == 0
    host = pointcloud.PointCloud.from_ply(path)
    _same_levels(card, host)
    counts = [len(card.levels[lvl]["positions"]) for lvl in range(5)]
    print("studio levels", counts, "rounds", levels.ROUNDS)
    assert counts[0] > 1_700_000
    assert counts[1] > int(gnn.MAX_SLAB_COLS * 0.94)


@pytest.fixture(scope="module")
def bench_rescan(bench_scans, tmp_path_factory):
    """The bench rescan on cuda:0 as the benchmark runs it (the prior
    reloaded from its .rsdb), after a warm-up rescan: the levels'
    counters over it, each ``compute_levels`` call's seconds, and both
    stages' timings."""
    import contextlib
    import io
    import os
    import time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rescan_tpu_torch.core import pointcloud
    from rescan_tpu_torch.ops import levels
    from rescan_tpu_torch.pipeline import (pose_proposal, seg2rsdb,
                                           segment_transfer)
    from rescan_tpu_torch.utils import timing
    dev = torch.device("cuda", 0)
    (scan0, scan1), class_file = bench_scans
    out = str(tmp_path_factory.mktemp("bench_rescan"))
    prior = os.path.join(out, "prior.rsdb")

    def rescan(name):
        pp = os.path.join(out, name + "_pp.rsdb")
        db = pose_proposal.run(prior, scan1, pp, devices=[dev])
        return segment_transfer.run(pp, os.path.join(out, name + ".rsdb"),
                                    db=db, devices=[dev])

    calls = []
    compute = pointcloud.PointCloud.compute_levels

    def timed(self, *a, **k):
        in_stage = timing._OPEN.get() is not None
        t0 = time.perf_counter()
        try:
            return compute(self, *a, **k)
        finally:
            calls.append((time.perf_counter() - t0, in_stage))

    with contextlib.redirect_stdout(io.StringIO()):
        seg2rsdb.run(scan0, class_file, prior)
        rescan("warm")
        torch.cuda.synchronize()
        levels.reset_counts()
        pointcloud.PointCloud.compute_levels = timed
        try:
            db = rescan("again")
        finally:
            pointcloud.PointCloud.compute_levels = compute
    return {"launches": levels.LAUNCHES["poisson_levels"],
            "plain": levels.PLAIN_CALLS["poisson_levels"], "calls": calls,
            "timings": (db.last_pose_proposal_timings,
                        db.last_segment_transfer_timings)}


def test_bench_rescan_builds_every_level_on_card(cuda, bench_rescan):
    """Every pyramid of a bench rescan on the card is built there: the
    native pass runs zero times."""
    assert bench_rescan["plain"] == 0
    assert bench_rescan["launches"] == len(bench_rescan["calls"]) > 0


def test_levels_span_covers_every_call_site(cuda, bench_rescan):
    """Every ``compute_levels`` call of the rescan runs inside a stage, and
    the stages' ``levels`` spans sum to the calls' seconds, less only the
    spans' own entry and exit."""
    calls = bench_rescan["calls"]
    assert all(in_stage for _, in_stage in calls)
    spanned = sum(t.get("levels", 0.0) for t in bench_rescan["timings"])
    called = sum(sec for sec, _ in calls)
    assert 0.95 * called <= spanned <= called
