"""The port's gated-NN search (rescan_tpu_torch/ops/gnn.py, plain PyTorch
version on the CPU) against the Pallas kernel in interpret mode.

Both sides get one identical slab (``slab_from_numpy`` of the JAX
package's ``SortedSlab``) and the same queries; ``(idx, d2, dot)`` must be
bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu.ops import pallas_nn
from rescan_tpu_torch.ops import gnn, icp as ticp, score as tscore
from test_torch_cuda import EDGE_IN, EDGE_R, edge_slab

COS35 = float(np.cos(np.deg2rad(np.float32(35.0))))
COS60 = float(np.cos(np.float32(np.deg2rad(60.0))))


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


def _port_slab(js):
    return gnn.slab_from_numpy(np.asarray(js.slab), np.asarray(js.tile_bounds),
                               np.asarray(js.perm), int(js.n_valid),
                               np.asarray(js.center), js.tile,
                               device="cpu")


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile,radius,cos_gate,use_abs_dot", [
    (2048, 0.1, COS35, False),     # scoring: tile 2048, bq 128
    (1024, 0.15, COS60, False),    # ICP: tile 1024, bq 128
    (1024, 0.1, 0.5, True),
    (2048, 0.075, -1.0, True),     # label transfer: |dot|, no gate
])
def test_plain_bit_identical_to_pallas(tile, radius, cos_gate, use_abs_dot):
    pts, nrm, q, qn = _data(11)
    js = pallas_nn.build_sorted_slab(pts, nrm, tile=tile)
    ji, jd2, jdot = pallas_nn.nearest_gated_pallas(
        js, jnp.asarray(q), jnp.asarray(qn), radius, cos_gate,
        use_abs_dot=use_abs_dot, bq=128)
    jd2m, jdotm = pallas_nn.gated_min_pallas(
        js, jnp.asarray(q), jnp.asarray(qn), radius, cos_gate,
        use_abs_dot=use_abs_dot, bq=128)
    slab = _port_slab(js)
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    gnn.reset_counts()
    ti, td2, tdot = gnn.nearest_gated(slab, qt, qnt, radius, cos_gate,
                                      use_abs_dot)
    td2m, tdotm = gnn.gated_min(slab, qt, qnt, radius, cos_gate, use_abs_dot)
    # CPU tensors take the plain version and launch nothing
    assert gnn.PLAIN_CALLS == {"gated_min": 1, "nearest_gated": 1,
                               "gated_min_set": 0, "nearest_gated_set": 0}
    assert gnn.LAUNCHES == {"gated_min": 0, "nearest_gated": 0,
                            "gated_min_set": 0, "nearest_gated_set": 0}
    assert (np.asarray(ji) >= 0).sum() > 50
    _same_bits(ji, ti.numpy())
    _same_bits(jd2, td2.numpy())
    _same_bits(jdot, tdot.numpy())
    _same_bits(jd2m, td2m.numpy())
    _same_bits(jdotm, tdotm.numpy())


def test_port_slab_build_gives_reference_results():
    """The port's own build_sorted_slab (no VMEM split, no tile-count
    buckets) answers every query exactly as the JAX slab does."""
    pts, nrm, q, qn = _data(5, n=5000, m=900)
    js = pallas_nn.build_sorted_slab(pts, nrm, tile=1024)
    ji, jd2, jdot = pallas_nn.nearest_gated_pallas(
        js, jnp.asarray(q), jnp.asarray(qn), 0.12, COS60, bq=128)
    slab = gnn.build_sorted_slab(pts, nrm, tile=1024, device="cpu")
    np.testing.assert_array_equal(slab.center.numpy(), np.asarray(js.center))
    ti, td2, tdot = gnn.nearest_gated(slab, torch.from_numpy(q),
                                      torch.from_numpy(qn), 0.12, COS60)
    _same_bits(ji, ti.numpy())
    _same_bits(jd2, td2.numpy())
    _same_bits(jdot, tdot.numpy())


def test_f32_constants_match_jax():
    """cos gates, r^2 and the gate threshold are formed in f32 exactly as
    the jitted JAX code forms them: a 1-ulp change flips rare queries."""
    ref35 = np.asarray(jax.jit(lambda: jnp.cos(jnp.deg2rad(35.0)))())
    assert np.float32(tscore.SCORE_COS_GATE).view(np.int32) == \
        ref35.view(np.int32)
    for deg in (60.0, 50.0, 10.0):
        ang = np.deg2rad(deg)
        ref = np.asarray(jax.jit(jnp.cos)(ang))
        assert np.float32(ticp.cos_gate_of(ang)).view(np.int32) == \
            ref.view(np.int32), deg
    for radius, cg in ((0.1, COS35), (0.075, COS60), (0.15, -1.0)):
        r2, radj, thr = gnn.gate_params(radius, cg)
        jr2, jradj, jthr = (np.asarray(x) for x in jax.jit(
            lambda r, c: (r * r, jnp.sqrt(r * r), c - 1e-6))(
                jnp.float32(radius), jnp.float32(cg)))
        for a, b in ((r2, jr2), (radj, jradj), (thr, jthr)):
            assert np.float32(a).view(np.int32) == b.view(np.int32)


def test_morton_helpers_match():
    rng = np.random.default_rng(3)
    p = rng.uniform(-1, 3, (4000, 3)).astype(np.float32)
    for cell in (0.2, 0.4, 3.0):
        np.testing.assert_array_equal(gnn.morton_key(p, cell),
                                      pallas_nn.morton_key(p, cell))
    np.testing.assert_array_equal(gnn.morton_order(p),
                                  pallas_nn.morton_order(p))


def test_fma32_is_correctly_rounded():
    """The plain version's fused multiply-add equals XLA's compiled
    contraction of a*a + b*b + c*c (the pattern the kernel reproduces)."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(200_000).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jax.jit(lambda a, b, c: a * a + b * b + c * c)(a, b, c))
    at, bt, ct = (torch.from_numpy(x) for x in (a, b, c))
    got = gnn._fma32(ct, ct, gnn._fma32(at, at, bt * bt)).numpy()
    _same_bits(ref, got)


def test_unsupported_device_raises():
    pts, nrm, q, qn = _data(1, n=1000, m=60)
    slab = gnn.build_sorted_slab(pts, nrm, device="cpu")
    with pytest.raises(ValueError):
        gnn.nearest_gated(slab, torch.from_numpy(q).to("meta"),
                          torch.from_numpy(qn).to("meta"), 0.1, 0.5)


def test_run_table_is_shared():
    """One run table per slab, built with it on its device: the bounds of
    each run's valid columns (FAR for runs of padding), and the plain
    version prunes with exactly that table."""
    pts, nrm, q, qn = _data(2, n=2500, m=300)
    slab = gnn.build_sorted_slab(pts, nrm, tile=1024, device="cpu")
    rb = slab.run_bounds.numpy()
    xyz = slab.slab[0:3].numpy().T.reshape(-1, gnn.RUN, 3)
    valid = (slab.perm.numpy() >= 0).reshape(-1, gnn.RUN)
    assert rb.shape == (slab.slab.shape[1] // gnn.RUN, 8)
    for r in range(len(rb)):
        if valid[r].any():
            np.testing.assert_array_equal(rb[r, 0:3], xyz[r][valid[r]].min(0))
            np.testing.assert_array_equal(rb[r, 4:7], xyz[r][valid[r]].max(0))
        else:
            assert (rb[r, [0, 1, 2, 4, 5, 6]] == gnn.FAR).all()
    assert (~valid).all(1).any()        # the fixture has padding runs
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    assert (gnn.nearest_gated(slab, qt, qnt, 0.1, 0.5)[0] >= 0).any()
    slab.run_bounds = torch.full_like(slab.run_bounds, gnn.FAR)
    assert (gnn.nearest_gated(slab, qt, qnt, 0.1, 0.5)[0] == -1).all()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("use_abs_dot,cos_gate", [(False, 0.5), (True, -1.0)])
def test_run_pruning_keeps_columns_at_r(mixed, use_abs_dot, cos_gate,
                                        monkeypatch):
    """Columns exactly at r and just inside it, each on the boundary of its
    run (test_torch_cuda.edge_slab): the plain version is the Pallas
    kernel's bit for bit and finds the column just inside r (the lowest
    of a tie); with the run test's margin taken away it drops that run,
    so the fixture sees over-pruning."""
    (sl, tb, perm, n_valid, center, tile), q, qn = edge_slab(mixed)
    js = pallas_nn.SortedSlab(jnp.asarray(sl), jnp.asarray(tb),
                              jnp.asarray(perm), n_valid, jnp.asarray(center),
                              n_tiles=len(tb), tile=tile)
    ji, jd2, jdot = pallas_nn.nearest_gated_pallas(
        js, jnp.asarray(q), jnp.asarray(qn), EDGE_R, cos_gate,
        use_abs_dot=use_abs_dot, bq=128)
    slab = gnn.slab_from_numpy(sl, tb, perm, n_valid, center, tile,
                               device="cpu")
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    ti, td2, tdot = gnn.nearest_gated(slab, qt, qnt, EDGE_R, cos_gate,
                                      use_abs_dot)
    _same_bits(ji, ti.numpy())
    _same_bits(jd2, td2.numpy())
    _same_bits(jdot, tdot.numpy())
    real = q[:, 0] == 0
    assert (ti.numpy()[real] == perm[95]).all()
    assert (ti.numpy()[~real] == -1).all()
    d = np.float32(EDGE_IN)
    assert (td2.numpy()[real] == np.float32(d * d)).all()
    assert np.float32(EDGE_R) ** 2 == gnn.gate_params(EDGE_R, 0)[0]
    monkeypatch.setattr(gnn, "run_slack", lambda radj: float(radj) * 0.99999)
    tight = gnn.nearest_gated(slab, qt, qnt, EDGE_R, cos_gate, use_abs_dot)
    assert (tight[0].numpy()[real] == -1).all()
