"""The CUDA gated-NN kernel against its plain PyTorch version, on the card.

Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every test here needs a CUDA device and skips without one.
"""

import numpy as np
import pytest
import torch

from rescan_tpu_torch.ops import gnn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
    assert gnn.LAUNCHES == {"gated_min": 1, "nearest_gated": 1}
    assert gnn.PLAIN_CALLS == {"gated_min": 0, "nearest_gated": 0}
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
