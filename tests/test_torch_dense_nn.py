"""The port's dense engine (rescan_tpu_torch/ops/dense_nn.py) against the
JAX package's (rescan_tpu/ops/dense_nn.py, JAX on the CPU), and the CUDA
kernel's own source (``dense_nearest_kernel`` in ops/csrc/hashgrid.cu)
built with g++ against tests/data/torch_port_emu_cuda.h, bit for bit on
the same numpy inputs.

How the arithmetic was read: the JAX function's d2 was held against the
fused-multiply-add orders of |q|^2, |p|^2 and q.p and the orders of the
expansion's two additions on random queries (jaxlib 0.9.0): every one of
the three is fma(z, z', fma(y, y', x * x')), then (|q|^2 + |p|^2) - 2 q.p
(the same bits as an FMA of -2, as 2 q.p is exact); the gate dot the
same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu.ops import dense_nn as jdense
from rescan_tpu.ops import search as jsearch
from rescan_tpu_torch.ops import dense_nn, search
from test_torch_hashgrid import CASES, GATES, assert_same, build_emulated
from test_torch_hashgrid import make_case


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indexes(case, tile=512):
    pts, nrm, q, qn, radius, _ = make_case(case)
    ji = jdense.build_dense_index(pts, nrm, tile=tile)
    ti = dense_nn.build_dense_index(pts, nrm, tile=tile, device="cpu")
    return ji, ti, q, qn, radius


@pytest.mark.parametrize("use_abs,gate", GATES)
@pytest.mark.parametrize("case", CASES)
def test_dense_matches_jax(case, use_abs, gate):
    ji, ti, q, qn, radius = _indexes(case)
    want = jdense.nearest_gated_dense(ji, jnp.asarray(q), jnp.asarray(qn),
                                      radius, gate, use_abs_dot=use_abs)
    got = dense_nn.nearest_gated_dense(ti, torch.from_numpy(q),
                                       torch.from_numpy(qn), radius, gate,
                                       use_abs_dot=use_abs)
    assert_same(got, want, case)
    if case != "none_found":
        assert (got[0] >= 0).any()


def test_dense_chunked_and_unpadded():
    """The JAX function's host-driven chunks (queries padded to whole
    chunks) and a point count that fills its tiles exactly."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (1024, 3)).astype(np.float32)
    nrm = np.tile(np.float32([0, 0, 1]), (1024, 1))
    q = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    qn = np.tile(np.float32([0, 0.6, 0.8]), (700, 1))
    ji = jdense.build_dense_index(pts, nrm, tile=256)
    ti = dense_nn.build_dense_index(pts, nrm, tile=256, device="cpu")
    want = jdense.nearest_gated_dense(ji, jnp.asarray(q), jnp.asarray(qn),
                                      0.08, 0.5, chunk=256)
    got = dense_nn.nearest_gated_dense(ti, torch.from_numpy(q),
                                       torch.from_numpy(qn), 0.08, 0.5)
    assert_same(got, want, "chunked")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build_emulated(tmp_path_factory)


@pytest.mark.parametrize("use_abs,gate", GATES[:2])
@pytest.mark.parametrize("case", CASES)
def test_emulated_dense_matches_plain(emu, case, use_abs, gate):
    """Tiles of 256 points staged by 128 threads; the index's own tile
    (512) and the kernel's differ, which changes no result."""
    _, ti, q, qn, radius = _indexes(case)
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    want = dense_nn.nearest_gated_dense_ref(ti, qt, qnt, radius, gate,
                                            use_abs)
    m = len(q)
    got = (torch.empty(m, dtype=torch.int32), torch.empty(m), torch.empty(m))
    assert emu.dense_nearest(*dense_nn.dense_args(
        ti, qt, qnt, radius, gate, use_abs, *got), None) == 0
    assert_same(got, want, case)


def test_search_dispatch_on_the_dense_index():
    """search.nearest_gated, gated_min and index_arrays on a DenseIndex
    equal the JAX package's search functions on its own."""
    pts, nrm, q, qn, radius, _ = make_case("duplicates")
    ji = jdense.build_dense_index(pts, nrm)
    ti = dense_nn.build_dense_index(pts, nrm, device="cpu")
    jq, jqn = jnp.asarray(q), jnp.asarray(qn)
    tq, tqn = torch.from_numpy(q), torch.from_numpy(qn)
    assert_same(search.nearest_gated(ti, tq, tqn, radius, 0.5),
                jsearch.nearest_gated(ji, jq, jqn, radius, 0.5), "nearest")
    assert_same(search.gated_min(ti, tq, tqn, radius, -1.0, True),
                jsearch.gated_min(ji, jq, jqn, radius, -1.0, True),
                "gated_min")
    assert_same(search.index_arrays(ti), jsearch.index_arrays(ji),
                "index_arrays")


def test_dense_counts():
    """CPU tensors take the plain version and count it; its pair counts
    are every pair (what the kernel evaluates) and those within r."""
    _, ti, q, qn, radius = _indexes("random")
    dense_nn.reset_counts()
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    dense_nn.nearest_gated_dense(ti, qt, qnt, radius, 0.5)
    assert dense_nn.PLAIN_CALLS == {"dense_nearest": 1}
    assert dense_nn.LAUNCHES == {"dense_nearest": 0}
    stats = {}
    idx, _, _ = dense_nn.nearest_gated_dense_ref(ti, qt, qnt, radius, -1.0,
                                                 stats=stats)
    assert stats["pairs"] == len(q) * ti.n_valid
    assert (idx >= 0).sum() <= stats["in_radius"] < stats["pairs"]
