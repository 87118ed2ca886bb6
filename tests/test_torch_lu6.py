"""The port's 6x6 solve (rescan_tpu_torch/ops/lu6.py) bit for bit against
``jnp.linalg.solve`` and ``jax.lax.linalg.lu`` on the CPU, the calls the
JAX package's ICP step makes (rescan_tpu/ops/icp.py:162)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu_torch.ops import lu6
from test_torch_cuda import lu6_systems as _systems


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["spd", "icp", "general", "singular"])
def test_solve_matches_jnp_linalg_solve(kind):
    """2,000 systems of each kind: the same bits as jnp.linalg.solve,
    non-finite entries included, and after icp.py:163's guard."""
    c, b = _systems(kind)
    want = np.asarray(jax.jit(
        lambda c, b: jnp.linalg.solve(c, b[..., None])[..., 0])(c, b))
    got = lu6.solve(torch.from_numpy(c), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "icp":
        cond = np.linalg.cond(c.astype(np.float64))
        assert cond.max() > 1e6, cond.max()
    if kind == "singular":
        assert not np.isfinite(want).all()
    guard = np.where(np.isfinite(got), got, 0.0)
    np.testing.assert_array_equal(guard, np.where(np.isfinite(want), want,
                                                  0.0))


@pytest.mark.parametrize("kind", ["spd", "general"])
def test_lu_matches_lax_lu(kind):
    """The factors and pivots equal jax.lax.linalg.lu's (sgetrf)."""
    c, _ = _systems(kind, seed=1)
    lu_j, piv_j, _ = jax.jit(jax.lax.linalg.lu)(c)
    a, ipiv = lu6.lu(torch.from_numpy(c))
    np.testing.assert_array_equal(a.numpy(), np.asarray(lu_j))
    np.testing.assert_array_equal(ipiv.numpy(), np.asarray(piv_j))
