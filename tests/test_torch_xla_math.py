"""ops/xla_math.py's plain versions of XLA:CPU's f32 exp, arccos, cos and
sin against ``jnp`` bit for bit, on a million seeded arguments each over
the domain the pipeline gives them and beyond, and on their edges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu_torch.ops import xla_math

N = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EDGES = np.array([
    0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1e-45, -1e-45, 1e-40, -1e-40,
    1.1754942e-38, 1.17549435e-38, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38,
    # exp: the clamps, the last normal result and the flush to zero
    -87.8, -87.80001, -87.5, -87.3, -87.33655, -88.0, -103.9, -104.0, 88.7,
    88.72283, 88.73, 88.8, 89.0,
    # cos and sin: the ranges of glibc's reduction (0.75, 2^-12, 119.5)
    0.75, 0.74999994, 2 ** -12, 2 ** -12 * 0.999, 119.5, 119.49999, 120.0,
    -120.0, 1e30, -1e30, 2.0 ** 25, 2.0 ** 60,
    # atanf's argument ranges
    0.4375, 0.6875, 1.1875, 2.4375], np.float32)

DOMAINS = {
    # scoring's -angle^2 / 0.5 and -d2 / 0.02, then the whole line
    "exp": lambda r: [r.uniform(-5, 0, N), -r.uniform(0, 0.6, N),
                      r.uniform(-100, 100, N), r.uniform(-88.5, -86, N),
                      r.uniform(87, 89, N)],
    # scoring's clamped dot over [0, 1], dense near 1 and 0, then [-1, 1]
    "arccos": lambda r: [r.uniform(0, 1, N), 1 - 10 ** r.uniform(-8, 0, N),
                         10 ** r.uniform(-12, 0, N), r.uniform(-1, 1, N)],
    # the ICP's rotation angles (small), then every magnitude
    "cos": lambda r: [r.uniform(-0.2, 0.2, N), r.uniform(-4, 4, N),
                      r.uniform(-1, 1, N) * 10.0 ** r.uniform(-8, 6, N)],
}
DOMAINS["sin"] = DOMAINS["cos"]

FUNCTIONS = {"exp": (jnp.exp, xla_math.exp_ref),
             "arccos": (jnp.arccos, xla_math.acos_ref),
             "cos": (jnp.cos, xla_math.cos_ref),
             "sin": (jnp.sin, xla_math.sin_ref)}


def _same(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_plain_equals_jnp(name):
    """Every argument bit for bit (a NaN equal to any NaN): the million
    of each domain and the edges (0, +-1, subnormals, the overflow and
    underflow of exp, NaN, +-inf, the reduction ranges)."""
    jfn, tfn = FUNCTIONS[name]
    rng = np.random.default_rng(sorted(FUNCTIONS).index(name))
    for x in DOMAINS[name](rng) + [EDGES]:
        x = np.asarray(x, np.float32)
        want = np.asarray(jax.jit(jfn)(x))
        got = tfn(torch.from_numpy(x)).numpy()
        same = _same(got, want)
        assert same.all(), (name, x[~same][:5], got[~same][:5],
                            want[~same][:5])


def test_dispatch_on_cpu():
    """exp, acos and sincos on CPU tensors are the plain versions (and
    count plain calls, not launches)."""
    from rescan_tpu_torch.ops import pairsum
    x = torch.from_numpy(np.linspace(-3, 3, 1001, dtype=np.float32))
    pairsum.reset_counts()
    assert torch.equal(xla_math.exp(x), xla_math.exp_ref(x))
    assert torch.equal(xla_math.acos(x.clamp(-1, 1)),
                       xla_math.acos_ref(x.clamp(-1, 1)))
    cs = xla_math.sincos(x)
    assert cs.shape == (2, 1001)
    assert torch.equal(cs[0], xla_math.cos_ref(x))
    assert torch.equal(cs[1], xla_math.sin_ref(x))
    assert pairsum.PLAIN_CALLS["xla_math"] == 3
    assert pairsum.LAUNCHES["xla_math"] == 0
