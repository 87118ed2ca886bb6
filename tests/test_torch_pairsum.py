"""ops/pairsum.py and the ICP step's elementwise orders (ops/icp.py) bit
for bit against the JAX package's compiled arithmetic on random rows, and
the CUDA kernel's source (ops/csrc/pairsum.cu), built with g++ against
tests/data/torch_port_emu_cuda.h, against the plain version."""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu_torch.ops import icp as ticp, lu6, pairsum, xla_math
from rescan_tpu_torch.ops.pairsum import (BLOCKED, BLOCKED_TAIL, CHAIN,
                                          FOLDED, FOLDED_TAIL, LANES,
                                          LANES_TAIL, ONE, WINDOW)
from test_torch_cuda import (HEAD_TILE_EDGES, chain_cases, icp_head_inputs,
                             icp_tail_inputs, lu6_systems, score_inputs,
                             shifted, xla_math_args)

HERE = os.path.dirname(os.path.abspath(__file__))
HEADER = os.path.join(HERE, "data", "torch_port_emu_cuda.h")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(rng, b, n):
    """Weights with the ICP's zeros: a fifth of the points unmatched."""
    return (rng.random((b, n)) * (rng.random((b, n)) < 0.8)).astype(
        np.float32)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("n", [128, 1024, 4096, 32768])
def test_window_sum_matches_jnp_sum(n):
    """jnp.sum(x, axis=1) (icp.py:132-142, score.py:168)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(8, n)).astype(np.float32) * (rng.random((8, n))
                                                      < 0.7)
    want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=1))(x))
    got = pairsum.sums(torch.from_numpy(x)[..., None], [(WINDOW, 0, ONE)])
    np.testing.assert_array_equal(got[:, 0].numpy(), want)


@pytest.mark.parametrize("b,n", [(8, 1024), (8, 2048), (64, 4096),
                                 (8, 8192), (4, 16384), (2, 32768),
                                 (1, 128), (1, 256), (1, 512), (1, 1024),
                                 (1, 2048), (1, 4096), (1, 16384),
                                 (1, 32768)])
def test_icp_sum_rounds_match_xla(b, n):
    """The ICP step's rounds 3 and 4 (w, w q, w p2; C, b, e2), laid out
    and specified as ops/icp.py lays them out, against the einsums of
    icp.py:142-165 at the same batch: many pairs (XLA's gemv and Eigen
    orders) and one pair (its vectorized loop, folded into one vector up
    to 256 points, or one chain from 4096 points); from 16384 points C's
    8 slices and their two trees (BLOCKED, BLOCKED_TAIL)."""
    rng = np.random.default_rng(b * n)
    w = _w(rng, b, n)
    q, p2 = (rng.normal(size=(b, n, 3)).astype(np.float32) for _ in "ab")
    j6 = rng.normal(size=(b, n, 6)).astype(np.float32)
    ddn = rng.normal(size=(b, n)).astype(np.float32)
    want3 = jax.jit(lambda w, q, p2: (
        jnp.sum(w, axis=1), jnp.einsum("bn,bni->bi", w, q),
        jnp.einsum("bn,bni->bi", w, p2)))(w, q, p2)
    want4 = jax.jit(lambda w, j6, ddn: (
        jnp.einsum("bn,bni,bnj->bij", w, j6, j6),
        jnp.einsum("bn,bni,bn->bi", w, j6, ddn),
        jnp.einsum("bn,bn->b", w, ddn * ddn)))(w, j6, ddn)
    spec3, spec4 = ticp._specs(n, b == 1)
    tw, tq, tp2, tj6, tddn = _t(w, q, p2, j6, ddn)
    s3 = pairsum.sums(torch.cat([tw[..., None], tq, tp2], -1), spec3)
    wj6 = tw[..., None] * tj6
    s4 = pairsum.sums(torch.cat([wj6, tj6, tddn[..., None], tw[..., None],
                                 (tddn * tddn)[..., None]], -1), spec4)
    got = (s3[:, 0], s3[:, 1:4], s3[:, 4:7], s4[:, :36].reshape(b, 6, 6),
           s4[:, 36:42], s4[:, 42])
    for g, wnt in zip(got, tuple(want3) + tuple(want4)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_chained_state_equals_the_whole_axis():
    """A pair's points split into 2, 4, 8 or 128 runs, each continuing
    the previous run's state, give the whole axis's sums bit for bit (the
    mesh's sp mode), a LANES sum's last run holding only its tail
    included."""
    rng = np.random.default_rng(3)
    n = 4096
    x = torch.from_numpy(rng.normal(size=(4, n, 3)).astype(np.float32))
    spec = [(WINDOW, 0, ONE), (CHAIN, 0, 1), (BLOCKED, 1, 2),
            (WINDOW, 2, 0), (LANES, 0, 2), (LANES_TAIL, 1, ONE)]
    whole = pairsum.sums(x, spec)
    for parts in (2, 4, 8, 128):
        m = n // parts
        st = None
        for k in range(parts):
            st = pairsum.pairsum(x[:, k * m:(k + 1) * m], spec, n0=k * m,
                                 n_total=n, state=st)
        np.testing.assert_array_equal(pairsum.totals(st, spec, n).numpy(),
                                      whole.numpy())


def test_geometry():
    """The window levels and Eigen's k-blocks (measured: 256 up to 2048
    points; 296 at 4096 and 8192, the last two blocks of equal length;
    from 16384 points 8 slices of their own blocks, 296 long in slices of
    2048 and 320 beyond, added in two ranges of 4)."""
    assert pairsum.window_sizes(4096) == [4096, 128, 4]
    assert pairsum.window_sizes(1024) == [1024, 32]
    assert pairsum.blocked_ends(1024) == [256, 512, 768, 1024]
    ends = pairsum.blocked_ends(4096)
    assert ends[:2] == [296, 592] and ends[-3:] == [3552, 3824, 4096]
    assert pairsum.blocked_ends(8192)[-3:] == [7696, 7944, 8192]
    assert pairsum.single_pair_kind(1024, True) == LANES_TAIL
    assert pairsum.single_pair_kind(1024, False) == LANES
    assert pairsum.single_pair_kind(4096, True) == CHAIN
    d = pairsum._depths_np(1024)
    assert d[WINDOW].sum() == 32 and d[WINDOW, 1023] == 1
    assert d[BLOCKED].sum() == 4 and d[CHAIN].sum() == 0
    ends = pairsum.blocked_ends(16384)
    assert ends[:7] == [296, 592, 888, 1184, 1480, 1776, 2048]
    assert len(ends) == 56 and ends[-1] == 16384
    assert pairsum.top_level(BLOCKED, 16384) == 4
    assert pairsum.top_level(BLOCKED_TAIL, 16384) == 4
    # at slice ends: ((s0 + s1) + (s2 + s3)), and s0 + ((s1 + s2) + s3)
    # past the last whole packet; each range into the total
    d = pairsum._depths_np(16384)
    slice_ends = [e - 1 for e in ends if e % 2048 == 0]
    assert d[BLOCKED][slice_ends].tolist() == [2, 3, 2, 4] * 2
    assert d[BLOCKED_TAIL][slice_ends].tolist() == [3, 2, 2, 4] * 2
    ends = pairsum.blocked_ends(262144)
    assert ends[:2] == [320, 640] and ends[-1] == 262144
    assert len(ends) == 8 * 103 and 32768 in ends
    # any n has an order: 8193 points in 8 slices of 1032, the last 969
    # long
    ends = pairsum.blocked_ends(8193)
    assert pairsum._slices(8193) == list(range(0, 8193, 1032))
    assert 7224 in ends and ends[-1] == 8193 and sorted(ends) == ends
    d = pairsum._depths_np(8193)
    assert d[BLOCKED][[s - 1 for s in range(1032, 8193, 1032)] + [
        8192]].tolist() == [2, 3, 2, 4] * 2


def test_elementwise_orders_match_xla():
    """The step's products outside the sums (icp.py:101-177): R p + t,
    R n, the cross product, ddn, the 3x3 and 4x4 products, R c1."""
    rng = np.random.default_rng(5)
    b, n = 8, 1024
    R = rng.normal(size=(b, 3, 3)).astype(np.float32)
    t, c1 = (rng.normal(size=(b, 3)).astype(np.float32) for _ in "ab")
    p, nr = (rng.normal(size=(b, n, 3)).astype(np.float32) for _ in "ab")
    A3, B3 = (rng.normal(size=(b, 3, 3)).astype(np.float32) for _ in "ab")
    A4, B4 = (rng.normal(size=(b, 4, 4)).astype(np.float32) for _ in "ab")
    want = jax.jit(lambda R, p, nr, t, c1, A3, B3, A4, B4: (
        jnp.einsum("bij,bnj->bni", R, p) + t[:, None, :],
        jnp.einsum("bij,bnj->bni", R, nr),
        jnp.cross(p - c1[:, None], nr),
        jnp.einsum("bni,bni->bn", p, nr),
        A3 @ B3, A4 @ B4, jnp.einsum("bij,bj->bi", R, c1)))(
            R, p, nr, t, c1, A3, B3, A4, B4)
    tR, tp, tn, tt, tc1, tA3, tB3, tA4, tB4 = _t(R, p, nr, t, c1, A3, B3,
                                                 A4, B4)
    got = (*ticp._transform(tR, tt, tp, tn),
           ticp._cross(tp - tc1[:, None], tn),
           tp[..., 0] * tn[..., 0] + tp[..., 1] * tn[..., 1]
           + tp[..., 2] * tn[..., 2],
           ticp._matmul(tA3, tB3), ticp._matmul(tA4, tB4),
           ticp._matmul(tR, tc1[..., None])[..., 0])
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_rotation_trig_against_xla():
    """cos and sin of the rotation's angles (icp.py:40-58): the port's
    ``xla_math.sincos`` equals XLA's f32 ones (glibc's cosf/sinf) bit for
    bit on 200,000 angles at each scale the ICP's updates take."""
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1e-2, 1e-1, 1.0):
        x = (rng.uniform(-1, 1, 200_000) * scale).astype(np.float32)
        want = np.asarray(jax.jit(
            lambda v: jnp.stack([jnp.cos(v), jnp.sin(v)]))(x))
        got = xla_math.sincos(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


# ---------------------------------------------------------------------------
# The kernel's source on the CPU
# ---------------------------------------------------------------------------

def _emulated_source() -> str:
    """pairsum.cu with the emulation header, each launch a loop over
    blocks whose threads meet at __syncthreads (a warp: real threads;
    more: fibers on the calling thread)."""
    with open(pairsum._SRC) as f:
        s = f.read()
    launch = ("#define PAIRSUM_LAUNCH(kernel, blocks, threads, stream, ...) "
              "do { (void)(stream); emulate_block_launch((blocks), (threads), "
              "[&] { kernel(__VA_ARGS__); }); } while (0)")
    a = "#include <cuda_runtime.h>"
    assert s.count(a) == 1 and "#ifndef PAIRSUM_LAUNCH" in s
    return s.replace(a, f'#include "{HEADER}"\n{launch}')


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the emulated kernel"
    d = tmp_path_factory.mktemp("pairsum_emu")
    src, out = d / "pairsum_emu.cpp", d / "libpairsum_emu.so"
    src.write_text(_emulated_source())
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-I",
                        os.path.dirname(pairsum._SRC), "-o", str(out),
                        str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return pairsum.bind(ctypes.CDLL(str(out)))


def _run_emu(lib, x, spec, n0, n_total, state):
    spec_t = pairsum.as_spec(spec).contiguous()
    out = pairsum.new_state(x.shape[0], spec_t.shape[0], "cpu")
    if state is not None:
        out.copy_(state)
    shape = pairsum._shape(x.shape[2], spec_t.shape[0])
    tiles = pairsum._tiles_cached(n_total, n0, x.shape[1], shape, "cpu")
    folds = pairsum._folds_cached(n_total, "cpu")
    rc = lib.pairsum_run(x.data_ptr(), x.shape[0], x.shape[1], x.shape[2],
                         spec_t.data_ptr(), spec_t.shape[0], tiles.data_ptr(),
                         folds.data_ptr(), n0, n_total, out.data_ptr(),
                         shape == "small", None)
    assert rc == 0
    return out


@pytest.mark.parametrize("n,parts", [(128, 1), (256, 2), (1024, 1),
                                     (4096, 1), (4096, 4), (2048, 1),
                                     (1024, 32), (16384, 1), (32768, 8)])
def test_emulated_kernel_matches_plain(emu, n, parts):
    """Every kind, whole axis and chained runs: the kernel's states equal
    the plain version's bit for bit; from 16384 points the cascades of C's
    slice trees (levels 3 and 4) run too."""
    rng = np.random.default_rng(n + parts)
    x = torch.from_numpy(rng.normal(size=(5, n, 4)).astype(np.float32)
                         * (rng.random((5, n, 4)) < 0.8))
    spec = [(WINDOW, 0, ONE), (CHAIN, 0, 1), (BLOCKED, 1, 2),
            (WINDOW, 3, ONE), (CHAIN, 2, 3), (LANES, 0, 1),
            (LANES_TAIL, 2, 3), (LANES_TAIL, 1, ONE), (BLOCKED_TAIL, 0, 3)]
    m = n // parts
    st_p = st_k = None
    for k in range(parts):
        xs = x[:, k * m:(k + 1) * m].contiguous()
        st_p = pairsum.pairsum_ref(xs, spec, k * m, n, st_p)
        st_k = _run_emu(emu, xs, spec, k * m, n, st_k)
        assert torch.equal(st_k.view(torch.int32), st_p.view(torch.int32))


# a launch of a few sums over few columns takes the kernel's small shape
SMALL_SPEC = [(WINDOW, 0, ONE), (CHAIN, 0, 1), (LANES_TAIL, 1, 2),
              (BLOCKED_TAIL, 2, 3)]


@pytest.mark.parametrize("n,parts", [(256, 1), (1024, 4), (4096, 1),
                                     (32768, 8)])
def test_emulated_small_shape_matches_plain(emu, n, parts):
    """The kernel's small shape (a few sums over a few columns, as
    scoring's means): every chained kind and LANES, whole axis and chained
    runs, bit for bit."""
    assert pairsum._shape(4, len(SMALL_SPEC)) == "small"
    rng = np.random.default_rng(n + 7 * parts)
    x = torch.from_numpy(rng.normal(size=(6, n, 4)).astype(np.float32)
                         * (rng.random((6, n, 4)) < 0.8))
    m = n // parts
    st_p = st_k = None
    for k in range(parts):
        xs = x[:, k * m:(k + 1) * m].contiguous()
        st_p = pairsum.pairsum_ref(xs, SMALL_SPEC, k * m, n, st_p)
        st_k = _run_emu(emu, xs, SMALL_SPEC, k * m, n, st_k)
        assert torch.equal(st_k.view(torch.int32), st_p.view(torch.int32))


@pytest.mark.parametrize("n", [128, 256])
def test_emulated_kernel_folded_matches_plain(emu, n):
    """The one-pair kinds of 128 and 256 points (FOLDED, FOLDED_TAIL: the
    whole axis in one call) beside the other kinds, in one launch."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(3, n, 5)).astype(np.float32)
                         * (rng.random((3, n, 5)) < 0.8))
    spec = [(FOLDED, 0, 1), (FOLDED_TAIL, 2, 3), (FOLDED_TAIL, 4, ONE),
            (WINDOW, 0, ONE), (BLOCKED, 1, 4), (CHAIN, 3, 2)]
    want = pairsum.pairsum_ref(x, spec)
    got = _run_emu(emu, x, spec, 0, n, None)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_emulated_fma_matches_plain(emu):
    """fma_chain_kernel against the plain chains (gnn._fma32), bit for
    bit, on broadcast and strided operands (none of them copied)."""
    for chains, shape, outs in chain_cases(np.random.default_rng(11)):
        shape = torch.Size(shape)
        want = [c.plain(shape) for c in chains]
        got = outs or [torch.empty(shape) for _ in chains]
        desc = pairsum.fma_desc(chains, shape, got)
        assert emu.fma_run(desc.ctypes.data, None) == 0
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_emulated_xla_math_matches_plain(emu):
    """xla_math_kernel's three operations (exp, arccos, and cos with sin
    in one pass) against the plain versions, bit for bit (a NaN equal to
    any NaN)."""
    from rescan_tpu_torch.ops import xla_math
    x = xla_math_args(np.random.default_rng(12))
    n = len(x)
    plain = {xla_math.EXP: xla_math.exp_ref(x),
             xla_math.ACOS: xla_math.acos_ref(x),
             xla_math.SINCOS: torch.cat([xla_math.cos_ref(x),
                                         xla_math.sin_ref(x)])}
    for op, want in plain.items():
        out = torch.empty(want.shape)
        assert emu.xla_math_run(op, x.data_ptr(), out.data_ptr(), n,
                                None) == 0
        assert lu6.same_bits(out, want), op


def test_emulated_score_terms_match_plain(emu):
    """score_terms_kernel against ops/score.py's per_point_ref, bit for
    bit (a NaN equal to any NaN), by float4 and, at an unaligned start,
    one point at a time."""
    from rescan_tpu_torch.ops import score
    d2, dot, found, mask = score_inputs(np.random.default_rng(13))
    want = score.per_point_ref(d2, dot, found, mask, 0.1)
    for s0 in (0, 1):
        a, b, f, m = (t.reshape(-1)[s0:].contiguous() if s0 == 0 else
                      t.reshape(-1)[s0:] for t in (d2, dot, found, mask))
        out = torch.empty(a.shape)
        assert emu.score_terms_run(
            a.data_ptr(), b.data_ptr(), f.data_ptr(), m.data_ptr(),
            out.data_ptr(), a.numel(), score._NORMAL_DIV,
            score._dist_div(0.1), score._ALPHA, score._ONE_MINUS_ALPHA,
            None) == 0
        assert lu6.same_bits(out, want.reshape(-1)[s0:])


@pytest.mark.parametrize("kind", ["spd", "icp", "general", "singular"])
def test_emulated_lu6_matches_plain(emu, kind):
    """lu6_kernel against the plain ``lu6.solve_ref`` on the systems of
    tests/test_torch_lu6.py: finite entries bit for bit, non-finite ones
    alike (a NaN's payload aside)."""
    c, b = lu6_systems(kind, seed=2)
    tc, tb = _t(c, b)
    want = lu6.solve_ref(tc, tb)
    out = torch.empty_like(tb)
    assert emu.lu6_run(tc.data_ptr(), tb.data_ptr(), out.data_ptr(),
                       len(out), None) == 0
    assert lu6.same_bits(out, want)


def _run_emu_tail(lib, s4, wsum, cnt, c1, T, err, active, it):
    out = (torch.empty_like(T), torch.empty_like(err),
           torch.empty_like(active))
    assert lib.icp_tail_run(
        s4.data_ptr(), s4.stride(0), wsum.data_ptr(), wsum.stride(0),
        cnt.data_ptr(), c1.data_ptr(), T.data_ptr(), err.data_ptr(),
        active.data_ptr(), *(o.data_ptr() for o in out), len(T),
        int(it > 5), *(float(np.float32(v)) for v in (
            ticp._DAMP, ticp._DAMP_ADD, ticp._MIN_WSUM, ticp._WSUM_FLOOR,
            1e-5)), None) == 0
    return out


@pytest.mark.parametrize("it", [5, 6])
@pytest.mark.parametrize("b", [1, 69, 256])
def test_emulated_icp_tail_matches_plain(emu, b, it):
    """icp_tail_kernel against ops/icp.py ``_icp_tail_ref`` bit for bit (a
    NaN equal to any NaN) on seeded states and the edge rows of
    ``icp_tail_inputs`` (singular and non-finite C, -0.0 entries, a NaN
    solution zeroed, no correspondences, inactive pairs, an error within
    the convergence delta, angles past sin and cos's fast reduction), at
    the last iteration before the convergence test and the first with
    it, with round 4's totals read in place from a wider row and the
    weight totals through a stride, as the step hands them over."""
    s4, wsum, cnt, c1, T, err, active = icp_tail_inputs(
        np.random.default_rng(b), b)
    wide = torch.cat([torch.zeros(b, 5), s4, wsum[:, None]], 1)
    s4_v, wsum_v = wide[:, 5:5 + s4.shape[1]], wide[:, -1]
    want = ticp._icp_tail_ref(s4, wsum, cnt, c1, T, err, active, it)
    got = _run_emu_tail(emu, s4_v, wsum_v, cnt, c1, T, err, active, it)
    assert ticp.same_tail(got, want)
    if b >= 14:
        # a non-finite damping: every entry NaN, the solution zeroed, the
        # update the identity
        assert torch.equal(want[0][1:3], T[1:3])
        assert not want[2][[7, 8, 9, 10]].any()
        assert bool(want[2][11]) == (it <= 5)
        x = torch.where(torch.isfinite(s4[:14, 36:39]), -s4[:14, 36:39]
                        / 0.01, 0.0)
        assert x[12].abs().max() > 1e19


@pytest.mark.parametrize("n", [128, 1024, 4096])
@pytest.mark.parametrize("b", [1, 8, 69])
def test_emulated_icp_head_matches_plain(emu, b, n):
    """icp_head_kernel's four forms against ops/icp.py ``_icp_head_ref``
    bit for bit (a NaN equal to any NaN) on ``icp_head_inputs``' operands
    and edge rows (idx -1, masked points, d2 of 0 and -0.0, pairs with
    no correspondence, inactive at 2e6, all masked, std 0, f32(1e-6) and
    just above, d2 at 2.5 std and either side, weight totals of 0, -0.0,
    below the floor, subnormal, below 1e-7 and NaN, cancelling and
    subnormal products, negative zeros), the raw counts equal."""
    _check_emu_head(emu, icp_head_inputs(np.random.default_rng(b * n), b, n))


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("b,n", HEAD_TILE_EDGES + [(8, 1024)])
def test_emulated_icp_head_tile_edges_match_plain(emu, b, n, shift):
    """icp_head_kernel where its 128-point tiles span pairs and the last
    one is part full (N not a multiple of 128: each thread forms its own
    pair's scalars), from 8 pairs on with ``icp_head_inputs``' edge rows
    (pairs with no correspondence, weight totals of NaN and subnormal),
    and (``shift``) with every operand one element off 16-byte alignment
    (copied to aligned storage by ``head_operands``), against
    ``_icp_head_ref`` bit for bit."""
    ops = icp_head_inputs(np.random.default_rng(b * n), b, n)
    if shift:
        ops = {form: tuple(shifted(v) if torch.is_tensor(v) else v
                           for v in args) for form, args in ops.items()}
    _check_emu_head(emu, ops)


def _check_emu_head(emu, ops):
    for form in ticp.HEAD_FORMS:
        want = ticp._icp_head_ref(form, *ops[form])
        _, got, cargs = ticp.head_operands(form, *ops[form])
        assert emu.icp_head_run(*cargs, None) == 0
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, form
            assert (lu6.same_bits(g, w) if g.is_floating_point()
                    else torch.equal(g, w)), form
