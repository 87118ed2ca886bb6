"""The port's hash-grid engine (rescan_tpu_torch/ops/hashgrid.py) against
the JAX package's (rescan_tpu/ops/hashgrid.py, JAX on the CPU), and the
CUDA kernels' own source (ops/csrc/hashgrid.cu) built with g++ against
tests/data/torch_port_emu_cuda.h, all bit for bit on the same numpy
inputs.

How the arithmetic was read: the JAX functions' d2 and gate dot were
held against every fused-multiply-add order of the three terms on
random queries (JAX_PLATFORMS=cpu, jaxlib 0.9.0): only
fma(dz, dz, fma(dy, dy, dx * dx)) and fma(nz, qz, fma(ny, qy, nx * qx))
reproduce them. These cases hold that on ties, duplicates, truncated
windows and queries outside the grid.
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_tpu.ops import hashgrid as jhashgrid
from rescan_tpu.ops import search as jsearch
from rescan_tpu_torch.ops import gnn, hashgrid, search

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


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def make_case(name: str):
    """(points, normals, queries, query normals, radius, cap) of one
    fixture, from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cap = None
    radius = 0.1
    if name == "random":
        pts = rng.uniform(0, 1.5, (5000, 3)).astype(np.float32)
        q = rng.uniform(0, 1.5, (700, 3)).astype(np.float32)
        q[:100] = pts[:100]                       # exact hits
    elif name == "lattice":
        # spacing 1/16: every distance is exact, so neighbours tie by
        # the dozen (6 at 1, 12 at sqrt 2, 8 at sqrt 3 spacings)
        g = np.arange(10, dtype=np.float32) / 16
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        pts = pts[rng.permutation(len(pts))]
        q = np.concatenate([pts[:200], pts[200:400] + np.float32(1 / 32)])
        radius = 0.125                           # the 2-spacing shell at r
    elif name == "duplicates":
        base = rng.uniform(0, 0.6, (600, 3)).astype(np.float32)
        pts = np.concatenate([base, base[:300], base[:100]])
        pts = pts[rng.permutation(len(pts))]
        q = np.concatenate([base[:150], base[300:450] + np.float32(0.01)])
    elif name == "outside":
        pts = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
        q = rng.uniform(-0.3, 1.3, (400, 3)).astype(np.float32)
        q[:8] = [[gnn.FAR] * 3, [-gnn.FAR] * 3, [1e12, 0.5, 0.5],
                 [0.5, -1e12, 0.5], [0.5, 0.5, 3e9], [-0.05, 0.5, 0.5],
                 [1.02, 1.02, 1.02], [0.5, -0.09, 1.09]]
        q[-64:] = gnn.FAR                        # a padded tail
    elif name == "small_cap":
        pts = rng.uniform(0, 0.5, (4000, 3)).astype(np.float32)
        q = rng.uniform(0, 0.5, (300, 3)).astype(np.float32)
        cap = 3                                   # runs cut at 9 points
    elif name == "none_found":
        pts = rng.uniform(0, 1, (500, 3)).astype(np.float32)
        q = rng.uniform(0, 1, (130, 3)).astype(np.float32) + np.float32(3)
        radius = 0.01
    else:
        raise KeyError(name)
    return pts, _unit(rng, len(pts)), q, _unit(rng, len(q)), radius, cap


CASES = ("random", "lattice", "duplicates", "outside", "small_cap",
         "none_found")
GATES = [(False, 0.5), (True, -1.0), (False, float(np.cos(np.deg2rad(60))))]


def _bits(t):
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(got, want, what=""):
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = w.numpy() if torch.is_tensor(w) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} output {k}")


def _grids(case):
    pts, nrm, q, qn, radius, cap = make_case(case)
    jg = jhashgrid.build_grid(pts, radius, normals=nrm, cap=cap)
    tg = hashgrid.build_grid(pts, radius, normals=nrm, cap=cap, device="cpu")
    return jg, tg, q, qn, radius


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("case", CASES)
def test_radius_knn_matches_jax(case, k):
    jg, tg, q, _, radius = _grids(case)
    want = jhashgrid.radius_knn(jg, jnp.asarray(q), radius, k)
    got = hashgrid.radius_knn(tg, torch.from_numpy(q), radius, k, chunk=256)
    assert_same(got, want, f"{case} k={k}")
    if case == "none_found":
        assert (got[2] == 0).all()
    else:
        assert (got[2] > 0).any()


@pytest.mark.parametrize("use_abs,gate", GATES)
@pytest.mark.parametrize("case", CASES)
def test_nearest_gated_matches_jax(case, use_abs, gate):
    jg, tg, q, qn, radius = _grids(case)
    want = jhashgrid.nearest_gated(jg, jnp.asarray(q), jnp.asarray(qn),
                                   radius, gate, use_abs_dot=use_abs)
    got = hashgrid.nearest_gated(tg, torch.from_numpy(q),
                                 torch.from_numpy(qn), radius, gate,
                                 use_abs_dot=use_abs, chunk=256)
    assert_same(got, want, case)


def test_lattice_ties_keep_window_order():
    """Among equal d2, radius_knn keeps the lower window position first
    (lax.top_k), which is not the (d2, index) order of the native
    HostGrid: the lattice's tied shells show both."""
    _, tg, q, _, radius = _grids("lattice")
    idx, d2, _ = hashgrid.radius_knn(tg, torch.from_numpy(q), radius, 16)
    same = (d2[:, 1:] == d2[:, :-1]) & (idx[:, 1:] >= 0)
    assert same.sum() > 1000
    assert (idx[:, 1:][same] < idx[:, :-1][same]).any()


# ---------------------------------------------------------------------------
# the kernels' own source, emulated
# ---------------------------------------------------------------------------

def emulated_source() -> str:
    """hashgrid.cu with the emulation header, and each launch as blocks
    of fibers (emulate_block_launch)."""
    with open(hashgrid._SRC) as f:
        s = f.read()
    assert s.count("#include <cuda_runtime.h>") == 1
    s = s.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    s, n = re.subn(r"(\w+<\w+>)<<<blocks_for\(m\), THREADS, 0, s>>>\((.*?)\);",
                   r"emulate_block_launch(blocks_for(m), THREADS, [&]() "
                   r"{ \1(\2); });", s, flags=re.S)
    assert n == 6 and "<<<" not in s and "asm" not in s
    return s


def build_emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the emulated kernels"
    d = tmp_path_factory.mktemp("hashgrid_emu")
    src, out = d / "hashgrid_emu.cpp", d / "libhashgrid_emu.so"
    src.write_text(emulated_source())
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-o", str(out),
                        str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return hashgrid.bind(ctypes.CDLL(str(out)))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build_emulated(tmp_path_factory)


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("case", CASES)
def test_emulated_radius_knn_matches_plain(emu, case, k):
    _, tg, q, _, radius = _grids(case)
    qt = torch.from_numpy(q)
    want = hashgrid.radius_knn_ref(tg, qt, radius, k)
    m = len(q)
    got = (torch.empty((m, k), dtype=torch.int32), torch.empty((m, k)),
           torch.empty(m, dtype=torch.int32))
    assert emu.grid_radius_knn(*hashgrid.radius_knn_args(
        tg, qt, radius, k, *got), None) == 0
    assert_same(got, want, case)


@pytest.mark.parametrize("use_abs,gate", GATES[:2])
@pytest.mark.parametrize("case", CASES)
def test_emulated_nearest_gated_matches_plain(emu, case, use_abs, gate):
    _, tg, q, qn, radius = _grids(case)
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    want = hashgrid.nearest_gated_ref(tg, qt, qnt, radius, gate, use_abs)
    m = len(q)
    got = (torch.empty(m, dtype=torch.int32), torch.empty(m), torch.empty(m))
    assert emu.grid_nearest_gated(*hashgrid.nearest_gated_args(
        tg, qt, qnt, radius, gate, use_abs, *got), None) == 0
    assert_same(got, want, case)


# ---------------------------------------------------------------------------
# search.py's dispatch on a HashGrid
# ---------------------------------------------------------------------------

def test_search_dispatch_on_the_grid():
    """build_index(prefer_dense=False) gives the grid; nearest_gated,
    gated_min and index_arrays equal the JAX package's search functions
    on its HashGrid, and None keeps the slab."""
    pts, nrm, q, qn, radius, _ = make_case("random")
    ji = jsearch.build_index(pts, radius, normals=nrm, prefer_dense=False)
    ti = search.build_index(pts, radius, normals=nrm, prefer_dense=False,
                            device="cpu")
    assert isinstance(ti, hashgrid.HashGrid)
    assert isinstance(search.build_index(pts, radius, normals=nrm,
                                         device="cpu"), gnn.SortedSlab)
    jq, jqn = jnp.asarray(q), jnp.asarray(qn)
    tq, tqn = torch.from_numpy(q), torch.from_numpy(qn)
    assert_same(search.nearest_gated(ti, tq, tqn, radius, 0.5),
                jsearch.nearest_gated(ji, jq, jqn, radius, 0.5), "nearest")
    assert_same(search.gated_min(ti, tq, tqn, radius, 0.5, use_abs_dot=True),
                jsearch.gated_min(ji, jq, jqn, radius, 0.5, use_abs_dot=True),
                "gated_min")
    assert_same(search.index_arrays(ti), jsearch.index_arrays(ji),
                "index_arrays")


def test_grid_plain_calls_are_counted():
    """CPU tensors take the plain versions and count them; their pair
    counts are the windows' entries (what the kernels evaluate) and
    those within r."""
    pts, nrm, q, qn, radius, _ = make_case("duplicates")
    tg = hashgrid.build_grid(pts, radius, normals=nrm, device="cpu")
    hashgrid.reset_counts()
    hashgrid.radius_knn(tg, torch.from_numpy(q), radius, 8)
    hashgrid.nearest_gated(tg, torch.from_numpy(q), torch.from_numpy(qn),
                           radius, 0.5)
    assert hashgrid.PLAIN_CALLS == {"grid_radius_knn": 1,
                                    "grid_nearest_gated": 1}
    assert hashgrid.LAUNCHES == {"grid_radius_knn": 0,
                                 "grid_nearest_gated": 0}
    stats = {}
    _, _, cnt = hashgrid.radius_knn_ref(tg, torch.from_numpy(q), radius, 16,
                                        stats=stats)
    assert int(cnt.sum()) <= stats["in_radius"] < stats["pairs"]
