"""The CUDA kernel's own source (rescan_tpu_torch/ops/csrc/gnn.cu), built
with g++ against a host emulation of the warp intrinsics it uses
(tests/data/torch_port_emu_cuda.h: one block = 32 threads meeting at a
barrier for every ballot, shuffle and __syncwarp), held bit for bit to
the plain PyTorch version on the CPU. This checks the kernel's logic —
tile list, run pruning, the staging ring, 4 queries per thread, the
exact sequential update — where there is no card and no nvcc; timing,
occupancy and the real cp.async need the card (tests/test_torch_cuda.py).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rescan_tpu_torch.ops import gnn
from test_torch_cuda import EDGE_R, _fixture, edge_slab

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


def _emulated_source() -> str:
    """gnn.cu with the emulation header, cp.async as a copy, and the
    launch as a loop over blocks."""
    with open(gnn._SRC) as f:
        s = f.read()
    edits = [
        ("#include <cuda_runtime.h>", f'#include "{HEADER}"'),
        ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" '
         '::"r"(s), "l"(gmem));', "(void)s; memcpy(smem, gmem, 16);"),
        ('asm volatile("cp.async.commit_group;\\n" ::);', ""),
        ('asm volatile("cp.async.wait_group 1;\\n" ::);', ""),
        ("gnn_kernel<WANT_IDX, USE_ABS><<<grid, WARP, 0, stream>>>(",
         "emulate_launch(grid, [&]() { gnn_kernel<WANT_IDX, USE_ABS>("),
        ("center, r2, radj, slack, gate_thr, out_idx, out_d2, out_dot);",
         "center, r2, radj, slack, gate_thr, out_idx, out_d2, out_dot); "
         "});"),
    ]
    for a, b in edits:
        assert s.count(a) == 1, f"gnn.cu no longer has {a!r}"
        s = s.replace(a, b)
    assert "asm" not in s
    return s


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the emulated kernel"
    d = tmp_path_factory.mktemp("gnn_emu")
    src, out = d / "gnn_emu.cpp", d / "libgnn_emu.so"
    src.write_text(_emulated_source())
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-o", str(out),
                        str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return gnn.bind(ctypes.CDLL(str(out)))


def _run(lib, slab, q, qn, radius, gate, use_abs, want_idx):
    m = q.shape[0]
    idx = torch.empty(m, dtype=torch.int32) if want_idx else None
    d2, dot = torch.empty(m), torch.empty(m)
    assert lib.gnn_query(*gnn.query_args(slab, q, qn, radius, gate, use_abs,
                                         idx, d2, dot), None) == 0
    return idx, d2, dot


def _check(lib, slab, q, qn, radius, gate, use_abs):
    """K2 and K1 bit for bit against the plain version; returns the plain
    result and the pair counts of its pruning."""
    qt, qnt = torch.from_numpy(q), torch.from_numpy(qn)
    p = gnn.nearest_gated_ref(slab, qt, qnt, radius, gate, use_abs)
    k2 = _run(lib, slab, qt, qnt, radius, gate, use_abs, True)
    k1 = _run(lib, slab, qt, qnt, radius, gate, use_abs, False)
    for a, b in zip(k2, p):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(k1[1:], p[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return p, gnn.pair_counts(slab, qt, qnt, radius, gate, use_abs)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("use_abs,gate", [(False, 0.5), (True, -1.0)])
def test_emulated_kernel_edge_slab(emu, mixed, use_abs, gate):
    """Columns at r and just inside it on run boundaries; 133 queries
    (no multiple of 128), one block mixing real and far queries."""
    arrays, q, qn = edge_slab(mixed)
    slab = gnn.slab_from_numpy(*arrays, device="cpu")
    p, _ = _check(emu, slab, q, qn, EDGE_R, gate, use_abs)
    real = q[:, 0] == 0
    assert (p[0].numpy()[real] == arrays[2][95]).all()


@pytest.mark.parametrize("tile,radius,gate,use_abs", [
    (2048, 0.1, 0.819, False), (1024, 0.1, 0.5, False),
    (1024, 0.075, 0.5, True), (2048, 0.15, -1.0, True)])
def test_emulated_kernel_random(emu, tile, radius, gate, use_abs):
    """Duplicated points (ties), exact hits, both tile sizes and gate
    kinds; a ragged 1,000-query launch whose last block mixes real and
    far queries."""
    pts, nrm, q, qn = _fixture(7, 8000, 1000)
    q = np.concatenate([q[:-100][gnn.morton_order(q[:-100])], q[-100:]])
    slab = gnn.build_sorted_slab(pts, nrm, tile=tile, device="cpu")
    p, stats = _check(emu, slab, q, qn, radius, gate, use_abs)
    assert (p[0] >= 0).sum() > 100
    assert stats["in_radius"] < stats["run_pairs"] < stats["tile_pairs"]


def test_emulated_kernel_refills_the_tile_list(emu):
    """More near tiles than the kernel's shared-memory tile list holds
    (256): the prologue runs in rounds."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 2, (300_000, 3)).astype(np.float32)
    nrm = np.tile(np.float32([0, 1, 0]), (len(pts), 1))
    slab = gnn.build_sorted_slab(pts, nrm, tile=1024, device="cpu")
    assert slab.n_tiles > 256
    q = pts[::1000] + np.float32(0.001)
    q = q[gnn.morton_order(q)]
    p, _ = _check(emu, slab, q, nrm[:len(q)], 0.05, 0.5, False)
    assert (p[0] >= 0).all()


def test_emulated_kernel_far_from_the_slab_centre(emu):
    """A 60 m long scene: queries up to 30 m from the slab centre, where
    an f32 rounding of |q - p|^2 is far larger than at the origin."""
    rng = np.random.default_rng(4)
    n = 20000
    pts = np.c_[rng.uniform(0, 60, n), rng.uniform(0, 0.5, (n, 2))].astype(
        np.float32)
    pts[n // 2:n // 2 + 500] = pts[:500]
    nrm = np.tile(np.float32([0, 1, 0]), (n, 1))
    q = (pts[::20] + rng.normal(0, 0.03, (n // 20, 3))).astype(np.float32)
    q = q[gnn.morton_order(q)]
    slab = gnn.build_sorted_slab(pts, nrm, tile=1024, device="cpu")
    p, _ = _check(emu, slab, q, nrm[:len(q)], 0.1, 0.5, False)
    assert (p[0] >= 0).sum() > 0.9 * len(q)
