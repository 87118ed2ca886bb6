"""The LoD levels' card pass (rescan_tpu_torch/ops/levels.py with
ops/csrc/levels.cu) against the native greedy Poisson-disk pass
(native.poisson_subsample), index for index.

Here the kernels' own source is built with g++ against
tests/data/torch_port_emu_cuda.h (each launch as a block of fibers, as
tests/test_torch_hashgrid.py builds hashgrid.cu) and driven by the same
host loop as on the card (``levels.run``) on CPU tensors. Its rounds are
the card's: a round decides the same points however its threads
interleave.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rescan_tpu_torch import config
from rescan_tpu_torch.core import native, pointcloud
from rescan_tpu_torch.ops import levels

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_emu_cuda.h")
VOXELS = config.LEVEL_VOXEL_SIZES[1:]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulated_source() -> str:
    """levels.cu with the emulation header, and each launch as blocks of
    fibers (emulate_block_launch)."""
    with open(levels._SRC) as f:
        s = f.read()
    assert s.count("#include <cuda_runtime.h>") == 1
    s = s.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    s, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.+?), THREADS, 0, s>>>\((.*?)\);",
                   r"emulate_block_launch(\2, THREADS, [&]() { \1(\3); });",
                   s, flags=re.S)
    assert n == 7 and "<<<" not in s and "asm" not in s
    return s


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the emulated kernels"
    d = tmp_path_factory.mktemp("levels_emu")
    src, out = d / "levels_emu.cpp", d / "liblevels_emu.so"
    src.write_text(emulated_source())
    r = subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-o", str(out),
                        str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return levels.bind(ctypes.CDLL(str(out)))


def emulated(emu, pts, voxels=VOXELS):
    return levels.run(emu, pts, voxels, torch.device("cpu"), None)


def assert_native(got, pts, voxels):
    assert len(got) == len(voxels)
    for idx, v in zip(got, voxels):
        want = native.poisson_subsample(pts, v)
        assert idx.dtype == np.int32
        np.testing.assert_array_equal(idx, want, err_msg=f"voxel {v}")


def surfaces(rng, n: int, size: float = 1.0) -> np.ndarray:
    """``n`` points on five planes of a ``size`` box (a floor, walls and a
    tilted sheet), in random order, with a little noise off the planes."""
    u = rng.uniform(0, size, (n, 2))
    k = rng.integers(0, 5, n)
    z = np.zeros(n)
    p = np.where(k[:, None] == 0, np.c_[u, z],
                 np.where(k[:, None] == 1, np.c_[u[:, 0], z, u[:, 1]],
                          np.where(k[:, None] == 2, np.c_[z, u],
                                   np.where(k[:, None] == 3,
                                            np.c_[u, 0.3 * u[:, 0]],
                                            np.c_[u[:, 0], u[:, 1],
                                                  size - u[:, 1]]))))
    p += rng.normal(0, 0.002, p.shape)
    return p.astype(np.float32)


def cell_sorted(pts: np.ndarray, cell: float) -> np.ndarray:
    """The points in the order of their grid cell (y, z, then x rows),
    as a scanner's lines would give them."""
    c = np.floor((pts - pts.min(0)) / cell).astype(np.int64)
    key = (c[:, 1] * (c[:, 2].max() + 1) + c[:, 2]) * (c[:, 0].max() + 1) \
        + c[:, 0]
    return pts[np.argsort(key, kind="stable")]


def test_random_order_every_voxel_in_few_rounds(emu):
    pts = surfaces(np.random.default_rng(1), 20000, 0.5)
    got = emulated(emu, pts)
    assert_native(got, pts, VOXELS)
    assert all(1 <= r <= 10 for r in levels.ROUNDS), levels.ROUNDS


def test_cell_sorted_order_needs_many_rounds(emu):
    """A scanline-like order chains the decisions: along a 3 m strip in
    cell order each round decides little more than the next kept point,
    so a level takes many rounds, each over the points still undecided."""
    rng = np.random.default_rng(2)
    n = 6000
    strip = np.c_[rng.uniform(0, 3.0, n), rng.uniform(0, 0.06, n),
                  rng.normal(0, 0.002, n)].astype(np.float32)
    pts = cell_sorted(strip, 0.02)
    got = emulated(emu, pts)
    assert_native(got, pts, VOXELS)
    assert max(levels.ROUNDS) >= 50, levels.ROUNDS


@pytest.mark.parametrize("order", ["random", "cell_sorted"])
def test_lengths_read_once_a_batch_of_rounds(emu, monkeypatch, order):
    """The host queues ROUNDS_A_READ rounds between two reads of the
    worklists' lengths: besides the box and the indices, one read a batch,
    so a random-order cloud takes one and a chained one a read for every
    ROUNDS_A_READ rounds of its longest level."""
    rng = np.random.default_rng(3)
    if order == "random":
        pts = surfaces(rng, 5000, 0.5)
    else:
        pts = cell_sorted(np.c_[rng.uniform(0, 3.0, 6000),
                                rng.uniform(0, 0.06, 6000),
                                rng.normal(0, 0.002, 6000)]
                          .astype(np.float32), 0.02)
    reads = []
    real = levels.timing.to_host

    def to_host(t):
        reads.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(levels.timing, "to_host", to_host)
    assert_native(emulated(emu, pts), pts, VOXELS)
    batches = -(-max(levels.ROUNDS) // levels.ROUNDS_A_READ)
    assert len(reads) == 2 + batches, (reads, levels.ROUNDS)
    assert batches == 1 if order == "random" else batches >= 6


def test_duplicated_points(emu):
    rng = np.random.default_rng(3)
    base = surfaces(rng, 5000, 0.4)
    pts = np.concatenate([base, base[:2000], base[:500]])
    pts = pts[rng.permutation(len(pts))]
    assert_native(emulated(emu, pts), pts, VOXELS)


def test_pairs_at_exactly_r(emu):
    """A lattice of spacing 2^-4 m: axis neighbours lie at d2 == r^2
    exactly at voxel 2^-4 (not neighbours), and inside r at 2^-3; the
    jittered copy puts pairs just inside and just outside."""
    rng = np.random.default_rng(4)
    g = np.arange(12, dtype=np.float32) / 16
    lat = np.stack(np.meshgrid(g, g, g[:4], indexing="ij"), -1).reshape(-1, 3)
    nudge = np.float32(2.0 ** -20) * rng.integers(-1, 2, lat.shape)
    pts = np.concatenate([lat, (lat + np.float32(1 / 32)) + nudge])
    pts = pts[rng.permutation(len(pts))].astype(np.float32)
    voxels = (1 / 16, 1 / 8, 1 / 32, 3 / 32)
    assert_native(emulated(emu, pts, voxels), pts, voxels)
    d = pts[:, None, :] - pts[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    assert (d2 == np.float32(1 / 16) ** 2).sum() > 1000


@pytest.mark.parametrize("n", [0, 1])
def test_no_point_and_one_point(emu, n):
    pts = np.full((n, 3), 0.25, np.float32)
    got = emulated(emu, pts)
    assert [len(g) for g in got] == [n] * len(VOXELS)
    assert_native(got, pts, VOXELS)


def test_cloud_inside_one_cell(emu):
    """Every point in the grid's one cell (0.9 of a cell's side): a few
    are kept, those farther than r from every earlier kept one."""
    rng = np.random.default_rng(5)
    v = 0.04
    pts = rng.uniform(0, 0.9 * levels.CELL_MARGIN * v, (600, 3)).astype(
        np.float32)
    assert levels.grid_shape(pts.min(0), pts.max(0), v)[1] == (1, 1, 1)
    got = emulated(emu, pts, (v,))
    assert_native(got, pts, (v,))
    assert len(got[0]) > 1


def test_merged_shuffled_cloud(emu):
    """Two clouds concatenated and shuffled as ``merge_with`` does."""
    rng = np.random.default_rng(6)
    a = surfaces(rng, 9000, 0.6)
    b = surfaces(rng, 7000, 0.6) + np.float32(0.01)
    pts = np.concatenate([a, b])
    pts = pts[native.merge_shuffle(len(pts), config.MERGE_SHUFFLE_SEED)]
    assert_native(emulated(emu, pts), pts, VOXELS)


def test_grid_shape_bounds_the_cells():
    """The cell is CELL_MARGIN * voxel where the grid fits, and grows
    until it fits MAX_CELLS and MAX_AXIS."""
    lo = np.zeros(3, np.float32)
    inv, dims = levels.grid_shape(lo, np.float32([0.5, 0.5, 0.5]), 0.04)
    assert np.isclose(1 / inv, levels.CELL_MARGIN * 0.04)
    assert dims == (12, 12, 12)
    for hi in ([40.0, 40.0, 3.0], [3000.0, 0.1, 0.1]):
        inv, dims = levels.grid_shape(lo, np.float32(hi), 0.01)
        assert 1 / inv > levels.CELL_MARGIN * 0.01
        assert np.prod(dims) <= levels.MAX_CELLS
        assert max(dims) <= levels.MAX_AXIS


# ---------------------------------------------------------------------------
# PointCloud.compute_levels' dispatch
# ---------------------------------------------------------------------------

def _cloud(rng, n):
    pos = surfaces(rng, n, 0.5)
    return {"positions": pos,
            "normals": rng.normal(size=(n, 3)).astype(np.float32),
            "colors": rng.uniform(size=(n, 3)).astype(np.float32),
            "radii": rng.uniform(size=n).astype(np.float32),
            "qualities": np.ones(n, np.float32),
            "class_ids": rng.integers(0, 40, n).astype(np.int32),
            "instance_ids": rng.integers(0, 9, n).astype(np.int32)}


def test_host_path_takes_the_native_pass():
    """None and the CPU keep the native pass, level by level; the
    deferred levels still fill in on the background thread."""
    lvl0 = _cloud(np.random.default_rng(7), 3000)
    levels.reset_counts()
    pc = pointcloud.PointCloud.from_arrays(lvl0, defer_levels_from=3)
    pointcloud.PointCloud.from_arrays(lvl0, device="cpu")
    assert levels.PLAIN_CALLS["poisson_levels"] == 8
    assert levels.LAUNCHES["poisson_levels"] == 0
    for lvl in range(1, config.N_LEVELS):
        np.testing.assert_array_equal(
            pc.pos(lvl), lvl0["positions"][native.poisson_subsample(
                lvl0["positions"], config.LEVEL_VOXEL_SIZES[lvl])])


def test_card_path_builds_every_level_at_once(emu, monkeypatch):
    """A CUDA device sends the whole pyramid to ``levels.poisson_levels``
    (here the emulated kernels), even where ``defer_levels_from`` asks for
    a background build, and every field of every level equals the host
    path's; ``merge_with`` and ``copy`` carry the device on."""
    calls = []

    def card(points, voxels, device=None):
        if not levels.on_card(device):
            return [native.poisson_subsample(points, v) for v in voxels]
        calls.append(str(device))
        return emulated(emu, points, voxels)

    monkeypatch.setattr(levels, "poisson_levels", card)
    rng = np.random.default_rng(8)
    lvl0 = _cloud(rng, 4000)
    host = pointcloud.PointCloud.from_arrays(lvl0)
    pc = pointcloud.PointCloud.from_arrays(lvl0, defer_levels_from=3,
                                           device="cuda:0")
    assert calls == ["cuda:0"] and pc.levels.future is None
    for lvl in range(config.N_LEVELS):
        for k in pointcloud._FIELDS:
            np.testing.assert_array_equal(pc.levels[lvl][k],
                                          host.levels[lvl][k])
    other = pointcloud.PointCloud.from_arrays(_cloud(rng, 2500))
    merged = pc.merge_with(other, device="cuda:0")
    want = pc.merge_with(other)
    pc.copy(device="cuda:0")
    assert calls == ["cuda:0"] * 3
    for lvl in range(config.N_LEVELS):
        for k in pointcloud._FIELDS:
            np.testing.assert_array_equal(merged.levels[lvl][k],
                                          want.levels[lvl][k])
