"""The LoD levels' greedy Poisson-disk passes on the card.

``poisson_levels(points, voxels, device)`` gives, for each voxel, the
ascending int32 indices that ``native.poisson_subsample(points, voxel)``
gives: the greedy pass over level 0 in index order that keeps a point iff
no point kept before it lies within the voxel (d2 < r^2, d2 =
(dx * dx + dy * dy) + dz * dz and r^2 = f32(voxel)^2, each rounded in f32).
Dispatch follows the device the call carries: a CUDA device runs every
level at once in the hand-written kernels of ``csrc/levels.cu`` (built with
nvcc at first use into ``rescan_tpu_torch/_build/``, bound with ctypes);
None or the CPU takes the native pass, level by level, which stays the plain
version.

On the card a call uploads level 0's positions once, reads back their
bounding box, builds each level's grid by a counting sort, then runs rounds
over the undecided points until every level is decided (``csrc/levels.cu``
says how a round decides exactly the greedy pass's points): the host queues
ROUNDS_A_READ rounds at a time and reads the worklists' lengths once after
them (the scans' random order takes 5 to 7 rounds: one read). The kept
indices of all levels come back in one copy.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Sequence

import numpy as np
import torch

from ..core import native
from ..utils import timing
from . import gnn

# Card calls (each builds every level of one pyramid) and native passes
# (one a level), as hashgrid.LAUNCHES / PLAIN_CALLS; ROUNDS: the rounds of
# the last card call, per level.
LAUNCHES = {"poisson_levels": 0}
PLAIN_CALLS = {"poisson_levels": 0}
ROUNDS: List[int] = []
_count_lock = threading.Lock()

# A grid cell's side over r: the margin keeps float rounding in a cell
# index from putting two neighbours two cells apart (csrc/levels.cu); the
# side grows past it where the grid would exceed MAX_CELLS cells, or
# MAX_AXIS along an axis (which bounds that rounding).
CELL_MARGIN = 1.0625
MAX_CELLS = 1 << 22
MAX_AXIS = 1 << 16
MAX_LEVELS = 4  # csrc/levels.cu's
TILE = 1024     # csrc/levels.cu's elements a block in its scans
# rounds queued between two reads of the worklists' lengths
ROUNDS_A_READ = 8


def reset_counts() -> None:
    with _count_lock:
        for d in (LAUNCHES, PLAIN_CALLS):
            for k in d:
                d[k] = 0
        ROUNDS.clear()


def _count(counts: dict) -> None:
    with _count_lock:
        counts["poisson_levels"] += 1


def poisson_subsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """The native pass at one voxel, the plain version (counted in
    PLAIN_CALLS)."""
    _count(PLAIN_CALLS)
    return native.poisson_subsample(points, voxel)


def on_card(device) -> bool:
    """True where ``device`` names a CUDA device; False for None or the
    CPU; anything else raises."""
    if device is None:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"levels: unsupported device {dev}")


def poisson_levels(points: np.ndarray, voxels: Sequence[float],
                   device=None) -> List[np.ndarray]:
    """The greedy Poisson-disk subsample of ``points`` (N, 3) at each of
    ``voxels``: a list of ascending int32 index arrays."""
    if not on_card(device):
        return [poisson_subsample(points, v) for v in voxels]
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lib = load_library()
    with torch.cuda.device(dev):
        out = run(lib, points, voxels, dev,
                  torch.cuda.current_stream(dev).cuda_stream)
    _count(LAUNCHES)
    return out


# ---------------------------------------------------------------------------
# The host side of the card's pass
# ---------------------------------------------------------------------------

class Level(ctypes.Structure):
    """csrc/levels.cu's ``PoissonLevel``."""
    _fields_ = [("ox", ctypes.c_float), ("oy", ctypes.c_float),
                ("oz", ctypes.c_float), ("inv", ctypes.c_float),
                ("nx", ctypes.c_int), ("ny", ctypes.c_int),
                ("nz", ctypes.c_int), ("r2", ctypes.c_float),
                ("ncells", ctypes.c_int), ("pad", ctypes.c_int),
                *((f, ctypes.c_void_p) for f in (
                    "cell_start", "cell", "rank", "slot", "sorted", "state",
                    "work", "next", "tile_sum", "out"))]


def grid_shape(lo: np.ndarray, hi: np.ndarray, voxel: float):
    """(f32(1 / cell), (nx, ny, nz)) of a level's grid over the box
    [lo, hi]: cell = CELL_MARGIN * voxel, grown by a quarter at a time
    while the grid is too large."""
    ext = (np.asarray(hi, np.float32) - np.asarray(lo, np.float32))
    cell = CELL_MARGIN * float(voxel)
    while True:
        inv = np.float32(1.0 / cell)
        dims = tuple(int(np.floor(ext[k] * inv)) + 1 for k in range(3))
        if max(dims) <= MAX_AXIS and dims[0] * dims[1] * dims[2] <= MAX_CELLS:
            return inv, dims
        cell *= 1.25


def _buffers(n: int, lo, hi, voxel: float, dev) -> tuple:
    """A level's descriptor and the tensors it points into."""
    inv, (nx, ny, nz) = grid_shape(lo, hi, voxel)
    ncells = nx * ny * nz
    v = np.float32(voxel)
    i32 = dict(dtype=torch.int32, device=dev)
    t = {"cell_start": torch.zeros(ncells + 1, **i32),
         "sorted": torch.empty((n, 4), dtype=torch.float32, device=dev),
         "tile_sum": torch.empty(-(-max(n, ncells + 1) // TILE), **i32),
         **{k: torch.empty(n, **i32) for k in
            ("cell", "rank", "slot", "state", "work", "next")}}
    lv = Level(float(lo[0]), float(lo[1]), float(lo[2]), float(inv), nx, ny,
               nz, float(v * v), ncells, 0,
               **{k: x.data_ptr() for k, x in t.items()})
    return lv, t


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"levels: {what} failed, cudaError {rc}")


def run(lib, points: np.ndarray, voxels: Sequence[float], dev,
        stream) -> List[np.ndarray]:
    """Every level of one pyramid with ``lib``'s kernels on ``dev`` (the
    card, or the CPU for the emulated build): the kept indices a voxel."""
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    n, nlev = len(pts), len(voxels)
    if not 1 <= nlev <= MAX_LEVELS:
        raise ValueError(f"levels: 1 to {MAX_LEVELS} voxels, not {nlev}")
    ROUNDS[:] = [0] * nlev
    if n == 0:
        return [np.zeros(0, np.int32) for _ in voxels]
    if n >= 1 << 31:
        raise ValueError(f"levels: {n} points exceed int32 indices")
    p = timing.to_device(torch.from_numpy(pts), dev)
    # the box on the card: numpy's min over the rows of an (N, 3) array
    # walks them one at a time (~80 ms for a scan)
    lo, hi = timing.to_host(torch.stack(torch.aminmax(p, dim=0)))
    made = [_buffers(n, lo, hi, v, dev) for v in voxels]
    lv = (Level * nlev)(*(m[0] for m in made))
    _check(lib.poisson_grid(lv, nlev, p.data_ptr(), n, stream), "grid")
    # the kept counts, then a row of worklist lengths before each queued
    # round and after the last
    R = ROUNDS_A_READ
    counts = torch.zeros((R + 2, MAX_LEVELS), dtype=torch.int32, device=dev)
    counts[1, :nlev] = n
    m = [n] * nlev
    while any(m):
        _check(lib.poisson_rounds(lv, nlev, (ctypes.c_int * nlev)(*m), R,
                                  counts[1].data_ptr(),
                                  counts[0].data_ptr(), stream), "rounds")
        c = timing.to_host(counts)
        lens = c[1:, :nlev]
        for k in range(nlev):
            ran = lens[:R, k] > 0
            ROUNDS[k] += int(ran.sum())
            if (lens[1:, k][ran] >= lens[:R, k][ran]).any():
                # every round decides a level's lowest undecided point
                raise RuntimeError(f"levels: a round decided nothing "
                                   f"{lens[:, k].tolist()}")
        m = [int(x) for x in lens[R]]
        if R % 2:
            for k in range(nlev):
                lv[k].work, lv[k].next = lv[k].next, lv[k].work
        counts[1].copy_(counts[R + 1])
    kept = [int(x) for x in c[0, :nlev]]
    ends = np.cumsum(kept)
    out = torch.empty(max(int(ends[-1]), 1), dtype=torch.int32, device=dev)
    for k in range(nlev):
        lv[k].out = out.data_ptr() + 4 * int(ends[k] - kept[k])
    _check(lib.poisson_output(lv, nlev, n, stream), "output")
    idx = timing.to_host(out)
    return [idx[e - k:e].copy() for e, k in zip(ends, kept)]


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "levels.cu")
_lib = None
_lib_lock = threading.Lock()
# ptxas's -v report of the library in use (kept beside it as
# ``liblevels-<hash>.so.ptxas.txt``)
BUILD_LOG = ""


def load_library():
    """Build ``csrc/levels.cu`` (``gnn.build_library``) and load it."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is None:
            lib, BUILD_LOG = gnn.build_library("levels", [_SRC])
            _lib = bind(lib)
        return _lib


def bind(lib):
    """Declare the C signatures of the library's entry points."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lv = ctypes.POINTER(Level)
    lib.poisson_grid.argtypes = [lv, i32, vp, i32, vp]
    lib.poisson_rounds.argtypes = [lv, i32, ctypes.POINTER(i32), i32, vp, vp,
                                   vp]
    lib.poisson_output.argtypes = [lv, i32, i32, vp]
    for f in (lib.poisson_grid, lib.poisson_rounds, lib.poisson_output,
              lib.poisson_max_levels):
        f.restype = ctypes.c_int
    if lib.poisson_max_levels() != MAX_LEVELS:
        raise RuntimeError("levels: the library's MAX_LEVELS differs")
    return lib
