"""Windowed neighbour search over a uniform hash grid — the port of
rescan_tpu/ops/hashgrid.py.

Points are bucketed into cells of side ``cell`` (the query radius) and
sorted by cell id ``(cy * nz + cz) * nx + cx``, so the 3 x-adjacent cells
of a query are one contiguous range of the sorted points. A query's
candidate window is the 9 such runs of its 3 x 3 (y, z) neighbourhood,
each cut to L = 3 * cap points (``cap``: the largest cell count unless
the caller passes a smaller one). Two queries:

* ``radius_knn`` — the K nearest points with strict d2 < r^2, ascending;
  among equal d2 the lower window position first (``lax.top_k``'s
  order). The smoothing graph's search (ops/labels.py).
* ``nearest_gated`` — the nearest point with d2 < r^2 whose normal
  passes the gate (max(dot, 0) or |dot| at least cos_gate - 1e-6); the
  first minimum in window order (``jnp.argmin``).

Indices are the points' original order, -1 where nothing qualifies.
Both are bit-identical to the JAX functions as XLA:CPU compiles them:
d = p - q, d2 = fma(dz, dz, fma(dy, dy, dx * dx)) and the normal dot
fma(nz, qz, fma(ny, qy, nx * qx)), read by probes (the test file says
how); r^2 and the gate threshold are formed in f32 (``gnn.gate_params``),
and the cell index is floor((q - origin) * f32(1 / cell)) converted to
int32 with saturation, NaN to 0, as XLA converts.

Dispatch is on the queries' device: CUDA tensors launch the hand-written
kernels in ``csrc/hashgrid.cu`` (built with nvcc at first use into
``rescan_tpu_torch/_build/``, bound with ctypes), CPU tensors take the
plain PyTorch versions ``radius_knn_ref`` and ``nearest_gated_ref``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils import timing
from . import gnn

# Kernel launches per wrapper, and calls of the plain versions (as
# gnn.LAUNCHES / gnn.PLAIN_CALLS).
LAUNCHES = {"grid_radius_knn": 0, "grid_nearest_gated": 0}
PLAIN_CALLS = {"grid_radius_knn": 0, "grid_nearest_gated": 0}
_count_lock = threading.Lock()
# the K of radius_knn's kernel instantiations (csrc/hashgrid.cu)
KERNEL_K = (8, 16)


def reset_counts() -> None:
    with _count_lock:
        for d in (LAUNCHES, PLAIN_CALLS):
            for k in d:
                d[k] = 0


def _count(counts: dict, name: str) -> None:
    with _count_lock:
        counts[name] += 1


@dataclasses.dataclass
class HashGrid:
    """A grid on one device: the points sorted by cell id, their
    normals (zeros if absent), the sort permutation and the cells' prefix
    offsets; ``cell``, ``dims`` and ``cap`` as the JAX HashGrid's, and
    ``origin_host``, the origin as floats, for the kernel's arguments."""
    points: torch.Tensor       # (N, 3) f32 sorted by cell id
    normals: torch.Tensor      # (N, 3) f32 in the same order
    perm: torch.Tensor         # (N,) int32 original index of each point
    cell_start: torch.Tensor   # (n_cells + 1,) int32 prefix offsets
    origin: torch.Tensor       # (3,) f32
    cell: float
    dims: Tuple[int, int, int]
    cap: int
    origin_host: Tuple[float, float, float]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def to(self, device) -> "HashGrid":
        """This grid with its tensors on ``device``."""
        if self.device == torch.device(device):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in
                     ("points", "normals", "perm", "cell_start", "origin")})


def build_grid(points: np.ndarray, cell: float,
               normals: Optional[np.ndarray] = None,
               cap: Optional[int] = None, device=None) -> HashGrid:
    """Bucket, sort and prefix-sum on the host (hashgrid.py:64-98), then
    place the grid on ``device`` (cuda unless the CPU is named)."""
    dev = resolve_device(device)
    pts = np.asarray(points, dtype=np.float32)
    n = len(pts)
    mn = pts.min(axis=0) if n else np.zeros(3, np.float32)
    mx = pts.max(axis=0) if n else np.zeros(3, np.float32)
    inv = 1.0 / cell
    dims = tuple(int(np.floor((mx[k] - mn[k]) * inv)) + 1 for k in range(3))
    cx = np.clip(((pts[:, 0] - mn[0]) * inv).astype(np.int64), 0, dims[0] - 1)
    cy = np.clip(((pts[:, 1] - mn[1]) * inv).astype(np.int64), 0, dims[1] - 1)
    cz = np.clip(((pts[:, 2] - mn[2]) * inv).astype(np.int64), 0, dims[2] - 1)
    cid = (cy * dims[2] + cz) * dims[0] + cx
    order = np.argsort(cid, kind="stable").astype(np.int32)
    cid_sorted = cid[order]
    n_cells = dims[0] * dims[1] * dims[2]
    counts = np.bincount(cid_sorted, minlength=n_cells)
    cell_start = np.zeros(n_cells + 1, dtype=np.int32)
    np.cumsum(counts, out=cell_start[1:])
    real_cap = int(counts.max()) if n else 1
    if cap is None:
        cap = max(real_cap, 1)
    nrm = (np.zeros_like(pts) if normals is None
           else np.asarray(normals, dtype=np.float32))
    mn = np.asarray(mn, np.float32)
    return HashGrid(
        points=timing.to_device(
            torch.from_numpy(np.ascontiguousarray(pts[order])), dev),
        normals=timing.to_device(
            torch.from_numpy(np.ascontiguousarray(nrm[order])), dev),
        perm=timing.to_device(torch.from_numpy(order), dev),
        cell_start=timing.to_device(torch.from_numpy(cell_start), dev),
        origin=timing.to_device(torch.from_numpy(mn.copy()), dev),
        cell=float(cell), dims=dims, cap=int(cap),
        origin_host=tuple(float(v) for v in mn))


def index_arrays(grid: HashGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points, normals) in original order: the inverse-``perm`` gather
    (search.py:122-124). An empty grid gives one zero row, so that a
    gather at index 0 stays valid, as the slab's ``index_arrays`` does."""
    n = grid.points.shape[0]
    rows = grid.perm.long()
    out_p = grid.points.new_zeros(max(n, 1), 3)
    out_n = grid.normals.new_zeros(max(n, 1), 3)
    out_p[rows] = grid.points
    out_n[rows] = grid.normals
    return out_p, out_n


# ---------------------------------------------------------------------------
# The plain PyTorch versions
# ---------------------------------------------------------------------------

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _cells(grid: HashGrid, q: torch.Tensor) -> torch.Tensor:
    """(M, 3) int64 cell coordinates: floor((q - origin) * f32(1 / cell))
    in f32, converted as XLA converts f32 to int32 (saturating, NaN to
    0), which torch's own conversion leaves undefined out of range."""
    inv = torch.tensor(np.float32(1.0 / grid.cell), device=q.device)
    c = torch.floor((q - grid.origin[None, :]) * inv).double()
    c = torch.where(torch.isnan(c), 0.0, c.clamp(_I32_MIN, _I32_MAX))
    return c.long()


def _ranges(grid: HashGrid, q: torch.Tensor):
    """(starts, lens) of each query's 9 runs, (M, 9) int64, the lengths
    cut to L = 3 * cap (_candidate_ranges, _candidate_window)."""
    nx, ny, nz = grid.dims
    c = _cells(grid, q)
    cx = c[:, 0].clamp(0, nx - 1)
    cy, cz = c[:, 1], c[:, 2]
    x_lo = (cx - 1).clamp(min=0)
    x_hi = (cx + 1).clamp(max=nx - 1)
    cs = grid.cell_start.long()
    starts, lens = [], []
    for dy in (-1, 0, 1):
        yy = cy + dy
        y_ok = (yy >= 0) & (yy < ny)
        yy = yy.clamp(0, ny - 1)
        for dz in (-1, 0, 1):
            zz = cz + dz
            ok = y_ok & (zz >= 0) & (zz < nz)
            zz = zz.clamp(0, nz - 1)
            row = (yy * nz + zz) * nx
            s = cs[row + x_lo]
            e = cs[row + x_hi + 1]
            starts.append(torch.where(ok, s, 0))
            lens.append(torch.where(ok, e - s, 0))
    lens = torch.stack(lens, 1).clamp(max=3 * grid.cap)
    return torch.stack(starts, 1), lens


def _window(grid: HashGrid, q: torch.Tensor):
    """Every valid entry of the queries' windows: (query row, sorted
    point) as int64 vectors, in window order per query. The JAX functions
    gather the window as a dense (M, 9 * L) block whose invalid entries
    never qualify; these are its valid entries. Along a window the sorted
    index only grows (its runs lie on ascending rows of the cell order),
    so ordering by window position is ordering by sorted index."""
    m = q.shape[0]
    starts, lens = _ranges(grid, q)
    n = lens.reshape(-1)
    run = torch.repeat_interleave(torch.arange(m * 9, device=q.device), n)
    first = torch.cumsum(n, 0) - n
    off = torch.arange(run.shape[0], device=q.device) - first[run]
    return run // 9, starts.reshape(-1)[run] + off


def _d2_exact(px, py, pz, qx, qy, qz):
    """XLA:CPU's jnp.sum(d * d, axis=-1) of d = p - q."""
    dx, dy, dz = px - qx, py - qy, pz - qz
    return gnn._fma32(dz, dz, gnn._fma32(dy, dy, dx * dx))


def _gate_exact(nx, ny, nz, qx, qy, qz, use_abs_dot: bool):
    """XLA:CPU's jnp.sum(nrm * qn, axis=-1), then |dot| or max(dot, 0)."""
    nd = gnn._fma32(nz, qz, gnn._fma32(ny, qy, nx * qx))
    return nd.abs() if use_abs_dot else torch.where(nd > 0, nd, 0.0)


def _within(grid: HashGrid, q: torch.Tensor, r2: float,
            stats: Optional[dict]):
    """The window entries with d2 < r^2: (query row, sorted point, exact
    d2, and the key (d2 bits, sorted point) that orders a query's entries
    as its window does; d2 >= 0, so its bits order as its values). A
    plain f32 distance screens the window first, loosely enough (1e-4
    relative) that no entry the exact d2 keeps is dropped. ``stats``
    gains the window's entries (``pairs``, what the kernels evaluate) and
    those within r (``in_radius``)."""
    qi, j = _window(grid, q)
    p = grid.points
    d = p[j] - q[qi]
    near = ((d * d).sum(1) <= r2 * 1.0001).nonzero()[:, 0]
    qi, j = qi[near], j[near]
    d2 = _d2_exact(p[j, 0], p[j, 1], p[j, 2], q[qi, 0], q[qi, 1], q[qi, 2])
    inr = d2 < r2
    qi, j, d2 = qi[inr], j[inr], d2[inr]
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + int(d.shape[0])
        stats["in_radius"] = stats.get("in_radius", 0) + int(qi.numel())
    return qi, j, d2, (d2.view(torch.int32).long() << 32) | j


def _step(dev: torch.device, chunk: int) -> int:
    """Queries per round of a plain version: ``chunk`` on the CPU, more
    on a card."""
    return chunk if dev.type == "cpu" else max(chunk, 65536)


def radius_knn_ref(grid: HashGrid, q: torch.Tensor, radius, k: int,
                   chunk: int = 4096, stats: Optional[dict] = None):
    """Plain PyTorch ``radius_knn``: (idx (M, k) int32 or -1, d2 (M, k)
    f32 or +inf, count (M,) int32). ``stats``: a dict that receives this
    call's window entries (``pairs``, the pairs the kernel evaluates)
    and the entries with d2 < r^2 (``in_radius``)."""
    _count(PLAIN_CALLS, "grid_radius_knn")
    r2 = float(gnn.gate_params(radius, 0.0)[0])
    dev = q.device
    m = q.shape[0]
    idx = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    d2o = torch.full((m, k), torch.inf, dtype=torch.float32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    if stats is not None:
        stats.update(pairs=0, in_radius=0)
    step = _step(dev, chunk)
    for s0 in range(0, m, step):
        qc = q[s0:s0 + step]
        qi, j, d2, key = _within(grid, qc, r2, stats)
        # each query's entries in ascending (d2, window position)
        o = torch.argsort(key, stable=True)
        o = o[torch.argsort(qi[o], stable=True)]
        qi, j, d2 = qi[o], j[o], d2[o]
        per_q = torch.bincount(qi, minlength=qc.shape[0])
        rank = torch.arange(qi.numel(), device=dev) - (
            torch.cumsum(per_q, 0) - per_q)[qi]
        keep = rank < k
        rows = qi[keep] + s0
        idx[rows, rank[keep]] = grid.perm[j[keep]]
        d2o[rows, rank[keep]] = d2[keep]
        cnt[s0:s0 + qc.shape[0]] = per_q.clamp(max=k).to(torch.int32)
    return idx, d2o, cnt


def nearest_gated_ref(grid: HashGrid, q_pos: torch.Tensor,
                      q_nrm: torch.Tensor, radius, cos_gate,
                      use_abs_dot: bool = False, chunk: int = 4096,
                      stats: Optional[dict] = None):
    """Plain PyTorch ``nearest_gated``: (idx int32 or -1, d2, dot).
    ``stats`` as in ``radius_knn_ref``."""
    _count(PLAIN_CALLS, "grid_nearest_gated")
    r2, _, thr = gnn.gate_params(radius, cos_gate)
    dev = q_pos.device
    m = q_pos.shape[0]
    best = torch.full((m,), gnn._NO_KEY, dtype=torch.int64, device=dev)
    if stats is not None:
        stats.update(pairs=0, in_radius=0)
    step = _step(dev, chunk)
    for s0 in range(0, m, step):
        qn = q_nrm[s0:s0 + step]
        qi, j, _, key = _within(grid, q_pos[s0:s0 + step], float(r2), stats)
        nr = grid.normals
        ok = _gate_exact(nr[j, 0], nr[j, 1], nr[j, 2], qn[qi, 0], qn[qi, 1],
                         qn[qi, 2], use_abs_dot) >= float(thr)
        # the first minimum in window order: the least key
        best.scatter_reduce_(0, qi[ok] + s0, key[ok], reduce="amin")
    found = best != gnn._NO_KEY
    j = torch.where(found, best & 0xFFFFFFFF, 0)
    d2 = torch.where(found, (best >> 32).to(torch.int32).view(torch.float32),
                     torch.inf)
    if grid.points.shape[0] == 0:
        return torch.full((m,), -1, dtype=torch.int32, device=dev), d2, \
            torch.zeros(m, device=dev)
    nr = grid.normals
    g = _gate_exact(nr[j, 0], nr[j, 1], nr[j, 2], q_nrm[:, 0], q_nrm[:, 1],
                    q_nrm[:, 2], use_abs_dot)
    idx = torch.where(found, grid.perm[j], -1).to(torch.int32)
    return idx, d2, torch.where(found, g, 0.0)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "hashgrid.cu")
_lib = None
_lib_lock = threading.Lock()
# ptxas's -v report of the library in use (kept beside it as
# ``libhashgrid-<hash>.so.ptxas.txt``)
BUILD_LOG = ""


def load_library():
    """Build ``csrc/hashgrid.cu`` (the grid and the dense kernels) into
    ``_build/`` (once per source and flag set) and load it. Raises with
    the compiler's stderr on failure."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            tag = hashlib.sha1(f.read() + " ".join(gnn.NVCC_FLAGS).encode()
                               ).hexdigest()[:12]
        out = os.path.join(gnn._BUILD_DIR, f"libhashgrid-{tag}.so")
        log = f"{out}.ptxas.txt"
        if not os.path.exists(out):
            nvcc = gnn.find_nvcc()
            os.makedirs(gnn._BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            r = subprocess.run([nvcc, *gnn.NVCC_FLAGS, "-o", tmp, _SRC],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"hashgrid: nvcc failed ({r.returncode}):"
                                   f"\n{r.stderr}")
            with open(log, "w") as f:
                f.write(r.stderr)
            os.replace(tmp, out)
        if os.path.exists(log):
            with open(log) as f:
                BUILD_LOG = f.read()
        _lib = bind(ctypes.CDLL(out))
        return _lib


def bind(lib):
    """Declare the C signatures of the library's three entry points."""
    vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
    grid = [f32, f32, f32, f32, i32, i32, i32, i32]
    lib.grid_radius_knn.restype = ctypes.c_int
    lib.grid_radius_knn.argtypes = [vp, vp, vp, *grid, vp, i64, f32, i32,
                                    vp, vp, vp, vp]
    lib.grid_nearest_gated.restype = ctypes.c_int
    lib.grid_nearest_gated.argtypes = [vp, vp, vp, vp, *grid, vp, vp, i64,
                                       f32, f32, i32, vp, vp, vp, vp]
    lib.dense_nearest.restype = ctypes.c_int
    lib.dense_nearest.argtypes = [vp, vp, i32, vp, vp, vp, i64, f32, f32,
                                  i32, vp, vp, vp, vp]
    return lib


def grid_args(grid: HashGrid) -> tuple:
    """The grid's scalar arguments: origin, f32(1 / cell), dims, L."""
    return (*grid.origin_host, float(np.float32(1.0 / grid.cell)),
            *grid.dims, 3 * grid.cap)


def _check(grid: HashGrid, *qs: torch.Tensor) -> None:
    for t in qs:
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"hashgrid: queries must be (M, 3) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.shape[0] != qs[0].shape[0]:
            raise ValueError("hashgrid: q_pos and q_nrm differ in length")
        if t.device != grid.device:
            raise ValueError(f"hashgrid: grid on {grid.device}, queries on "
                             f"{t.device}")


def radius_knn_args(grid: HashGrid, q, radius, k: int, idx, d2,
                    cnt) -> tuple:
    """``grid_radius_knn``'s arguments but the stream."""
    r2 = float(gnn.gate_params(radius, 0.0)[0])
    return (grid.points.data_ptr(), grid.perm.data_ptr(),
            grid.cell_start.data_ptr(), *grid_args(grid), q.data_ptr(),
            q.shape[0], r2, int(k), idx.data_ptr(), d2.data_ptr(),
            cnt.data_ptr())


def nearest_gated_args(grid: HashGrid, q_pos, q_nrm, radius, cos_gate,
                       use_abs_dot: bool, idx, d2, dot) -> tuple:
    """``grid_nearest_gated``'s arguments but the stream."""
    r2, _, thr = gnn.gate_params(radius, cos_gate)
    return (grid.points.data_ptr(), grid.normals.data_ptr(),
            grid.perm.data_ptr(), grid.cell_start.data_ptr(),
            *grid_args(grid), q_pos.data_ptr(), q_nrm.data_ptr(),
            q_pos.shape[0], float(r2), float(thr), int(use_abs_dot),
            idx.data_ptr(), d2.data_ptr(), dot.data_ptr())


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def radius_knn(grid: HashGrid, q: torch.Tensor, radius, k: int,
               chunk: int = 4096):
    """The K nearest points with d2 < r^2, ascending: (idx (M, k) int32
    in original order or -1, d2 (M, k) or +inf, count (M,) int32).
    ``chunk`` bounds the plain version's scratch; the kernel takes every
    query in one launch."""
    if not gnn._check_device(q):
        return radius_knn_ref(grid, q, radius, k, chunk)
    _check(grid, q)
    if k not in KERNEL_K:
        raise ValueError(f"hashgrid: radius_knn's kernel has K in "
                         f"{KERNEL_K}, not {k}")
    q = q.contiguous()
    m = q.shape[0]
    idx = torch.empty((m, k), dtype=torch.int32, device=q.device)
    d2 = torch.empty((m, k), dtype=torch.float32, device=q.device)
    cnt = torch.empty(m, dtype=torch.int32, device=q.device)
    if grid.points.shape[0] == 0:
        idx.fill_(-1)
        d2.fill_(torch.inf)
        cnt.zero_()
        return idx, d2, cnt
    lib = load_library()
    with torch.cuda.device(q.device):
        rc = lib.grid_radius_knn(*radius_knn_args(grid, q, radius, k, idx,
                                                  d2, cnt),
                                 _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"hashgrid: kernel launch failed, cudaError {rc}")
    _count(LAUNCHES, "grid_radius_knn")
    return idx, d2, cnt


def nearest_gated(grid: HashGrid, q_pos: torch.Tensor, q_nrm: torch.Tensor,
                  radius, cos_gate, use_abs_dot: bool = False,
                  chunk: int = 4096):
    """The nearest point with d2 < r^2 passing the normal gate: (idx
    int32 in original order or -1, d2 or +inf, gate dot or 0)."""
    if not gnn._check_device(q_pos):
        return nearest_gated_ref(grid, q_pos, q_nrm, radius, cos_gate,
                                 use_abs_dot, chunk)
    _check(grid, q_pos, q_nrm)
    q_pos, q_nrm = q_pos.contiguous(), q_nrm.contiguous()
    m = q_pos.shape[0]
    dev = q_pos.device
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    d2 = torch.empty(m, dtype=torch.float32, device=dev)
    dot = torch.empty(m, dtype=torch.float32, device=dev)
    if grid.points.shape[0] == 0:
        idx.fill_(-1)
        d2.fill_(torch.inf)
        dot.zero_()
        return idx, d2, dot
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.grid_nearest_gated(*nearest_gated_args(
            grid, q_pos, q_nrm, radius, cos_gate, use_abs_dot, idx, d2, dot),
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"hashgrid: kernel launch failed, cudaError {rc}")
    _count(LAUNCHES, "grid_nearest_gated")
    return idx, d2, dot
