"""Gated nearest-neighbour search over a Morton-sorted scene slab — the
port of rescan_tpu/ops/pallas_nn.py.

One function in two forms, K1 ``gated_min`` (no index; every scoring
pass) and K2 ``nearest_gated`` (with index; ICP correspondences and
label transfer). Per query (q, n): among scene points p with strict
|q - p|^2 < r^2 and gate g = max(n . n_p, 0) (or |n . n_p|) with
g >= cos_gate - 1e-6, the nearest one; ties go to the lowest
Morton-sorted column. Results are (+inf, 0) and index -1 where nothing
qualifies.

Dispatch is on the queries' device and nothing else: CUDA tensors launch
the hand-written kernel in ``csrc/gnn.cu`` (built with nvcc at first use
into ``rescan_tpu_torch/_build/`` and bound with ctypes), CPU tensors
take the plain PyTorch version (``nearest_gated_ref``/``gated_min_ref``).
Both are bit-identical to the Pallas kernel: same f32 constants, same
block-bbox tile pruning, the same fused-multiply-add pattern in d2 and
the normal dot (XLA's compiled arithmetic contracts them, so the
reference's bits are the fused ones), and the same tie rule. Inside near
tiles both prune with the slab's run table (``SortedSlab.run_bounds``,
the bounds of every RUN-column run), which drops only columns that
cannot pass d2 < r^2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils import timing

# Far-sentinel coordinate for padding queries/points (pallas_nn.py:118).
FAR = 1e6
SCENE_TILE = 2048
# Queries per pruning block: one CUDA block (a warp with 4 queries per
# thread), and one bbox in the plain version's near-tile test.
QUERY_BLOCK = 128
# Queries per slot (one per lane): the kernel tests each run against the
# bbox of every slot of the block.
SLOT = 32
# Columns per run of the run table (csrc/gnn.cu RUN); tiles are whole runs.
RUN = 32

# Kernel launches per wrapper, and calls of the plain versions. Callers
# that need to show which path ran reset them with ``reset_counts``.
LAUNCHES = {"gated_min": 0, "nearest_gated": 0}
PLAIN_CALLS = {"gated_min": 0, "nearest_gated": 0}
# shard slots call the wrappers from several threads (parallel/mesh.py)
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        for d in (LAUNCHES, PLAIN_CALLS):
            for k in d:
                d[k] = 0


def _count(counts: dict, name: str) -> None:
    with _count_lock:
        counts[name] += 1


def morton_key(points: np.ndarray, cell: float) -> np.ndarray:
    """(N,) int64 Morton codes of points binned at ``cell``."""
    p = np.asarray(points, np.float32)
    n = len(p)
    c = np.floor(p / cell).astype(np.int64)
    if n:
        c -= c.min(axis=0)
    key = np.zeros(n, np.int64)
    for bit in range(16):
        for ax in range(3):
            key |= ((c[:, ax] >> bit) & 1) << (3 * bit + ax)
    return key


def morton_order(points: np.ndarray, cell: float = 0.2) -> np.ndarray:
    """Permutation sorting points along a Morton curve (spatially compact
    runs of query points make tight query-block bounding boxes)."""
    return np.argsort(morton_key(points, cell), kind="stable")


@dataclasses.dataclass
class SortedSlab:
    """A scene packed for the kernel: Morton-sorted columns cut into
    tiles, per-tile and per-run bounds, and the sort permutation."""
    slab: torch.Tensor         # (8, N_pad) f32 rows x y z |p|^2 nx ny nz pad
    tile_bounds: torch.Tensor  # (n_tiles, 8) f32: min xyz at 0:3, max at 4:7
    perm: torch.Tensor         # (N_pad,) int32 original index, -1 = padding
    n_valid: int
    center: torch.Tensor       # (3,) f32; columns hold p - center
    tile: int                  # columns per tile
    run_bounds: torch.Tensor   # (N_pad / RUN, 8) f32, as tile_bounds

    @property
    def n_tiles(self) -> int:
        return int(self.tile_bounds.shape[0])

    @property
    def device(self) -> torch.device:
        return self.slab.device

    def to(self, device) -> "SortedSlab":
        """This slab with its tensors on ``device``."""
        if self.device == torch.device(device):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in
                     ("slab", "tile_bounds", "perm", "center",
                      "run_bounds")})


def run_bounds_of(slab: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(N_pad / RUN, 8) min xyz (0:3) and max xyz (4:7) of the valid
    columns of every RUN-column run; FAR for runs of padding."""
    xyz = slab[0:3].T.reshape(-1, RUN, 3)
    valid = (perm >= 0).reshape(-1, RUN, 1)
    lo = torch.where(valid, xyz, FAR).amin(1)
    hi = torch.where(valid, xyz, -FAR).amax(1)
    hi = torch.where(valid.any(1), hi, FAR)
    pad = torch.zeros_like(lo[:, :1])
    return torch.cat([lo, pad, hi, pad], 1).contiguous()


def slab_from_numpy(slab, tile_bounds, perm, n_valid, center, tile: int,
                    device=None) -> SortedSlab:
    """The port's slab on ``device`` (``resolve_device``: cuda unless the
    CPU is named) from a slab's arrays as numpy — the JAX package's
    ``SortedSlab`` fields, or ``build_sorted_slab``'s. The run table is
    built here, once per slab, on ``device``."""
    dev = resolve_device(device)
    if int(tile) % RUN:
        raise ValueError(f"slab tile {tile} is not a multiple of {RUN}")
    slab_t = timing.to_device(torch.tensor(np.asarray(slab, np.float32)),
                              dev)
    perm_t = timing.to_device(torch.tensor(np.asarray(perm, np.int32)), dev)
    return SortedSlab(
        slab=slab_t,
        tile_bounds=timing.to_device(
            torch.tensor(np.asarray(tile_bounds, np.float32)), dev),
        perm=perm_t,
        n_valid=int(n_valid),
        center=timing.to_device(
            torch.tensor(np.asarray(center, np.float32)), dev),
        tile=int(tile),
        run_bounds=run_bounds_of(slab_t, perm_t))


def build_sorted_slab(points: np.ndarray, normals: np.ndarray,
                      cell: float = 0.4, tile: int = SCENE_TILE,
                      device=None) -> SortedSlab:
    """Morton-sort the points about their bbox centre and cut them into
    tiles of ``tile`` columns, starting a new tile at every coarse-octant
    boundary so no tile straddles a Morton jump (pallas_nn.py:304-395,
    without the VMEM split and the tile-count buckets). Padding columns
    sit at FAR. ``device`` as in ``slab_from_numpy``."""
    pts = np.asarray(points, np.float32)
    nrm = np.asarray(normals, np.float32)
    n = len(pts)
    center = ((pts.min(0) + pts.max(0)) * 0.5 if n
              else np.zeros(3)).astype(np.float32)
    p = pts - center
    order = np.argsort(morton_key(p, cell), kind="stable")
    p = p[order]
    nr = nrm[order]
    oidx = order.astype(np.int32)

    max_side = 6.0
    segments = []
    if n:
        coarse = morton_key(p, max_side / 2.0)
        run_starts = np.concatenate(
            [[0], np.flatnonzero(coarse[1:] != coarse[:-1]) + 1, [n]])
        for a, b in zip(run_starts[:-1], run_starts[1:]):
            for s in range(a, b, tile):
                segments.append((s, min(s + tile, b)))
    else:
        segments = [(0, 0)]
    n_tiles = len(segments)
    n_pad = n_tiles * tile
    slab = np.zeros((8, n_pad), np.float32)
    slab[0:3, :] = FAR
    slab[3, :] = 3e12
    perm = np.full(n_pad, -1, np.int32)
    tb = np.zeros((n_tiles, 8), np.float32)
    for t, (a, b) in enumerate(segments):
        k = b - a
        o = t * tile
        slab[0:3, o:o + k] = p[a:b].T
        slab[3, o:o + k] = (p[a:b] * p[a:b]).sum(1)
        slab[4:7, o:o + k] = nr[a:b].T
        perm[o:o + k] = oidx[a:b]
        if k:
            tb[t, 0:3] = p[a:b].min(0)
            tb[t, 4:7] = p[a:b].max(0)
        else:
            tb[t, 0:3] = FAR
            tb[t, 4:7] = FAR
    return slab_from_numpy(slab, tb, perm, n, center, tile, device)


def gate_params(radius, cos_gate) -> Tuple[np.float32, np.float32,
                                            np.float32]:
    """(r^2, sqrt(r^2), cos_gate - 1e-6), each formed in f32 as the
    reference's jitted code forms them (pallas_nn.py:208, :416, :431)."""
    r = np.float32(radius)
    r2 = np.float32(r * r)
    radj = np.sqrt(r2, dtype=np.float32)
    thr = np.float32(np.float32(cos_gate) - np.float32(1e-6))
    return r2, radj, thr


def run_slack(radj) -> float:
    """The run test's dilation: radj with a relative and an absolute
    margin far above f32 rounding, so a run is dropped only when none of
    its columns can pass d2 < r^2 (held by the tests at exactly r)."""
    return float(np.float32(float(radj) * 1.0001 + 1e-6))


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

_NO_KEY = (1 << 62)   # "nothing found" in the packed (d2, column) keys


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 fused multiply-add of f32 tensors.

    a*b is exact in f64; the f64 sum is made round-to-odd (TwoSum error,
    then the odd neighbour where the sum was inexact and even), and
    round-to-odd in 53 bits followed by one rounding to 24 bits equals a
    single correct rounding (Boldo and Melquiond)."""
    return _sum_to_f32(a.double() * b.double(), c.double())


def _sum_to_f32(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 of p + c for f64 tensors p (a product of
    two f32 values, exact in f64) and c (an f32 value)."""
    s = p + c
    bp = s - c
    bc = s - bp
    err = (p - bp) + (c - bc)
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(nudge, bits + step, bits)
    return bits.view(torch.float64).float()


def _d2_exact(qx, qy, qz, sx, sy, sz):
    dx, dy, dz = qx - sx, qy - sy, qz - sz
    return _fma32(dz, dz, _fma32(dx, dx, dy * dy))


def _gate_exact(nx, ny, nz, sx, sy, sz, use_abs_dot: bool):
    nd = _fma32(nz, sz, _fma32(nx, sx, ny * sy))
    return nd.abs() if use_abs_dot else torch.where(nd > 0, nd, 0.0)


def _query_ref(slab: SortedSlab, q_pos: torch.Tensor, q_nrm: torch.Tensor,
               radius, cos_gate, use_abs_dot: bool,
               stats: Optional[dict] = None):
    """Packed (d2 bits << 32 | column) of each query's best, or _NO_KEY.

    The near-tile test is the reference's (K3): per QUERY_BLOCK-query
    block, tile bounds against the block bbox dilated by sqrt(r^2), in
    the same f32 expressions. Inside near tiles, the runs of the run
    table are skipped when their bounds miss the block bbox by more than
    ``run_slack`` — that never drops a column that could pass d2 < r^2,
    so the result is the reference's. The surviving (query, column) pairs
    are screened with a plain f32 d2 against a loose bound, and the few
    in-radius candidates get the exact fused d2 and gate; a min over the
    packed keys picks the smallest d2 and, among equal d2, the lowest
    column.

    ``stats``: a dict that receives the (query, column) pair counts of
    this call: ``tile_pairs``, every column of every near tile against
    every query of the block (the pairs a kernel without run pruning
    evaluates); ``run_pairs``, every column of every run against every
    query of each SLOT-query slot of the block whose bbox the run
    reaches (the pairs the CUDA kernel evaluates); ``in_radius``, the
    pairs with d2 < r^2."""
    r2, radj, thr = gate_params(radius, cos_gate)
    dev = q_pos.device
    m = q_pos.shape[0]
    best = torch.full((m,), _NO_KEY, dtype=torch.int64, device=dev)
    if stats is not None:
        stats.update(tile_pairs=0, run_pairs=0, in_radius=0)
    if m == 0 or slab.n_valid == 0:
        return best
    qc = q_pos - slab.center[None, :]
    nb = -(-m // QUERY_BLOCK)
    pad = nb * QUERY_BLOCK - m
    qb = torch.cat([qc, qc.new_zeros(pad, 3)]).reshape(nb, QUERY_BLOCK, 3)
    qvalid = (torch.arange(nb * QUERY_BLOCK, device=dev) < m).reshape(
        nb, QUERY_BLOCK)
    bmin = torch.where(qvalid[..., None], qb, torch.inf).amin(1)   # (nb, 3)
    bmax = torch.where(qvalid[..., None], qb, -torch.inf).amax(1)
    tb = slab.tile_bounds
    radj_f = float(radj)
    near = ((tb[None, :, 0] <= bmax[:, 0, None] + radj_f)
            & (tb[None, :, 4] >= bmin[:, 0, None] - radj_f)
            & (tb[None, :, 1] <= bmax[:, 1, None] + radj_f)
            & (tb[None, :, 5] >= bmin[:, 1, None] - radj_f)
            & (tb[None, :, 2] <= bmax[:, 2, None] + radj_f)
            & (tb[None, :, 6] >= bmin[:, 2, None] - radj_f))
    pb, pt = near.nonzero(as_tuple=True)
    cpt = slab.tile // RUN
    pb = pb.repeat_interleave(cpt)
    pc = (pt[:, None] * cpt + torch.arange(cpt, device=dev)[None]).reshape(-1)
    cb = slab.run_bounds[pc]
    slack = run_slack(radj)
    keep = ((cb[:, 0:3] <= bmax[pb] + slack)
            & (cb[:, 4:7] >= bmin[pb] - slack)).all(1)
    pb, pc, cb = pb[keep], pc[keep], cb[keep]
    if stats is not None:
        stats["tile_pairs"] = int((near.sum(1) * qvalid.sum(1)).sum()) \
            * slab.tile
        sq = qb.reshape(nb, -1, SLOT, 3)
        sv = qvalid.reshape(nb, -1, SLOT)
        smin = torch.where(sv[..., None], sq, torch.inf).amin(2)
        smax = torch.where(sv[..., None], sq, -torch.inf).amax(2)
        n_slot = sv.sum(2)
        for s0 in range(0, len(pb), 1 << 20):
            b, r = pb[s0:s0 + (1 << 20)], cb[s0:s0 + (1 << 20), None]
            hit = ((r[..., 0:3] <= smax[b] + slack)
                   & (r[..., 4:7] >= smin[b] - slack)).all(2)
            stats["run_pairs"] += int((hit * n_slot[b]).sum()) * RUN

    sx, sy, sz = slab.slab[0], slab.slab[1], slab.slab[2]
    snx, sny, snz = slab.slab[4], slab.slab[5], slab.slab[6]
    qx, qy, qz = qc[:, 0], qc[:, 1], qc[:, 2]
    qnx, qny, qnz = q_nrm[:, 0], q_nrm[:, 1], q_nrm[:, 2]
    screen = float(r2) * 1.0001
    ar_q = torch.arange(QUERY_BLOCK, device=dev)
    ar_c = torch.arange(RUN, device=dev)
    qbf = qb.reshape(-1, 3)
    qvf = qvalid.reshape(-1)
    step = 65536 if dev.type == "cuda" else 4096
    for s0 in range(0, len(pb), step):
        # (query, run) pairs: each query against the runs near its block
        rows = pb[s0:s0 + step, None] * QUERY_BLOCK + ar_q[None]   # (P, BQ)
        run = cb[s0:s0 + step, None, :]
        q3 = qbf[rows]                                             # (P, BQ, 3)
        inq = ((q3 >= run[..., 0:3] - slack)
               & (q3 <= run[..., 4:7] + slack)).all(-1) & qvf[rows]
        p_i, q_i = inq.nonzero(as_tuple=True)
        qq = rows[p_i, q_i]                                        # (K,)
        cols = pc[s0:s0 + step][p_i, None] * RUN + ar_c[None]      # (K, C)
        dx = qx[qq, None] - sx[cols]
        dy = qy[qq, None] - sy[cols]
        dz = qz[qq, None] - sz[cols]
        k_i, j_i = (dx * dx + dy * dy + dz * dz <= screen).nonzero(
            as_tuple=True)
        qq = qq[k_i]
        cc = cols[k_i, j_i]
        d2 = _d2_exact(qx[qq], qy[qq], qz[qq], sx[cc], sy[cc], sz[cc])
        g = _gate_exact(qnx[qq], qny[qq], qnz[qq], snx[cc], sny[cc],
                        snz[cc], use_abs_dot)
        inr = d2 < float(r2)
        if stats is not None:
            stats["in_radius"] += int(inr.sum())
        ok = inr & (g >= float(thr))
        key = (d2[ok].view(torch.int32).to(torch.int64) << 32) | cc[ok]
        best.scatter_reduce_(0, qq[ok], key, reduce="amin")
    return best


def _unpack_ref(slab: SortedSlab, q_nrm: torch.Tensor, best: torch.Tensor,
                use_abs_dot: bool):
    found = best != _NO_KEY
    col = torch.where(found, best & 0xFFFFFFFF, 0)
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    d2 = torch.where(found, d2, torch.inf)
    s = slab.slab
    g = _gate_exact(q_nrm[:, 0], q_nrm[:, 1], q_nrm[:, 2], s[4][col],
                    s[5][col], s[6][col], use_abs_dot)
    dot = torch.where(found, g, 0.0)
    return found, col, d2, dot


def nearest_gated_ref(slab: SortedSlab, q_pos: torch.Tensor,
                      q_nrm: torch.Tensor, radius, cos_gate,
                      use_abs_dot: bool = False):
    """Plain PyTorch K2: (idx int32 in original order or -1, d2, dot)."""
    _count(PLAIN_CALLS, "nearest_gated")
    best = _query_ref(slab, q_pos, q_nrm, radius, cos_gate, use_abs_dot)
    found, col, d2, dot = _unpack_ref(slab, q_nrm, best, use_abs_dot)
    idx = torch.where(found, slab.perm[col], -1).to(torch.int32)
    return idx, d2, dot


def gated_min_ref(slab: SortedSlab, q_pos: torch.Tensor, q_nrm: torch.Tensor,
                  radius, cos_gate, use_abs_dot: bool = False):
    """Plain PyTorch K1: (d2, dot) of the nearest qualifying point."""
    _count(PLAIN_CALLS, "gated_min")
    best = _query_ref(slab, q_pos, q_nrm, radius, cos_gate, use_abs_dot)
    _, _, d2, dot = _unpack_ref(slab, q_nrm, best, use_abs_dot)
    return d2, dot


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "gnn.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
_lib = None
_lib_lock = threading.Lock()
# ptxas's report (registers, shared memory, spills per instantiation) of
# the library in use (kept beside it as ``libgnn-<hash>.so.ptxas.txt``)
BUILD_LOG = ""


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("gnn: nvcc not found (not on PATH, no CUDA_HOME); "
                       "the CUDA kernel cannot be built")


def build_library(name: str, sources: Sequence[str]) -> tuple:
    """Build ``sources[0]`` with nvcc and NVCC_FLAGS into
    ``_build/lib<name>-<hash>.so`` (once per set of sources, the headers it
    includes listed after it, and flags: the hash covers them all) and load
    it: (the CDLL, ptxas's -v report, kept beside the library as
    ``<lib>.ptxas.txt``). Raises with the compiler's stderr on failure."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")
    log = f"{out}.ptxas.txt"
    if not os.path.exists(out):
        nvcc = find_nvcc()
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, sources[0]],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed ({r.returncode}):\n"
                               f"{r.stderr}")
        with open(log, "w") as f:
            f.write(r.stderr)
        os.replace(tmp, out)
    report = ""
    if os.path.exists(log):
        with open(log) as f:
            report = f.read()
    return ctypes.CDLL(out), report


def load_library():
    """Build ``csrc/gnn.cu`` (``build_library``) and load it."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is None:
            lib, BUILD_LOG = build_library("gnn", [_SRC])
            _lib = bind(lib)
        return _lib


def bind(lib):
    """Declare the C signatures of ``gnn_query`` and ``gnn_kernel_info``
    on a loaded library."""
    vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
    lib.gnn_query.restype = ctypes.c_int
    lib.gnn_query.argtypes = [vp, vp, i64, vp, i64, vp, i32, i32, vp, vp,
                              vp, f32, f32, f32, f32, i32, i32, vp, vp,
                              vp, vp]
    lib.gnn_kernel_info.restype = ctypes.c_int
    lib.gnn_kernel_info.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    return lib


def query_args(slab: SortedSlab, q_pos, q_nrm, radius, cos_gate,
               use_abs_dot: bool, idx, d2, dot) -> tuple:
    """``gnn_query``'s arguments but the stream, from tensors already
    checked by the caller (``idx`` None for K1)."""
    r2, radj, thr = gate_params(radius, cos_gate)
    return (q_pos.data_ptr(), q_nrm.data_ptr(), q_pos.shape[0],
            slab.slab.data_ptr(), slab.slab.shape[1],
            slab.tile_bounds.data_ptr(), slab.n_tiles, slab.tile,
            slab.run_bounds.data_ptr(), slab.perm.data_ptr(),
            slab.center.data_ptr(), float(r2), float(radj), run_slack(radj),
            float(thr), int(use_abs_dot), int(idx is not None),
            None if idx is None else idx.data_ptr(), d2.data_ptr(),
            dot.data_ptr())


def kernel_info(want_idx: bool, use_abs_dot: bool, device,
                carveout: int = -1) -> dict:
    """Residency of one kernel instantiation on the CUDA ``device``, after
    setting its preferred shared-memory carveout (percent of the SM's
    most; -1, the driver's default): CTAs per SM by the occupancy
    calculator, registers per thread, static shared bytes per CTA, local
    (spill) bytes per thread."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = lib.gnn_kernel_info(int(want_idx), int(use_abs_dot),
                                 int(carveout), out)
    if rc != 0:
        raise RuntimeError(f"gnn: kernel info failed, cudaError {rc}")
    return dict(zip(("ctas_per_sm", "registers", "shared_bytes",
                     "local_bytes"), out))


def _launch(slab: SortedSlab, q_pos, q_nrm, radius, cos_gate,
            use_abs_dot: bool, want_idx: bool):
    """One kernel launch on the queries' device and current stream."""
    dev = q_pos.device
    for name, t in (("q_pos", q_pos), ("q_nrm", q_nrm)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"gnn: {name} must be (M, 3) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if q_nrm.shape[0] != q_pos.shape[0]:
        raise ValueError("gnn: q_pos and q_nrm differ in length")
    if slab.device != dev:
        raise ValueError(f"gnn: slab on {slab.device}, queries on {dev}")
    if slab.tile_bounds.dtype != torch.float32 or slab.perm.dtype != torch.int32:
        raise ValueError("gnn: slab tensors have the wrong dtypes")
    if slab.tile % RUN or slab.run_bounds.shape != (slab.slab.shape[1] // RUN,
                                                    8):
        raise ValueError("gnn: slab tile or run table does not match RUN")
    for t in (slab.slab, slab.tile_bounds, slab.run_bounds):
        # whole 16-byte copies and float4 loads in the kernel
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gnn: slab tensors must be contiguous and "
                             "16-byte aligned")
    q_pos = q_pos.contiguous()
    q_nrm = q_nrm.contiguous()
    m = q_pos.shape[0]
    d2 = torch.empty(m, dtype=torch.float32, device=dev)
    dot = torch.empty(m, dtype=torch.float32, device=dev)
    idx = torch.empty(m, dtype=torch.int32, device=dev) if want_idx else None
    if slab.n_valid == 0:
        d2.fill_(torch.inf)
        dot.zero_()
        if want_idx:
            idx.fill_(-1)
        return idx, d2, dot
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gnn_query(*query_args(slab, q_pos, q_nrm, radius, cos_gate,
                                       use_abs_dot, idx, d2, dot), stream)
    if rc != 0:
        raise RuntimeError(f"gnn: kernel launch failed, cudaError {rc}")
    _count(LAUNCHES, "nearest_gated" if want_idx else "gated_min")
    return idx, d2, dot


def pair_counts(slab: SortedSlab, q_pos: torch.Tensor, q_nrm: torch.Tensor,
                radius, cos_gate, use_abs_dot: bool = False) -> dict:
    """The (query, column) pair counts of one query batch, from the plain
    version's pruning (see ``_query_ref``): ``tile_pairs``, ``run_pairs``
    (the pairs the CUDA kernel evaluates) and ``in_radius``. Adds to no
    launch or call count."""
    stats = {}
    _query_ref(slab, q_pos, q_nrm, radius, cos_gate, use_abs_dot, stats)
    return stats


def _check_device(q_pos: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    if q_pos.is_cuda:
        return True
    if q_pos.device.type == "cpu":
        return False
    raise ValueError(f"gnn: unsupported device {q_pos.device}")


def nearest_gated(slab: SortedSlab, q_pos: torch.Tensor, q_nrm: torch.Tensor,
                  radius, cos_gate, use_abs_dot: bool = False):
    """K2: (idx int32 in original point order or -1, d2, dot)."""
    if _check_device(q_pos):
        return _launch(slab, q_pos, q_nrm, radius, cos_gate, use_abs_dot,
                       want_idx=True)
    return nearest_gated_ref(slab, q_pos, q_nrm, radius, cos_gate,
                             use_abs_dot)


def gated_min(slab: SortedSlab, q_pos: torch.Tensor, q_nrm: torch.Tensor,
              radius, cos_gate, use_abs_dot: bool = False):
    """K1: (d2, dot) of the nearest qualifying point; d2 = +inf where
    none qualifies."""
    if _check_device(q_pos):
        _, d2, dot = _launch(slab, q_pos, q_nrm, radius, cos_gate,
                             use_abs_dot, want_idx=False)
        return d2, dot
    return gated_min_ref(slab, q_pos, q_nrm, radius, cos_gate, use_abs_dot)
