"""Dense nearest-neighbour search — the port of rescan_tpu/ops/dense_nn.py.

Every query against every point of the index, the squared distance by
the expansion d2 = |q|^2 + |p|^2 - 2 q.p over coordinates centred by the
index centre (clamped at 0), the normal gate from a second dot product:
among points with strict d2 < r^2, index below ``n_valid`` and gate
max(dot, 0) (or |dot|) at least cos_gate - 1e-6, the nearest, the first
in index order among equal d2 (the JAX scan's first-occurrence argmin
per tile with a carry replaced only on a strictly smaller d2). Indices
are the points' original order, -1 where nothing qualifies.

Bit-identical to ``_nearest_chunk`` as XLA:CPU compiles it (probed on
jaxlib 0.9.0; tests/test_torch_dense_nn.py): |q|^2, |p|^2, q.p and the
normal dot are each fma(z, z', fma(y, y', x * x')), then
d2 = (|q|^2 + |p|^2) - 2 q.p.

Dispatch is on the queries' device: CUDA tensors launch
``dense_nearest_kernel`` of ``csrc/hashgrid.cu`` (the library of
ops/hashgrid.py), CPU tensors take the plain PyTorch version
``nearest_gated_dense_ref``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import gnn, hashgrid

LAUNCHES = {"dense_nearest": 0}
PLAIN_CALLS = {"dense_nearest": 0}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        LAUNCHES["dense_nearest"] = 0
        PLAIN_CALLS["dense_nearest"] = 0


def _count(counts: dict) -> None:
    with _count_lock:
        counts["dense_nearest"] += 1


@dataclasses.dataclass
class DenseIndex:
    """Points in original order, centred and padded to whole tiles with
    far rows (1e6), on one device."""
    points: torch.Tensor   # (n_pad, 3) f32, p - center; padding at 1e6
    normals: torch.Tensor  # (n_pad, 3) f32
    n_valid: int
    center: torch.Tensor   # (3,) f32
    tile: int = 2048

    @property
    def device(self) -> torch.device:
        return self.points.device

    def to(self, device) -> "DenseIndex":
        """This index with its tensors on ``device``."""
        if self.device == torch.device(device):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in
                     ("points", "normals", "center")})


def build_dense_index(points: np.ndarray, normals: Optional[np.ndarray] = None,
                      tile: int = 2048, device=None) -> DenseIndex:
    """The host build of dense_nn.py:59-70, placed on ``device`` (cuda
    unless the CPU is named)."""
    dev = resolve_device(device)
    pts = np.asarray(points, dtype=np.float32)
    n = len(pts)
    center = (pts.min(axis=0) + pts.max(axis=0)) * 0.5 if n else np.zeros(3)
    n_pad = max(((n + tile - 1) // tile) * tile, tile)
    p = np.full((n_pad, 3), 1e6, dtype=np.float32)   # padding is far away
    p[:n] = pts - center.astype(np.float32)
    nr = np.zeros((n_pad, 3), dtype=np.float32)
    if normals is not None:
        nr[:n] = np.asarray(normals, dtype=np.float32)
    return DenseIndex(torch.from_numpy(p).to(dev),
                      torch.from_numpy(nr).to(dev), n,
                      torch.from_numpy(center.astype(np.float32)).to(dev),
                      tile=tile)


def index_arrays(index: DenseIndex):
    """(points, normals) in original order, padding rows included
    (search.py:120-121)."""
    return index.points + index.center[None, :], index.normals


def _sq(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's jnp.sum(v * v, axis=1) of an (n, 3) f32 tensor."""
    x, y, z = v.unbind(1)
    return gnn._fma32(z, z, gnn._fma32(y, y, x * x))


def nearest_gated_dense_ref(index: DenseIndex, q_pos: torch.Tensor,
                            q_nrm: torch.Tensor, radius, cos_gate,
                            use_abs_dot: bool = False,
                            stats: Optional[dict] = None):
    """Plain PyTorch ``nearest_gated_dense``: (idx int32 or -1, d2, dot).

    The scan's answer is the least (d2, index) among the qualifying
    pairs (a first-occurrence argmin per tile, then a carry replaced only
    on a strictly smaller d2), so any superset of the pairs within r
    gives it: a min over packed (d2, index) keys. The candidates come
    from a hash grid of the valid points (ops/hashgrid.py) whose cells
    exceed r by far more than the expansion's rounding (below 8 ulp of
    (|q| + |p|)^2): scanning every pair in torch ops would take minutes
    at a scene's size, tile order being no spatial order. Each candidate
    is screened with a plain f32 distance just as loosely, and the
    survivors get the exact expansion and gate.

    ``stats``: a dict that receives the pairs the kernel evaluates
    (``pairs``: every query against every valid point) and those with
    d2 < r^2 (``in_radius``)."""
    _count(PLAIN_CALLS)
    r2, _, thr = gnn.gate_params(radius, cos_gate)
    r2, thr = float(r2), float(thr)
    dev = q_pos.device
    m = q_pos.shape[0]
    n = index.n_valid
    best = torch.full((m,), gnn._NO_KEY, dtype=torch.int64, device=dev)
    if stats is not None:
        stats.update(pairs=m * n, in_radius=0)
    qc = q_pos - index.center[None, :]
    if m and n:
        _scan(index, qc, q_nrm, r2, thr, use_abs_dot, best, stats)
    found = best != gnn._NO_KEY
    j = torch.where(found, best & 0xFFFFFFFF, 0)
    d2 = torch.where(found, (best >> 32).to(torch.int32).view(torch.float32),
                     torch.inf)
    nr = index.normals[j]
    g = hashgrid._gate_exact(q_nrm[:, 0], q_nrm[:, 1], q_nrm[:, 2], nr[:, 0],
                             nr[:, 1], nr[:, 2], use_abs_dot)
    return (torch.where(found, j, -1).to(torch.int32), d2,
            torch.where(found, g, 0.0))


def _scan(index, qc, q_nrm, r2, thr, use_abs_dot, best, stats):
    """Min the packed keys of every qualifying pair into ``best``."""
    dev = qc.device
    n = index.n_valid
    P = index.points[:n]
    p2 = _sq(P)
    pmax = float(P.double().norm(dim=1).max())
    qnorm = qc.double().norm(dim=1)
    # a query this far out cannot come within r of any point, however
    # the expansion rounds; the rest are within `bound` of the centre
    bound = 2.0 * pmax + 1.0 + r2 ** 0.5
    live = (qnorm <= bound).nonzero()[:, 0]
    reach2 = r2 * 1.0001 + 1e-5 * (bound + pmax) ** 2 + 1e-6
    grid = hashgrid.build_grid(P.cpu().numpy(), 1.01 * reach2 ** 0.5,
                               device=dev)
    step = 65536 if dev.type == "cuda" else 4096
    for s0 in range(0, live.numel(), step):
        rows = live[s0:s0 + step]
        q = qc[rows]
        qi, j = hashgrid._window(grid, q)
        j = grid.perm[j].long()
        d = P[j] - q[qi]
        near = ((d * d).sum(1) <= reach2).nonzero()[:, 0]
        qi, j = rows[qi[near]], j[near]
        cross = gnn._fma32(qc[qi, 2], P[j, 2], gnn._fma32(
            qc[qi, 1], P[j, 1], qc[qi, 0] * P[j, 0]))
        d2 = ((_sq(qc[qi]) + p2[j]) - 2.0 * cross).clamp(min=0.0)
        inr = d2 < r2
        if stats is not None:
            stats["in_radius"] += int(inr.sum())
        nr = index.normals[j]
        g = hashgrid._gate_exact(q_nrm[qi, 0], q_nrm[qi, 1], q_nrm[qi, 2],
                                 nr[:, 0], nr[:, 1], nr[:, 2], use_abs_dot)
        ok = inr & (g >= thr)
        key = (d2[ok].view(torch.int32).long() << 32) | j[ok]
        best.scatter_reduce_(0, qi[ok], key, reduce="amin")


def nearest_gated_dense(index: DenseIndex, q_pos: torch.Tensor,
                        q_nrm: torch.Tensor, radius, cos_gate,
                        use_abs_dot: bool = False, chunk: int = 32768):
    """The nearest point with d2 < r^2 passing the normal gate: (idx int32
    in original order or -1, d2 or +inf, gate dot or 0). ``chunk`` is the
    JAX function's query chunk, which changes no result; the kernel
    takes every query in one launch."""
    del chunk
    if not gnn._check_device(q_pos):
        return nearest_gated_dense_ref(index, q_pos, q_nrm, radius, cos_gate,
                                       use_abs_dot)
    hashgrid._check(index, q_pos, q_nrm)
    q_pos, q_nrm = q_pos.contiguous(), q_nrm.contiguous()
    m = q_pos.shape[0]
    dev = q_pos.device
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    d2 = torch.empty(m, dtype=torch.float32, device=dev)
    dot = torch.empty(m, dtype=torch.float32, device=dev)
    lib = hashgrid.load_library()
    with torch.cuda.device(dev):
        rc = lib.dense_nearest(*dense_args(index, q_pos, q_nrm, radius,
                                           cos_gate, use_abs_dot, idx, d2,
                                           dot),
                               hashgrid._stream(dev))
    if rc != 0:
        raise RuntimeError(f"dense_nn: kernel launch failed, cudaError {rc}")
    _count(LAUNCHES)
    return idx, d2, dot


def dense_args(index: DenseIndex, q_pos, q_nrm, radius, cos_gate,
               use_abs_dot: bool, idx, d2, dot) -> tuple:
    """``dense_nearest``'s arguments but the stream."""
    r2, _, thr = gnn.gate_params(radius, cos_gate)
    return (index.points.data_ptr(), index.normals.data_ptr(), index.n_valid,
            index.center.data_ptr(), q_pos.data_ptr(), q_nrm.data_ptr(),
            q_pos.shape[0], float(r2), float(thr), int(use_abs_dot),
            idx.data_ptr(), d2.data_ptr(), dot.data_ptr())
