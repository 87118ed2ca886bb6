"""Batched pose-hypothesis alignment scoring — the port of
rescan_tpu/ops/score.py.

Per-point score (pose_proposal.cpp:127-156): for the nearest in-radius
scene point whose normal passes the 35-degree gate,

    score = 0.05 * exp(-angle^2 / (2 * 0.5^2)) + 0.95 * exp(-d^2 / (2 * sigma^2))

unmatched points contribute 0, and a hypothesis scores the mean over the
object's points. All hypotheses of all objects stream through
``ScoreStream``: requests with the same padded point count share
launches of at most MAX_QUERIES_PER_LAUNCH queries, each one transform,
one K1 query (ops/gnn.py ``gated_min``) and one reduction.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import config
from . import gnn, icp, pairsum, search, xla_math

# the sum of a hypothesis's per-point scores: jnp.sum's order
# (rescan_tpu/ops/score.py:168; ops/pairsum.py)
SUM_SPEC = [(pairsum.WINDOW, 0, pairsum.ONE)]

# queries per launch: bounds the (h, Pp, 3) transform and the outputs
MAX_QUERIES_PER_LAUNCH = 1 << 22

# cos(deg2rad(35)) formed in f32, as the reference's jitted code forms it
SCORE_COS_GATE = float(torch.cos(torch.deg2rad(
    torch.tensor(config.SCORE_MAX_ANGLE_DEG, dtype=torch.float32))))


# the per-point terms' constants in f32, as XLA folds them
_ALPHA = float(np.float32(config.SCORE_ALPHA))
_ONE_MINUS_ALPHA = float(np.float32(1.0 - config.SCORE_ALPHA))
_NORMAL_DIV = float(np.float32(2.0 * config.SCORE_NORMAL_SIGMA ** 2))


def _dist_div(sigma) -> float:
    return float(np.float32(2.0) * np.float32(sigma) * np.float32(sigma))


def _pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def prep_points(obj_pts: np.ndarray, obj_nrm: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Morton-sort and pad one object's query-level points for scoring.

    Returns (pts (Pp, 3), nrm (Pp, 3), mask (Pp,)) with Pp a power of
    two: points sorted for tight query blocks, replicate-last padding up
    to the next block boundary, far sentinels beyond.
    """
    p = len(obj_pts)
    pp = max(_pow2(p), 128)
    bq = gnn.QUERY_BLOCK
    order = gnn.morton_order(obj_pts)
    pts = np.full((pp, 3), gnn.FAR, np.float32)
    nrm = np.zeros((pp, 3), np.float32)
    mask = np.zeros(pp, bool)
    pts[:p] = np.asarray(obj_pts, np.float32)[order]
    nrm[:p] = np.asarray(obj_nrm, np.float32)[order]
    mask[:p] = True
    edge = min(((p + bq - 1) // bq) * bq, pp)
    if p and edge > p:
        pts[p:edge] = pts[p - 1]
        nrm[p:edge] = nrm[p - 1]
    return pts, nrm, mask


def _score_terms(index: search.Index, pts_all: torch.Tensor,
                 nrm_all: torch.Tensor, mask_all: torch.Tensor,
                 hyps: torch.Tensor, owner: torch.Tensor, radius, sigma
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point scores (h, Pp) of h hypotheses whose object points are
    pts_all[owner[h]], and the points' mask (h, Pp)."""
    R = hyps[:, :3, :3]
    t = hyps[:, :3, 3]
    pts = pts_all[owner]
    nrm = nrm_all[owner]
    mask = mask_all[owner]
    # the transforms as XLA computes them (ops/pairsum.py)
    q, qn = icp._transform(R, t, pts, nrm)
    h, pp = mask.shape
    d2, dot, found = search.gated_min(index, q.reshape(h * pp, 3),
                                      qn.reshape(h * pp, 3), radius,
                                      SCORE_COS_GATE)
    return per_point(d2.reshape(h, pp), dot.reshape(h, pp),
                     found.reshape(h, pp), mask, sigma), mask


def per_point_ref(d2: torch.Tensor, dot: torch.Tensor, found: torch.Tensor,
                  mask: torch.Tensor, sigma) -> torch.Tensor:
    """The plain PyTorch ``per_point``."""
    pairsum._count(pairsum.PLAIN_CALLS, "score_terms")
    found = found & mask
    d2 = torch.where(found, d2, 0.0)
    angle = xla_math.acos_ref(dot.clamp(0.0, 1.0))
    normal = xla_math.exp_ref(icp.div(-(angle * angle), _NORMAL_DIV))
    dist = xla_math.exp_ref(icp.div(-d2, _dist_div(sigma)))
    # XLA contracts the sum of the two weighted terms into one fma
    per_pt = gnn._fma32(dist.new_tensor(_ONE_MINUS_ALPHA), dist,
                        _ALPHA * normal)
    return torch.where(found, per_pt, 0.0)


def per_point(d2: torch.Tensor, dot: torch.Tensor, found: torch.Tensor,
              mask: torch.Tensor, sigma) -> torch.Tensor:
    """Per-point scores (h, Pp) from K1's (h, Pp) d2, normal dot and found
    flags and the points' mask, in XLA's order (score.py:160-166): the
    clamp, XLA's f32 arccos and two exps (ops/xla_math.py), the true
    divisions, the contracted fma, the mask. CUDA tensors launch
    ``score_terms_kernel`` (csrc/pairsum.cu, one pass), CPU tensors take
    ``per_point_ref``; the two give the same bits."""
    if not d2.is_cuda:
        return per_point_ref(d2, dot, found, mask, sigma)
    if not (d2.shape == dot.shape == found.shape == mask.shape) or \
            d2.dtype != torch.float32 or dot.dtype != torch.float32:
        raise ValueError("per_point: want equal shapes, float32 d2/dot")
    d2, dot = d2.contiguous(), dot.contiguous()
    found, mask = found.contiguous(), mask.contiguous()
    out = torch.empty_like(d2)
    if out.numel():
        pairsum.run("score_terms", d2.device, d2.data_ptr(), dot.data_ptr(),
                    found.data_ptr(), mask.data_ptr(), out.data_ptr(),
                    out.numel(), _NORMAL_DIV, _dist_div(sigma), _ALPHA,
                    _ONE_MINUS_ALPHA)
    return out


def _score_multi(index: search.Index, pts_all: torch.Tensor,
                 nrm_all: torch.Tensor, mask_all: torch.Tensor,
                 hyps: torch.Tensor, owner: torch.Tensor, radius,
                 sigma) -> torch.Tensor:
    """Score h hypotheses whose object points are pts_all[owner[h]].

    pts_all/nrm_all: (R, Pp, 3); mask_all: (R, Pp); hyps: (h, 4, 4);
    owner: (h,) int64. Returns (h,) scores.
    """
    per_pt, mask = _score_terms(index, pts_all, nrm_all, mask_all, hyps,
                                owner, radius, sigma)
    cnt = mask.sum(1).clamp_min(1)
    return pairsum.sums(per_pt[..., None], SUM_SPEC)[:, 0] / cnt


class ScoreStream:
    """Scoring of (object points, hypotheses) requests.

    ``submit`` queues a request and returns its index; requests are
    grouped by padded point count Pp, and every full slice of
    MAX_QUERIES_PER_LAUNCH // Pp hypotheses launches at once (the device
    runs it while the host prepares the next request). ``collect``
    launches the partial tails, waits, and returns one score array per
    request, in submission order.

    ``mesh``: an optional parallel.mesh.Mesh — every launch then splits
    its hypotheses over the mesh's slots (``score_multi_sharded``), with
    the slab and the object tables replicated. Slices are multiples of
    the slot count: full slices are rounded down to one (as the JAX
    package rounds them), partial tails are padded up to one with
    far-translated hypotheses, whose query blocks are near no tile.
    """

    def __init__(self, index: search.Index, radius: float, sigma: float,
                 mesh=None):
        self.index = index
        self.radius = radius
        self.sigma = sigma
        self.mesh = mesh
        self._groups = {}   # Pp -> group state
        self._n_req = 0

    @staticmethod
    def _new_group() -> dict:
        return {"pts": [], "nrm": [], "mask": [], "table": None,
                "hyps": [], "owners": [], "req": [], "n_queued": 0,
                "launched": []}

    def _h_slice(self, pp: int) -> int:
        h = max(MAX_QUERIES_PER_LAUNCH // pp, 1)
        if self.mesh is not None:
            nd = self.mesh.size
            h = max((h // nd) * nd, nd)
        return h

    def _launch(self, g: dict, hyps: np.ndarray, owners: np.ndarray) -> None:
        dev = self.index.device
        if g["table"] is None:
            g["table"] = tuple(torch.from_numpy(np.stack(g[k])).to(dev)
                               for k in ("pts", "nrm", "mask"))
        if self.mesh is None:
            g["launched"].append((len(hyps), _score_multi(
                self.index, *g["table"], torch.from_numpy(hyps).to(dev),
                torch.from_numpy(owners).to(dev), self.radius, self.sigma)))
            return
        from ..parallel import mesh as pmesh
        nd = self.mesh.size
        hp = -(-len(hyps) // nd) * nd
        mats = np.tile(np.eye(4, dtype=np.float32), (hp, 1, 1))
        mats[:, :3, 3] = 2 * gnn.FAR
        mats[:len(hyps)] = hyps
        own = np.zeros(hp, np.int64)
        own[:len(owners)] = owners
        g["launched"].append((len(hyps), pmesh.score_multi_sharded(
            self.mesh, self.index, *g["table"], mats, own, self.radius,
            self.sigma)))

    def _read(self, launched) -> torch.Tensor:
        return launched if self.mesh is None else self.mesh.gather(launched)

    def _drain(self, g: dict, pp: int, full_only: bool) -> None:
        h_slice = self._h_slice(pp)
        if not g["n_queued"] or (full_only and g["n_queued"] < h_slice):
            return
        hyps = np.concatenate(g["hyps"])
        owners = np.concatenate(g["owners"])
        n_fire = len(hyps) if not full_only else \
            (len(hyps) // h_slice) * h_slice
        for s in range(0, n_fire, h_slice):
            e = min(s + h_slice, n_fire)
            self._launch(g, hyps[s:e], owners[s:e])
        g["hyps"], g["owners"] = [hyps[n_fire:]], [owners[n_fire:]]
        g["n_queued"] = len(hyps) - n_fire

    def submit(self, obj_pts: np.ndarray, obj_nrm: np.ndarray,
               hyps: np.ndarray, prepped=None) -> int:
        """Queue one request; ``prepped`` optionally carries a cached
        prep_points(obj_pts, obj_nrm) result."""
        pts, nrm, mask = prepped if prepped is not None else \
            prep_points(obj_pts, obj_nrm)
        pp = len(pts)
        g = self._groups.setdefault(pp, self._new_group())
        slot = len(g["pts"])
        g["pts"].append(pts)
        g["nrm"].append(nrm)
        g["mask"].append(mask)
        g["table"] = None
        h = np.asarray(hyps, np.float32).reshape(-1, 4, 4)
        g["hyps"].append(h)
        g["owners"].append(np.full(len(h), slot, np.int64))
        g["req"].append((self._n_req, len(h)))
        g["n_queued"] += len(h)
        self._n_req += 1
        self._drain(g, pp, full_only=True)
        return self._n_req - 1

    def collect(self) -> List[np.ndarray]:
        """Launch the partial tails and gather all scores."""
        results: List[np.ndarray] = [np.zeros(0, np.float32)] * self._n_req
        for pp, g in sorted(self._groups.items()):
            self._drain(g, pp, full_only=False)
            scores = (torch.cat([self._read(r)[:n] for n, r in
                                 g["launched"]]).cpu().numpy()
                      if g["launched"] else np.zeros(0, np.float32))
            offset = 0
            for req_idx, n_h in g["req"]:
                results[req_idx] = scores[offset:offset + n_h]
                offset += n_h
        self._groups = {}
        self._n_req = 0
        return results


def score_requests(index: search.Index,
                   requests: Sequence[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]],
                   radius, sigma, mesh=None) -> List[np.ndarray]:
    """Score a batch of (obj_pts, obj_nrm, hyps) requests; returns one
    (H_i,) score array per request."""
    stream = ScoreStream(index, radius, sigma, mesh=mesh)
    for pts, nrm, hyps in requests:
        stream.submit(pts, nrm, hyps)
    return stream.collect()


def grid_search_hypotheses(bbox_min: np.ndarray, bbox_max: np.ndarray,
                           spacing: float = config.GRID_SEARCH_SPACING,
                           n_angles: int = config.GRID_SEARCH_N_ANGLES
                           ) -> tuple[np.ndarray, np.ndarray, int]:
    """Generate the (x, z, theta) hypothesis lattice over the scene bbox.

    Replicates the reference's f32 accumulation loops
    (pose_proposal.cpp:213-222): ox from -spacing while < length + spacing,
    angles from 0 while < 2*pi, each accumulated in float32.

    Returns (hyps (H,4,4) f32, cell_of_hyp (H,) int — which (ox,oz) cell
    each hypothesis belongs to, n_cells).
    """
    length_x = np.float32(bbox_max[0]) - np.float32(bbox_min[0])
    length_z = np.float32(bbox_max[2]) - np.float32(bbox_min[2])
    sp = np.float32(spacing)

    def f32_range(limit):
        vals = []
        v = np.float32(-sp)
        while v < limit:
            vals.append(v)
            v = np.float32(v + sp)
        return np.array(vals, dtype=np.float32)

    oxs = f32_range(np.float32(length_x + sp))
    ozs = f32_range(np.float32(length_z + sp))
    inc = np.float32(2.0 * np.pi / n_angles)
    angles = []
    a = np.float32(0.0)
    while a < np.float32(2.0 * np.pi):
        angles.append(a)
        a = np.float32(a + inc)
    angles = np.array(angles, dtype=np.float32)

    n_cells = len(oxs) * len(ozs)
    ca, sa = np.cos(angles), np.sin(angles)
    # rotation about +Y (msh_rotate with (0,1,0), pose_proposal.cpp:221)
    rots = np.zeros((len(angles), 4, 4), dtype=np.float32)
    rots[:, 0, 0] = ca
    rots[:, 0, 2] = sa
    rots[:, 2, 0] = -sa
    rots[:, 2, 2] = ca
    rots[:, 1, 1] = 1
    rots[:, 3, 3] = 1

    ox_g, oz_g = np.meshgrid(oxs, ozs, indexing="ij")
    tx = (np.float32(bbox_min[0]) + ox_g.ravel()).astype(np.float32)
    tz = (np.float32(bbox_min[2]) + oz_g.ravel()).astype(np.float32)

    hyps = np.tile(rots[None, :, :, :], (n_cells, 1, 1, 1))
    hyps[:, :, 0, 3] = tx[:, None]
    hyps[:, :, 1, 3] = 0.0
    hyps[:, :, 2, 3] = tz[:, None]
    cell_of_hyp = np.repeat(np.arange(n_cells), len(angles))
    return hyps.reshape(-1, 4, 4), cell_of_hyp, n_cells
