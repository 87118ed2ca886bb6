"""Dense distance field over a scene — the port of
rescan_tpu/ops/distance_field.py.

A voxel grid of distance-to-nearest-scene-point, built by chamfer sweeps
over the occupied cells and looked up per point; the viewer's
``--df_slice_y`` debug slice is its one consumer. The grid lives on the
device. Each sweep step is one plane's ``minimum(plane, previous plane +
voxel)``, the f32 adds of the reference in the reference's order, so the
field is equal to it bit for bit (a cumulative-min rewrite would round
otherwise).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import count_if_cpu, resolve_device
from ..utils import timing


def _as_f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, dtype=torch.float32).to(dev)


def _cell(pts: torch.Tensor, origin: np.ndarray, voxel) -> torch.Tensor:
    """floor((pts - origin) / voxel) in f32, as int64. The divisor is a
    device tensor: a CUDA tensor divided by a Python scalar is multiplied
    by its reciprocal instead."""
    o = torch.from_numpy(np.asarray(origin, np.float32)).to(pts.device)
    v = torch.tensor(np.float32(voxel), device=pts.device)
    return torch.floor((pts - o) / v).long()


@dataclasses.dataclass
class DistanceField:
    origin: np.ndarray        # (3,) float32
    voxel: float
    dist: torch.Tensor        # (nx, ny, nz) float32 distances, on the device

    def lookup(self, pts) -> torch.Tensor:
        """Nearest-surface distance for each point (out-of-grid -> +inf),
        on the field's device."""
        dev = self.dist.device
        count_if_cpu("distance_field.lookup", dev)
        c = _cell(_as_f32(pts, dev), self.origin, self.voxel)
        res = torch.tensor(self.dist.shape, device=dev)
        inb = ((c >= 0) & (c < res[None, :])).all(dim=1)
        cc = c[inb]
        out = torch.full((len(c),), float("inf"), dtype=torch.float32,
                         device=dev)
        out[inb] = self.dist[cc[:, 0], cc[:, 1], cc[:, 2]]
        return out


def build_distance_field(points, voxel: float = 0.05, max_dist: float = 1.0,
                         device=None) -> DistanceField:
    """Chamfer-swept voxel distance field (two-pass 3D chamfer transform;
    error vs exact Euclidean is bounded by ~8% of the distance, fine for
    culling decisions at 0.6 m scales), on ``device``."""
    dev = resolve_device(device)
    count_if_cpu("distance_field.build_distance_field", dev)
    pts = _as_f32(points, dev)
    pad = int(np.ceil(max_dist / voxel)) + 1
    lo = timing.to_host(pts.min(dim=0).values)
    hi = timing.to_host(pts.max(dim=0).values)
    origin = lo - pad * voxel
    res = (np.ceil((hi - origin) / voxel).astype(np.int64) + pad + 1)
    dist = torch.full(tuple(int(r) for r in res), 1e9, dtype=torch.float32,
                      device=dev)
    c = _cell(pts, origin, voxel)
    dist[c[:, 0], c[:, 1], c[:, 2]] = 0.0

    # chamfer sweeps: forward and backward passes along each axis,
    # iterated; weights voxel (axis), sqrt2*voxel implied by repetition
    w = float(np.float32(voxel))
    for _ in range(2):
        for ax in range(3):
            d = dist.movedim(ax, 0)
            n = d.shape[0]
            for i in range(1, n):
                torch.minimum(d[i], d[i - 1] + w, out=d[i])
            for i in range(n - 2, -1, -1):
                torch.minimum(d[i], d[i + 1] + w, out=d[i])
    torch.minimum(dist, torch.tensor(max_dist + voxel, dtype=torch.float32,
                                     device=dev), out=dist)
    return DistanceField(origin=origin.astype(np.float32), voxel=voxel,
                         dist=dist)
