"""Spatial-index entry points — the port of rescan_tpu/ops/search.py.

Three engines answer the gated nearest-neighbour query, as in the JAX
package:

* ``gnn.SortedSlab`` (ops/gnn.py) — the Morton-sorted slab, the port of
  the Pallas kernel; the default on every device, and past
  ``gnn.MAX_SLAB_COLS * 0.94`` points a ``gnn.SlabSet`` of such slabs;
* ``hashgrid.HashGrid`` (ops/hashgrid.py) — windowed candidate runs of a
  uniform grid, the JAX package's CPU engine (``prefer_dense=False``);
* ``dense_nn.DenseIndex`` (ops/dense_nn.py) — every point scanned;
  ``build_index`` builds none (neither does the JAX package's), but the
  queries dispatch on it.

Every hot query of the pipeline (scoring, ICP, label transfer) goes
through ``nearest_gated`` or ``gated_min`` here.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils import timing
from . import dense_nn, gnn, hashgrid

Index = Union[gnn.SortedSlab, gnn.SlabSet, hashgrid.HashGrid,
              dense_nn.DenseIndex]


def build_index(points: np.ndarray, cell: float,
                normals: Optional[np.ndarray] = None,
                prefer_dense: Optional[bool] = None,
                tile: int = gnn.SCENE_TILE, device=None) -> Index:
    """The index of ``points`` (with their normals, zeros if absent) on
    ``device`` (cuda unless the CPU is named). ``cell`` is the query
    radius the grid engine serves; the slab ignores it. ``prefer_dense``:
    None or True, the slab, or the set of slabs the JAX package splits
    it into past ``gnn.MAX_SLAB_COLS * 0.94`` points (the JAX package
    picks by backend; the port's card and CPU runs are held to its slab
    runs); False, the HashGrid."""
    if prefer_dense is False:
        return hashgrid.build_grid(points, cell, normals=normals,
                                   device=device)
    nrm = (np.zeros_like(np.asarray(points, np.float32)) if normals is None
           else normals)
    return gnn.build_sorted_slab(points, nrm, tile=tile, device=device)


def nearest_gated(index: Index, q_pos: torch.Tensor, q_nrm: torch.Tensor,
                  radius, cos_gate, use_abs_dot: bool = False):
    """(idx, d2, dot) of the nearest in-radius neighbour passing the normal
    gate; idx in original point order, -1 where none qualifies."""
    if isinstance(index, (gnn.SortedSlab, gnn.SlabSet)):
        return gnn.nearest_gated(index, q_pos, q_nrm, radius, cos_gate,
                                 use_abs_dot=use_abs_dot)
    if isinstance(index, dense_nn.DenseIndex):
        return dense_nn.nearest_gated_dense(index, q_pos, q_nrm, radius,
                                            cos_gate, use_abs_dot=use_abs_dot)
    return hashgrid.nearest_gated(index, q_pos, q_nrm, radius, cos_gate,
                                  use_abs_dot=use_abs_dot, chunk=2048)


def gated_min(index: Index, q_pos: torch.Tensor, q_nrm: torch.Tensor,
              radius, cos_gate, use_abs_dot: bool = False):
    """(d2, dot, found) of the nearest in-radius gate-passing neighbour —
    the scoring query, which on the slab tracks no neighbour index."""
    if isinstance(index, (gnn.SortedSlab, gnn.SlabSet)):
        d2, dot = gnn.gated_min(index, q_pos, q_nrm, radius, cos_gate,
                                use_abs_dot=use_abs_dot)
        return d2, dot, torch.isfinite(d2)
    idx, d2, dot = nearest_gated(index, q_pos, q_nrm, radius, cos_gate,
                                 use_abs_dot=use_abs_dot)
    return d2, dot, idx >= 0


def index_arrays(index: Index) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points, normals) in original order, for correspondence gathers
    (at least one row, so a gather at index 0 stays valid)."""
    if isinstance(index, hashgrid.HashGrid):
        return hashgrid.index_arrays(index)
    if isinstance(index, dense_nn.DenseIndex):
        return dense_nn.index_arrays(index)
    if isinstance(index, gnn.SlabSet):
        # each part's columns scattered back to their original rows;
        # padding columns (perm == -1) to a row past the end, dropped
        n = max(index.n_total, 1)
        s0 = index.slabs[0].slab
        out_p = s0.new_zeros(n + 1, 3)
        out_n = s0.new_zeros(n + 1, 3)
        for part in index.slabs:
            rows = torch.where(part.perm >= 0, part.perm, n).long()
            out_p[rows] = part.slab[0:3].T + part.center[None, :]
            out_n[rows] = part.slab[4:7].T
        return out_p[:n], out_n[:n]
    valid = index.perm >= 0
    # each boolean-mask gather waits for its count of rows
    with timing.host_wait(valid.device, n=3):
        rows = index.perm[valid].long()
        pts = index.slab[0:3, valid].T + index.center[None, :]
        nrm = index.slab[4:7, valid].T
    n = max(index.n_valid, 1)
    out_p = pts.new_zeros(n, 3)
    out_n = nrm.new_zeros(n, 3)
    out_p[rows] = pts
    out_n[rows] = nrm
    return out_p, out_n
