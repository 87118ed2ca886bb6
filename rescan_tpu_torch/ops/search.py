"""Spatial-index entry points — the port of rescan_tpu/ops/search.py.

The port has one engine, the Morton-sorted slab of ops/gnn.py; the JAX
package's HashGrid and DenseIndex engines are not ported. Every hot
query of the pipeline (scoring, ICP, label transfer) goes through
``nearest_gated`` or ``gated_min`` here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import gnn


def build_index(points: np.ndarray, normals: Optional[np.ndarray] = None,
                tile: int = gnn.SCENE_TILE, device=None) -> gnn.SortedSlab:
    """The slab of ``points`` (with their normals, zeros if absent) on
    ``device`` (cuda unless the CPU is named)."""
    nrm = (np.zeros_like(np.asarray(points, np.float32)) if normals is None
           else normals)
    return gnn.build_sorted_slab(points, nrm, tile=tile, device=device)


def nearest_gated(index: gnn.SortedSlab, q_pos: torch.Tensor,
                  q_nrm: torch.Tensor, radius, cos_gate,
                  use_abs_dot: bool = False):
    """(idx, d2, dot) of the nearest in-radius neighbour passing the normal
    gate; idx in original point order, -1 where none qualifies."""
    return gnn.nearest_gated(index, q_pos, q_nrm, radius, cos_gate,
                             use_abs_dot=use_abs_dot)


def gated_min(index: gnn.SortedSlab, q_pos: torch.Tensor,
              q_nrm: torch.Tensor, radius, cos_gate,
              use_abs_dot: bool = False):
    """(d2, dot, found) of the nearest in-radius gate-passing neighbour —
    the scoring query, which tracks no neighbour index."""
    d2, dot = gnn.gated_min(index, q_pos, q_nrm, radius, cos_gate,
                            use_abs_dot=use_abs_dot)
    return d2, dot, torch.isfinite(d2)


def index_arrays(index: gnn.SortedSlab) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points, normals) in original order, for correspondence gathers
    (at least one row, so a gather at index 0 stays valid)."""
    valid = index.perm >= 0
    rows = index.perm[valid].long()
    pts = index.slab[0:3, valid].T + index.center[None, :]
    nrm = index.slab[4:7, valid].T
    n = max(index.n_valid, 1)
    out_p = pts.new_zeros(n, 3)
    out_n = nrm.new_zeros(n, 3)
    out_p[rows] = pts
    out_n[rows] = nrm
    return out_p, out_n
