"""The yardstick for kernels: the card's peaks and the bytes each kernel's
function must move.

A frozen copy of the byte count of ``chip_smoke._bound``: a gated
nearest-neighbour launch reads each query's position and normal (24 B)
and writes d2 and the normal's dot (8 B; with the neighbour's index, K2,
12 B), and reads each valid slab point's position and normal (24 B; K2
also its original index, 28 B). Padding and the kernel's own tables are
the kernel's choice, not the function's.
"""

from __future__ import annotations

# NVIDIA H100 SXM's HBM3 at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12

# the profiler's kernel names of each gated nearest-neighbour function
GNN_KERNELS = {"gated_min": "gnn_kernel<false", "nearest_gated":
               "gnn_kernel<true"}


def gnn_bytes(kind: str, queries: int, points: int) -> int:
    k2 = kind == "nearest_gated"
    return queries * (24 + (12 if k2 else 8)) + points * (28 if k2 else 24)


def gnn_bound_s(kind: str, queries: int, points: int) -> float:
    """The least time one launch could take: its bytes at HBM's rate."""
    return gnn_bytes(kind, queries, points) / HBM_BYTES_PER_S
