"""The yardstick for K1 over a set of slabs: the bytes of one search of
the whole index, whatever implements it.

``scanbench/kernels.py``'s byte rule: each query read (24 B) and written
(8 B) once a search, each valid index point read once (24 B). A search
over a set launches once a part with every query, so each part's launch
reads and writes the queries again; those rows (the program's
``gated_min_set_requeries`` count) are no part of the function's bytes.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from scanbench import kernels


def k1_bytes(launches: Iterable[Tuple[str, int, int]],
             requeries: int) -> int:
    """The bytes of the K1 searches behind ``launches`` (kind, queries,
    points), each part of a set one launch, less the ``requeries`` query
    rows that a set's later parts searched again."""
    total = sum(kernels.gnn_bytes(k, m, n) for k, m, n in launches
                if k == "gated_min")
    return total - requeries * kernels.gnn_bytes("gated_min", 1, 0)
