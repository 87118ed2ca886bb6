"""Sums whose rounding does not depend on the batch around them.

A library reduction or batched matrix product picks its kernel, and so
its order of additions, by the whole tensor's shape: one pair's ICP sums
or one hypothesis's score would change with the number of pairs or
hypotheses launched beside it. On an NVIDIA H100 80GB HBM3 (700 W), a
row's ``sum(1)`` over 4,096 entries changes in its last bits between a
batch of 56 rows and one of 14, the ICP's 6x6 ``einsum`` normal matrix
between a batch of 56 and one of 1, and a 4x4 ``bmm`` likewise; the
functions here give the same bits in all three cases. A mesh splits
those batches, so the port sums with elementwise adds in a fixed order:
results then depend only on each row's own values, on any batch size
and any number of shards.
"""

from __future__ import annotations

import torch


def tree_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sum along ``dim`` as a pairwise tree of adjacent entries
    (zero-padded at odd lengths). The order depends only on the length
    summed, and a run of 2^k entries is a subtree: sums over 2^k equal
    shards of a 2^k-long axis, added by the same tree, are the whole
    axis's sum bit for bit."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        x = x[0::2] + x[1::2]
    return x[0]


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for batches of small matrices, as multiply-adds over the
    inner dimension in index order."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k, None] * b[..., None, k, :]
    return out
