"""The ICP's batched 6x6 solve (rescan_tpu/ops/icp.py:162,
``jnp.linalg.solve``) in the order of the LAPACK calls that jaxlib makes
on the CPU, so the port's step equals the JAX package's bit for bit.

``jnp.linalg.solve`` lowers to the custom calls ``lapack_sgetrf_ffi`` and
``lapack_strsm_ffi``, which jaxlib binds to scipy's OpenBLAS (0.3.30,
SkylakeX kernels here). For one 6x6 matrix those run (read back by
holding candidates to ``jnp.linalg.solve`` on thousands of random,
ill-conditioned and singular systems, cond up to 4e9:
tests/test_torch_lu6.py):

* sgetrf, left-looking column by column (OpenBLAS getf2). Column j:
  rows 1..j-1 of U are ``u_i - dot(L[i, :i], u[:i])`` with the dot in
  pairs, ``fma(x0, y0, x1*y1) + fma(x2, y2, x3*y3)`` (an odd last term
  added as a rounded product); rows j..5 are ``a_r - chain`` with the
  chain ``fma(L[r, k], u[k], acc)`` from 0 in k order (a gemv); the
  pivot is the first entry of largest magnitude; the rows swap; the
  column below the pivot is multiplied by the rounded reciprocal of the
  pivot (divided when the pivot is below FLT_MIN; left as it is when the
  pivot is 0).
* the permutation of b, then strsm lower unit-diagonal in blocks of rows
  [0, 4) and [4, 6): a block first subtracts the chain of its row
  against the solved rows before it, then solves in place with
  ``x_r = fma(-x_i, L[r, i], x_r)``;
* strsm upper in blocks [4, 6) then [0, 4), each solved bottom-up with
  ``x_i *= 1 / U[i, i]`` (the reciprocal rounded first) and the same
  fma updates above it.

``solve`` launches ``lu6_kernel`` (csrc/pairsum.cu, a warp per system,
lane r holding row r: the device function ``lu6_solve``, which the ICP
step's tail kernel runs too) on CUDA tensors and takes the plain
PyTorch version (``solve_ref``: elementwise torch ops and
``gnn._fma32``) on CPU tensors; the two give the same bits. Non-finite results stay as IEEE
gives them; the caller zeroes them as icp.py:163 does.
"""

from __future__ import annotations

import torch

from . import pairsum
from .gnn import _fma32

N = 6
# the strsm kernels' row blocks: forward, and backward (bottom first)
_LOWER_BLOCKS = ((0, 4), (4, 6))
_UPPER_BLOCKS = ((4, 6), (0, 4))
_TINY = float(torch.finfo(torch.float32).tiny)


def _chain(xs, ys, acc=None):
    """fma(xs[k], ys[k], acc) over k in order, from 0."""
    for x, y in zip(xs, ys):
        acc = x * y if acc is None else _fma32(x, y, acc)
    return acc


def _getf2_dot(x, y):
    """OpenBLAS's dot of length 1..4 as getf2 calls it."""
    n = len(x)
    acc = x[0] * y[0] if n == 1 else _fma32(x[0], y[0], x[1] * y[1])
    if n == 3:
        acc = acc + x[2] * y[2]
    elif n == 4:
        acc = acc + _fma32(x[2], y[2], x[3] * y[3])
    return acc


def lu(c: torch.Tensor):
    """(lu, ipiv) of a (B, 6, 6) float32 batch: L (unit, below the
    diagonal) and U packed as sgetrf returns them, and the 0-based pivot
    row of every step."""
    a = c.clone()
    bsz = a.shape[0]
    ar = torch.arange(bsz, device=a.device)
    ipiv = torch.zeros((bsz, N), dtype=torch.long, device=a.device)
    for j in range(N):
        for i in range(1, j):
            a[:, i, j] = a[:, i, j] - _getf2_dot(
                [a[:, i, k] for k in range(i)], [a[:, k, j] for k in range(i)])
        if j:
            acc = _chain([a[:, j:, k] for k in range(j)],
                         [a[:, k, j, None] for k in range(j)])
            a[:, j:, j] = a[:, j:, j] - acc
        jp = j + a[:, j:, j].abs().argmax(1)
        ipiv[:, j] = jp
        piv = a[ar, jp, j]
        nz = piv != 0
        row_j = a[:, j].clone()
        row_p = a[ar, jp].clone()
        a[:, j] = torch.where(nz[:, None], row_p, row_j)
        a[ar, jp] = torch.where(nz[:, None], row_j, row_p)
        if j + 1 < N:
            below = a[:, j + 1:, j]
            scaled = torch.where((piv.abs() >= _TINY)[:, None],
                                 below * (1.0 / piv)[:, None],
                                 below / piv[:, None])
            a[:, j + 1:, j] = torch.where(nz[:, None], scaled, below)
    return a, ipiv


def solve(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of c x = b for a (B, 6, 6) batch and (B, 6) right-hand sides,
    in float32, as ``jnp.linalg.solve`` computes it on the CPU."""
    if c.dtype != torch.float32 or b.dtype != torch.float32 or \
            c.shape[1:] != (N, N) or b.shape != c.shape[:2]:
        raise ValueError(f"lu6: want (B, 6, 6) and (B, 6) float32, got "
                         f"{tuple(c.shape)} {c.dtype}, {tuple(b.shape)}")
    if not c.is_cuda:
        pairsum._count(pairsum.PLAIN_CALLS, "lu6")
        return solve_ref(c, b)
    c, b = c.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    if len(x):
        pairsum.run("lu6", c.device, c.data_ptr(), b.data_ptr(),
                    x.data_ptr(), len(x))
    return x


def solve_ref(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch ``solve``."""
    a, ipiv = lu(c)
    bsz = a.shape[0]
    perm = torch.arange(N, device=a.device).repeat(bsz, 1)
    ar = torch.arange(bsz, device=a.device)
    for i in range(N):
        pi = perm[:, i].clone()
        pp = perm[ar, ipiv[:, i]].clone()
        perm[ar, ipiv[:, i]] = pi
        perm[:, i] = pp
    x = list(b.gather(1, perm).unbind(1))
    for s, e in _LOWER_BLOCKS:
        for r in range(s, e):
            if s:
                x[r] = x[r] - _chain([a[:, r, k] for k in range(s)], x[:s])
        for i in range(s, e):
            for r in range(i + 1, e):
                x[r] = _fma32(-x[i], a[:, r, i], x[r])
    inv = 1.0 / torch.diagonal(a, dim1=1, dim2=2)
    for s, e in _UPPER_BLOCKS:
        for r in range(s, e):
            if e < N:
                x[r] = x[r] - _chain([a[:, r, k] for k in range(e, N)],
                                     x[e:])
        for i in range(e - 1, s - 1, -1):
            x[i] = x[i] * inv[:, i]
            for r in range(s, i):
                x[r] = _fma32(-x[i], a[:, r, i], x[r])
    return torch.stack(x, 1)


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether two solutions are equal bit for bit, a NaN equal to any
    NaN (the card and the CPU make NaNs of other payloads)."""
    nan = torch.isnan(x)
    return bool(torch.equal(nan, torch.isnan(y)) and torch.equal(
        torch.where(nan, 0.0, x).view(torch.int32),
        torch.where(nan, 0.0, y).view(torch.int32)))
