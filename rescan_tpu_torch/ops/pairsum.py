"""Per-pair sums over points in the order the JAX package's compiled code
adds them: the ICP step's sums (rescan_tpu/ops/icp.py:122-185) and the
scoring mean (rescan_tpu/ops/score.py:168).

The orders below were read from XLA:CPU's optimised HLO and LLVM IR of
the jitted ``icp_align_indexed`` (B = 8 pairs x N = 1024 points, and the
bench launch's 64 x 4096), jax/jaxlib 0.9.0 on an AVX-512 Xeon, and each
was then held bit for bit to the JAX function on random rows
(tests/test_torch_pairsum.py). XLA:CPU contracts a multiply feeding an
add into one fused multiply-add wherever both sit in one emitted loop
(its LLVM target allows FP-op fusion), so several of them are FMAs.

Sums (what this module computes; one row per pair, one column per
quantity):

* ``jnp.sum(x, axis=1)`` (icp.py:132 the ok count, :135 the sum of d2,
  :136-137 the squared deviations, :142 w; score.py:168): XLA's
  tree-reduction rewriter cuts the axis into windows of 32 consecutive
  entries (a reduce-window) and reduces the window sums, again while more
  than 32 remain; every window and the last reduce add left to right
  from 0. ``WINDOW``.
* the einsums that lower to XLA's column-major gemv, one chain over n in
  index order, ``acc = fma(a[n], b[n], acc)`` from 0 (``CHAIN``):
  ``bn,bni->bi`` (c1, c2: icp.py:146-147); ``bn,bni,bn->bi`` (b, :157:
  XLA forms ``w * j6`` first, rounded, and chains ``ddn`` against it);
  ``bn,bn->b`` (the error, :165: ``w`` against ``ddn * ddn``, rounded).
* the three-operand ``bn,bni,bnj->bij`` (C, :156): ``w * j6[i]`` first,
  rounded, then a dot with ``j6[j]`` that XLA hands to Eigen's matrix
  product: one FMA chain per block of consecutive points (blocks of 256
  up to N = 2048; of 296 at 4096 and 8192, the last two blocks of equal
  length), the block sums added left to right; from 16384 points Eigen
  cuts the axis into 8 slices (one per thread of XLA's pool), each summed
  in blocks of its own, and adds the slices in two ranges of 4, each a
  pairwise tree ``(s0 + s1) + (s2 + s3)``, the ranges left to right
  (``BLOCKED``). Eigen adds those ranges with 16-lane packets over the
  36-entry output and the 4 entries past the last whole packet (C[5, 2:])
  one by one, as ``s0 + ((s1 + s2) + s3)`` (``BLOCKED_TAIL``). Any n has
  an order (``blocked_ends``); it was read at powers of two, the sizes
  ``pad_batch`` makes, up to 262144 points.
* a launch of one pair (the segment-transfer augmentation's ICP,
  segment_transfer.py:204-209): the batch dimension folds away and the
  two-operand einsums fuse into loops that LLVM vectorizes, 4 x 8 lanes,
  the lanes added ((v1 + v0) + v2) + v3 and halved three times, with a
  32-point scalar tail where an operand is read with a stride (``LANES``,
  ``LANES_TAIL``), up to 2048 points; from 4096 points one ``CHAIN``
  again (``single_pair_kind``).

These are XLA:CPU's orders on this host (8 threads): Eigen's blocking
follows its cache sizes and thread count, LLVM's vectorization the CPU.

Elementwise orders of the same step, which ops/icp.py forms with
``fma_chains`` below:

* ``R @ p + t`` and ``R @ n`` (icp.py:101-102): per output
  ``fma(R[i,2], p2, fma(R[i,1], p1, R[i,0] * p0))``, then ``+ t``.
* ``jnp.cross(p, n2)`` (:151): ``fma(a, b, -(c * d))`` for ``a*b - c*d``.
* ``ddn`` (:152): ``(d0*n0 + d1*n1) + d2*n2``, no FMA.
* ``jnp.trace`` (:160): the 36 entries masked by the identity added
  row by row from 0, i.e. ``C00 + C11 + ... + C55`` left to right; the
  damping ``1e-6 * tr / 6`` is folded by XLA into ``tr * 1.66666666e-07``,
  then ``+ 1e-20``.
* ``_rotation_xyz`` (:40-58): ``cos``/``sin`` of each angle, then
  ``(Rx @ Ry) @ Rz``, and ``R @ c1`` (:173), ``upd @ T`` (:177), each an
  FMA chain over the inner index from the first product (in the step's
  tail kernel, ``ops/icp.py`` ``_icp_tail``; both transforms in one
  ``fma_chains`` launch). XLA's f32 ``cos``/``sin`` are glibc's, which
  ``ops/xla_math.py`` replays.

The 6x6 solve's order is in ``ops/lu6.py``.

A sum runs as a sequence of accumulators, one per level: level 0 takes
``fma(a[n], b[n], acc)`` point by point; where a segment of level k ends
(a window of 32, a block), its sum is added into level k + 1 and level k
restarts from 0. ``_depths_np`` gives, per point, how many levels end
there, so the kernel and the plain version share one description. The
levels are a state that a caller can carry: a pair's points split over
shards in order (parallel/mesh.py, the sp mode) give the whole axis's
sum when each shard continues from the previous shard's state.

Dispatch is on the points' device: CUDA tensors launch the hand-written
kernel in ``csrc/pairsum.cu`` (built with nvcc at first use into
``rescan_tpu_torch/_build/``, bound with ctypes, ``-fmad=false`` and
``__fmaf_rn``), CPU tensors take the plain PyTorch version
(``pairsum_ref``), which is bit-identical to it. The kernel runs one CTA
per pair over tiles of its points, each piece of a segment one thread's
chain; it reads the same description of the orders (``_tiles`` and
``_folds``, built from ``_depths_np`` and ``fold_order``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

from ..utils import timing
from . import gnn

(WINDOW, CHAIN, BLOCKED, BLOCKED_TAIL, LANES, LANES_TAIL, FOLDED,
 FOLDED_TAIL) = range(8)
# kinds that run as one sequential chain with segment ends; the LANES
# kinds keep 32 lanes over runs of points; the FOLDED kinds sum the whole
# axis in one call
KINDS = (WINDOW, CHAIN, BLOCKED, BLOCKED_TAIL)
LANE_KINDS = (LANES, LANES_TAIL)
FOLD_KINDS = (FOLDED, FOLDED_TAIL)
LANE_COUNT = 32     # 4 interleaved vectors of 8 lanes
LANE_TAIL = 32      # points summed one by one after the lanes
FOLD_WIDTH = 8      # a FOLDED sum's lanes: one vector of 8
WINDOW_SIZE = 32
# accumulator levels of a chained kind's state: WINDOW needs one per
# window level (32^3 points < N <= 32^4 take four); BLOCKED beyond 8192
# points five (block, slice, and the three levels of the slices' tree)
LEVELS = 5
MAX_POINTS = WINDOW_SIZE ** LEVELS
# a state's width: a LANES sum keeps its 32 lanes and, once they are
# added, its running total at LANE_TOTAL
LANE_TOTAL = LANE_COUNT
STATE = 36
# a FOLDED sum's points, at most (one tile of the kernel)
FOLD_MAX = 256
# second operand "the constant 1": the entry itself is summed
ONE = -1

# the library's kernels: the sums, the fma chains, ops/lu6.py's solve,
# ops/xla_math.py's functions, ops/score.py's per-point terms, the ICP
# step's head and tail (ops/icp.py ``_icp_head``, ``_icp_tail``)
KERNELS = ("pairsum", "fma", "lu6", "xla_math", "score_terms", "icp_head",
           "icp_tail")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        for counts in (LAUNCHES, PLAIN_CALLS):
            for name in counts:
                counts[name] = 0


def _count(counts: dict, name: str = "pairsum") -> None:
    with _count_lock:
        counts[name] += 1


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def window_sizes(n: int) -> list:
    """Entries at each level of a WINDOW sum over n points: n, then the
    window sums while more than WINDOW_SIZE remain."""
    sizes = [n]
    while sizes[-1] > WINDOW_SIZE:
        sizes.append(-(-sizes[-1] // WINDOW_SIZE))
    return sizes


# Beyond 8192 points XLA's Eigen contraction shards the point axis over
# the threads of its pool (8 on the host the orders were read on): slices
# of ceil(n / 8) rounded up to 8 points, so always 8 slices there, the
# last one shorter where 64 does not divide n
SLICES = 8
# Eigen's gebp k-blocking inside a slice: at most 320 points per block,
# shortened so the last block is as long as it can be (its
# evaluateProductBlockingSizesHeuristic, k_peeling 8)
_MAX_KC, _K_PEEL = 320, 8
# the slices' partial sums are added in two ranges of 4, each range as a
# tree, the ranges left to right
_RANGE = 4


def _slices(n: int) -> list:
    """Start of every slice of a sharded BLOCKED sum over n > 8192."""
    per_thread = -(-n // SLICES)
    return list(range(0, n, -(-per_thread // 8) * 8))


def _slice_kc(m: int) -> int:
    if m <= _MAX_KC or m % _MAX_KC == 0:
        return min(m, _MAX_KC)
    return _MAX_KC - _K_PEEL * ((_MAX_KC - 1 - m % _MAX_KC)
                                // (_K_PEEL * (m // _MAX_KC + 1)))


def blocked_ends(n: int) -> list:
    """End index of every k-block of a BLOCKED sum over n points (each
    block one FMA chain; read from 128 to 8192 points, and Eigen's rule
    above beyond, checked against XLA up to 262144 points)."""
    if n <= 256:
        return [n]
    if n <= 2048:
        kc = 256
        return list(range(kc, n, kc)) + [n]
    if n <= 8192:
        kc = 296
        full = n // kc - 1
        rest = n - full * kc
        return [kc * (k + 1) for k in range(full)] + [full * kc + rest // 2,
                                                      n]
    starts = _slices(n)
    ends = []
    for s, e in zip(starts, starts[1:] + [n]):
        kc = _slice_kc(e - s)
        ends += list(range(s + kc, e, kc)) + [e]
    return ends


def _blocked_depth(n: int, end: int, tail: bool) -> int:
    """The levels a BLOCKED sum closes at a block ending at ``end``: its
    block (into the running sum of blocks, level 1); beyond 8192 points
    also, at a slice's end, the slice into its range of 4 (levels 2 and 3:
    ((s0 + s1) + (s2 + s3)), or for BLOCKED_TAIL s0 + ((s1 + s2) + s3),
    s0 parked at level 3), and at a range's end the range into the total
    (level 4)."""
    if n <= 8192:
        return 1
    starts = _slices(n)
    if end != n and end not in starts:
        return 1
    k = (starts.index(end) if end != n else len(starts)) - 1
    last = k % _RANGE == _RANGE - 1
    if tail:
        return 4 if last else 3 if k % _RANGE == 0 else 2
    return 2 + (k % 2 == 1) + last


def single_pair_kind(n: int, tail: bool) -> int:
    """The kind of a two-operand einsum over n points when XLA's batch is
    one pair: the batch dimension folds away and the dot fuses into a
    loop that LLVM vectorizes, with a 32-point scalar tail where an
    operand is read with a stride. Up to 256 points the loop is unrolled
    whole and LLVM's reassociation folds its four vectors into one
    (FOLDED: read at 128 and 256 points, ``fold_order``); from 512 to 2048
    points it keeps four (LANES); from 4096 on the dot leaves as one
    CHAIN (read at every power of two from 128 to 32768)."""
    if n >= 4096:
        return CHAIN
    if n >= 512:
        return LANES_TAIL if tail else LANES
    return FOLDED_TAIL if tail else FOLDED


def fold_order(n_vec: int) -> list:
    """The order in which a FOLDED sum's 8 lanes take the chunks of 8
    points of its first ``n_vec`` points (chunk c: points 8c .. 8c + 7,
    point 8c + l to lane l). XLA's loop holds 4 vectors over T = n_vec / 32
    iterations (chunk 4t + v); LLVM's reassociation of the unrolled loop
    chains vector 0's iterations in order, then each other vector's as
    t = 1, 0, 2, 3, ..., T - 1 (read from the object code and the sums'
    trees at T = 3, 4, 7 and 8)."""
    t_n = n_vec // LANE_COUNT
    ts = [1, 0] + list(range(2, t_n)) if t_n >= 2 else [0]
    return [4 * t for t in range(t_n)] + [4 * t + v for v in (1, 2, 3)
                                         for t in ts]


def top_level(kind: int, n: int) -> int:
    """The state entry that holds the total after n points."""
    if kind == WINDOW:
        return len(window_sizes(n)) - 1
    if kind in LANE_KINDS + FOLD_KINDS:
        return LANE_TOTAL
    if kind in (BLOCKED, BLOCKED_TAIL):
        return 1 if n <= 8192 else 4
    return 0


@functools.lru_cache(maxsize=64)
def _depths_np(n: int) -> np.ndarray:
    """(4, n) int8: per chained kind and point, the levels that end after
    it."""
    out = np.zeros((len(KINDS), n), np.int8)
    sizes = window_sizes(n)
    for i in range(n):
        c, k, d = i + 1, 0, 0
        while k < len(sizes) - 1 and (c % WINDOW_SIZE == 0 or c == sizes[k]):
            d += 1
            c = -(-c // WINDOW_SIZE)
            k += 1
        out[WINDOW, i] = d
    if n > 0:
        for e in blocked_ends(n):
            out[BLOCKED, e - 1] = _blocked_depth(n, e, False)
            out[BLOCKED_TAIL, e - 1] = _blocked_depth(n, e, True)
    return out


def _spec_key(spec) -> tuple:
    """A hashable key of a spec: (Q, 3) rows (kind, a column, b column)."""
    if isinstance(spec, torch.Tensor):
        spec = spec.tolist()
    return tuple(tuple(int(v) for v in r) for r in np.asarray(
        spec, np.int64).reshape(-1, 3)) if not (
        isinstance(spec, (list, tuple)) and all(
            isinstance(r, tuple) for r in spec)) else tuple(spec)


@functools.lru_cache(maxsize=256)
def _spec_np(key: tuple) -> np.ndarray:
    s = np.asarray(key, np.int32).reshape(-1, 3)
    if len(s) and not np.isin(s[:, 0], KINDS + LANE_KINDS + FOLD_KINDS).all():
        raise ValueError(f"pairsum: unknown kind in {key}")
    return s


@functools.lru_cache(maxsize=256)
def _spec_on(key: tuple, device: str) -> torch.Tensor:
    return torch.from_numpy(_spec_np(key)).to(device)


def as_spec(spec) -> torch.Tensor:
    """(Q, 3) int32 rows (kind, a column, b column or ONE)."""
    return torch.from_numpy(_spec_np(_spec_key(spec)).copy())


def new_state(b: int, q: int, device) -> torch.Tensor:
    return torch.zeros((b, q, STATE), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=256)
def _tops_on(key: tuple, n_total: int, device: str) -> torch.Tensor:
    return torch.tensor([top_level(k, n_total) for k, _, _ in key],
                        dtype=torch.long).to(device)


def totals(state: torch.Tensor, spec, n_total: int) -> torch.Tensor:
    """(B, Q) sums held in a state after all n_total points (the levels'
    index on the state's device is cached: no copy from the host, which
    would wait on the card, after the first call)."""
    tops = _tops_on(_spec_key(spec), n_total, str(state.device))
    return state.gather(2, tops[None, :, None].expand(state.shape[0], -1,
                                                      1))[..., 0]


def _check(x: torch.Tensor, key: tuple, n0: int, n_total: int,
           state: Optional[torch.Tensor]):
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"pairsum: x must be (B, n, K) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, n, k = x.shape
    if state is not None and (state.shape != (b, len(key), STATE)
                              or state.dtype != torch.float32
                              or state.device != x.device):
        raise ValueError("pairsum: state does not match the sums")
    _check_points(key, k, n0, n, n_total)


@functools.lru_cache(maxsize=1024)
def _check_points(key: tuple, k: int, n0: int, n: int, n_total: int) -> None:
    spec = _spec_np(key)
    if not (0 <= n0 and n0 + n <= n_total):
        raise ValueError(f"pairsum: points {n0}..{n0 + n} outside "
                         f"0..{n_total}")
    if n_total > MAX_POINTS:
        raise ValueError(f"pairsum: {n_total} points > {MAX_POINTS}")
    if len(spec) and (spec[:, 1].max() >= k or spec[:, 1].min() < 0
                      or spec[:, 2].max() >= k or spec[:, 2].min() < ONE):
        raise ValueError(f"pairsum: spec columns outside 0..{k - 1}")
    if len(spec) and np.isin(spec[:, 0], LANE_KINDS).any():
        if (n0 % LANE_COUNT or n % LANE_COUNT or n_total % LANE_COUNT
                or n_total < LANE_COUNT + LANE_TAIL):
            raise ValueError(f"pairsum: LANES over points {n0}..{n0 + n} "
                             f"of {n_total}")
    if len(spec) and np.isin(spec[:, 0], FOLD_KINDS).any():
        if (n0 or n != n_total or n_total % LANE_COUNT
                or n_total < 2 * LANE_COUNT + LANE_TAIL
                or n_total > FOLD_MAX):
            raise ValueError(f"pairsum: FOLDED over points {n0}..{n0 + n} "
                             f"of {n_total}: the whole axis in one call, "
                             f"96..{FOLD_MAX} points")


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

# the 29 f64 mantissa bits below an f32 mantissa: a value whose low bits
# read 1000...0 lies halfway between two f32 neighbours
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _odd_sums(s: torch.Tensor) -> torch.Tensor:
    """Where an f64 sum rounded to f32 may miss the correctly rounded f32
    of the exact sum it stands for: it lies exactly halfway between two
    f32 (or below f32's normal range, where the halfway points lie
    elsewhere). Elsewhere the two roundings agree: a halfway point is an
    f64 value, and rounding to f64 never crosses one."""
    r = s.float()
    return ((s.view(torch.int64) & _LOW29) == _HALF29) | (
        (r.abs() < _F32_TINY) & (s != 0))


def _operands(x: torch.Tensor, spec: torch.Tensor):
    a = x[..., spec[:, 1].long()]                               # (B, n, Q)
    one = spec[:, 2] == ONE
    b = x[..., spec[:, 2].clamp_min(0).long()]
    b = torch.where(one.to(x.device), torch.ones_like(b), b)
    return a, b, bool(one.all())


def _chain(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor,
           additive: bool) -> torch.Tensor:
    """acc = fma(a[..., i, :], b[..., i, :], acc) for i in order along
    dim -2; a, b (..., m, Q), acc (..., Q)."""
    if a.shape[-2] == 0:
        return acc
    if additive:                      # fma(a, 1, acc) is the f32 sum
        for i in range(a.shape[-2]):
            acc = acc + a[..., i, :]
        return acc
    p = a.double() * b.double()       # exact
    # a step whose products are all zero leaves every accumulator as it is
    live = np.flatnonzero(timing.to_host(
        (p != 0).movedim(-2, 0).reshape(p.shape[-2], -1).any(1)))
    start = acc.double()
    # the f32 fma of each step as the f64 sum rounded to f32; where one of
    # those sums is odd (``_odd_sums``) the chain is redone with
    # gnn._fma32's round-to-odd at every step
    acc, sums = start, []
    for i in live:
        s = p[..., i, :] + acc
        acc = s.float().double()
        sums.append(s)
    if sums and bool(timing.to_host(_odd_sums(torch.stack(sums)).any())):
        acc = start
        for i in live:
            acc = gnn._sum_to_f32(p[..., i, :], acc).double()
    return acc.float()


def _lanes(a: torch.Tensor, b: torch.Tensor, st: torch.Tensor, n0: int,
           n_total: int, tail: int) -> torch.Tensor:
    """Points n0 .. n0 + n of a LANES sum of a, b (B, n, Q), continuing
    the state st (B, Q, STATE). Point i of the first n_total - tail goes
    to lane i % 32 in index order; after the last of them the four 8-lane
    vectors are added ((v1 + v0) + v2) + v3 and the 8 lanes halved three
    times; the last ``tail`` points are then chained on one by one."""
    bsz, n, q = a.shape
    v = n_total - tail
    lo, hi = n0, min(n0 + n, v)
    if hi > lo:
        m = (hi - lo) // LANE_COUNT
        lanes = _chain(
            a[:, :hi - lo].reshape(bsz, m, LANE_COUNT, q).transpose(1, 2),
            b[:, :hi - lo].reshape(bsz, m, LANE_COUNT, q).transpose(1, 2),
            st[..., :LANE_COUNT].transpose(1, 2), False)   # (B, 32, Q)
        st[..., :LANE_COUNT] = lanes.transpose(1, 2)
    if n0 + n < v or n == 0:
        return st
    if n0 < v:
        vec = st[..., :LANE_COUNT].reshape(bsz, q, 4, 8)
        r = vec[..., 1, :] + vec[..., 0, :]
        r = vec[..., 2, :] + r
        r = vec[..., 3, :] + r
        while r.shape[-1] > 1:
            h = r.shape[-1] // 2
            r = r[..., :h] + r[..., h:]
        st[..., LANE_TOTAL] = r[..., 0]
    t0 = max(v, n0) - n0
    st[..., LANE_TOTAL] = _chain(a[:, t0:], b[:, t0:], st[..., LANE_TOTAL],
                                 False)
    return st


def _folded(a: torch.Tensor, b: torch.Tensor, st: torch.Tensor,
            n_total: int, tail: int) -> torch.Tensor:
    """A FOLDED sum of a, b (B, n_total, Q) into the state st (B, Q,
    STATE): lane l chains its chunks' points 8c + l in ``fold_order``;
    the 8 lanes are halved three times into the total, and the last
    ``tail`` points chained on one by one."""
    v = n_total - tail
    order = torch.tensor(fold_order(v), dtype=torch.long, device=a.device)
    idx = order[None, :] * FOLD_WIDTH + torch.arange(
        FOLD_WIDTH, device=a.device)[:, None]                 # (8, 4T)
    lanes = _chain(a[:, idx], b[:, idx],
                   st[..., :FOLD_WIDTH].transpose(1, 2), False)  # (B, 8, Q)
    st[..., :FOLD_WIDTH] = lanes.transpose(1, 2)
    r = st[..., :FOLD_WIDTH]
    while r.shape[-1] > 1:
        h = r.shape[-1] // 2
        r = r[..., :h] + r[..., h:]
    st[..., LANE_TOTAL] = _chain(a[:, v:], b[:, v:], r[..., 0], False)
    return st


def _cascade(state: torch.Tensor, depth: int) -> torch.Tensor:
    for k in range(depth):
        state[..., k + 1] = state[..., k + 1] + state[..., k]
        state[..., k] = 0.0
    return state


def pairsum_ref(x: torch.Tensor, spec, n0: int = 0,
                n_total: Optional[int] = None,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch pairsum: the state after points n0 .. n0 + n of the
    sums ``spec`` over ``x`` (B, n, K), continuing ``state`` (zeros when
    None). Each group of quantities of one kind runs its level-0
    segments side by side and its segment ends in order."""
    _count(PLAIN_CALLS)
    key = _spec_key(spec)
    b_, n, _ = x.shape
    n_total = n if n_total is None else n_total
    _check(x, key, n0, n_total, state)
    spec = torch.from_numpy(_spec_np(key))
    out = new_state(b_, spec.shape[0], x.device) if state is None \
        else state.clone()
    if n == 0 or spec.shape[0] == 0:
        return out
    depths = _depths_np(n_total)[:, n0:n0 + n]
    for kind in LANE_KINDS:
        qi = torch.nonzero(spec[:, 0] == kind)[:, 0]
        if len(qi):
            a, b, _ = _operands(x, spec[qi])
            out[:, qi.to(x.device)] = _lanes(
                a, b, out[:, qi.to(x.device)], n0, n_total,
                LANE_TAIL if kind == LANES_TAIL else 0)
    for kind in FOLD_KINDS:
        qi = torch.nonzero(spec[:, 0] == kind)[:, 0]
        if len(qi):
            a, b, _ = _operands(x, spec[qi])
            out[:, qi.to(x.device)] = _folded(
                a, b, out[:, qi.to(x.device)], n_total,
                LANE_TAIL if kind == FOLDED_TAIL else 0)
    for kind in KINDS:
        qi = torch.nonzero(spec[:, 0] == kind)[:, 0]
        if len(qi) == 0:
            continue
        a, b, additive = _operands(x, spec[qi])
        st = out[:, qi.to(x.device)]
        # the segments of this run of points: up to each segment end, and
        # an open one after the last
        ends = np.flatnonzero(depths[kind]) + 1
        if len(ends) == 0 or ends[-1] < n:
            ends = np.append(ends, n)
        starts = np.concatenate([[0], ends[:-1]])
        lengths = ends - starts
        m = int(lengths.max())
        seg = len(starts)
        # (B, seg, m, Q): every segment padded with zero products
        pos = torch.as_tensor(starts[:, None] + np.arange(m)[None],
                              dtype=torch.long, device=x.device)
        valid = torch.as_tensor(np.arange(m)[None] < lengths[:, None],
                                device=x.device)
        pos = torch.where(valid, pos, 0)
        sa = torch.where(valid[None, :, :, None], a[:, pos], 0.0)
        sb = torch.where(valid[None, :, :, None], b[:, pos], 0.0)
        acc0 = torch.zeros((b_, seg, len(qi)), dtype=torch.float32,
                           device=x.device)
        acc0[:, 0] = st[..., 0]
        sums = _chain(sa, sb, acc0, additive)                  # (B, seg, Q)
        for s_i in range(seg):
            st[..., 0] = sums[:, s_i]
            st = _cascade(st, int(depths[kind][ends[s_i] - 1]))
        out[:, qi.to(x.device)] = st
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SRC = os.path.join(_CSRC, "pairsum.cu")
# what the library is built from: the source and the header it includes
_SOURCES = (_SRC, os.path.join(_CSRC, "xla_math.cuh"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""

# pairsum_kernel's two shapes (csrc/pairsum.cu BigSum, SmallSum): points
# staged per tile, columns per point, sums per launch, pieces of one
# chained sum per tile; the small one serves launches of a few sums over
# few columns (scoring's means, the ICP's first rounds)
SHAPES = {"big": (512, 16, 48, 18), "small": (256, 4, 4, 10)}


def _shape(k: int, q: int) -> str:
    _, max_k, max_q, _ = SHAPES["small"]
    return "small" if k <= max_k and q <= max_q else "big"


def load_library():
    """Build ``csrc/pairsum.cu`` into ``_build/`` (once per source and
    flag set) and load it. Raises with the compiler's stderr on
    failure."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for src in _SOURCES:
            with open(src, "rb") as f:
                h.update(f.read())
        out = os.path.join(gnn._BUILD_DIR, f"libpairsum-{h.hexdigest()[:12]}.so")
        # ptxas's -v report, kept beside the library it describes
        log = f"{out}.ptxas.txt"
        if not os.path.exists(out):
            nvcc = gnn.find_nvcc()
            os.makedirs(gnn._BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, _SRC],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"pairsum: nvcc failed ({r.returncode}):"
                                   f"\n{r.stderr}")
            with open(log, "w") as f:
                f.write(r.stderr)
            os.replace(tmp, out)
        if os.path.exists(log):
            with open(log) as f:
                BUILD_LOG = f.read()
        _lib = bind(ctypes.CDLL(out))
        return _lib


def bind(lib):
    """Declare the C signatures of the library's ``*_run`` functions and
    ``icp_head_info`` on a loaded library."""
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    for name, args in (
            ("pairsum", [vp, i32, i32, i32, vp, i32, vp, vp, i32, i32, vp,
                         i32]),
            ("fma", [vp]),
            ("lu6", [vp, vp, vp, i32]),
            ("xla_math", [i32, vp, vp, i64]),
            ("score_terms", [vp, vp, vp, vp, vp, i64, f32, f32, f32, f32]),
            ("icp_tail", [vp, i32, vp, i32, vp, vp, vp, vp, vp, vp, vp, vp,
                          i32, i32, f32, f32, f32, f32, f32]),
            ("icp_head", [i32, vp, vp, i64, i32, f32, f32, f32, f32]),
            ("empty", [])):
        fn = getattr(lib, f"{name}_run")
        fn.restype = ctypes.c_int
        fn.argtypes = args + [vp]
    lib.icp_head_info.restype = ctypes.c_int
    lib.icp_head_info.argtypes = [i32, ctypes.POINTER(i32)]
    return lib


def run(name: str, dev: torch.device, *args) -> None:
    """Call the library's ``<name>_run`` with ``args`` on ``dev``'s
    current stream, and count the launch (``empty``, the launch floor's
    kernel, is not counted)."""
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_run")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")
    if name in LAUNCHES:
        _count(LAUNCHES, name)


@functools.lru_cache(maxsize=256)
def _tiles_np(n_total: int, n0: int, n: int, shape: str) -> np.ndarray:
    """The kernel's view of ``_depths_np`` for points n0 .. n0 + n: per
    tile of the shape's points and chained kind, the count of its pieces
    (the parts of segments inside the tile), then each piece's end packed
    as end << 3 | push depth, -1 for an open last piece. Raises where a
    tile would hold more pieces than the shape takes."""
    tile, _, _, pieces_max = SHAPES[shape]
    d = _depths_np(n_total)
    n_tiles = -(-n // tile)
    out = np.full((n_tiles, len(KINDS), 1 + pieces_max), -1, np.int32)
    for kind in KINDS:
        ends = np.flatnonzero(d[kind][n0:n0 + n]) + n0
        packed = (ends << 3) | d[kind][ends]
        cuts = np.searchsorted(ends, n0 + np.arange(n_tiles + 1) * tile)
        for t in range(n_tiles):
            g1 = min(n0 + (t + 1) * tile, n0 + n)
            pieces = list(packed[cuts[t]:cuts[t + 1]])
            if not pieces or pieces[-1] >> 3 != g1 - 1:
                pieces.append(-1)
            if len(pieces) > pieces_max:
                raise ValueError(f"pairsum: {len(pieces)} pieces of kind "
                                 f"{kind} in a tile of points {n0}..{n0 + n}"
                                 f" of {n_total}, beyond {pieces_max}")
            out[t, kind, 0] = len(pieces)
            out[t, kind, 1:1 + len(pieces)] = pieces
    return out


@functools.lru_cache(maxsize=256)
def _tiles_cached(n_total: int, n0: int, n: int, shape: str,
                  device: str) -> torch.Tensor:
    return torch.from_numpy(_tiles_np(n_total, n0, n, shape)).to(device)


@functools.lru_cache(maxsize=64)
def _folds_np(n_total: int) -> np.ndarray:
    """The FOLDED and FOLDED_TAIL kinds' chunk orders over n_total points
    (``fold_order``), after a header of their two offsets; empty orders
    where n_total takes no FOLDED sum."""
    orders = [fold_order(n_total - t) if (
        n_total <= FOLD_MAX and n_total % LANE_COUNT == 0
        and n_total >= 2 * LANE_COUNT + t) else [] for t in (0, LANE_TAIL)]
    return np.asarray([2, 2 + len(orders[0])] + orders[0] + orders[1],
                      np.int32)


@functools.lru_cache(maxsize=64)
def _folds_cached(n_total: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_folds_np(n_total)).to(device)


def _launch(x: torch.Tensor, key: tuple, n0: int, n_total: int,
            state: Optional[torch.Tensor]) -> torch.Tensor:
    dev = x.device
    b_, n, k = x.shape
    q = len(key)
    shape = _shape(k, q)
    _, max_k, max_q, _ = SHAPES[shape]
    if k > max_k or q > max_q:
        raise ValueError(f"pairsum: {q} sums over {k} columns: beyond the "
                         f"kernel's {max_q} sums, {max_k} columns")
    x = x.contiguous()
    out = new_state(b_, q, dev) if state is None else state.clone()
    if n == 0 or q == 0 or b_ == 0:
        return out
    tiles = _tiles_cached(n_total, n0, n, shape, str(dev))
    run("pairsum", dev, x.data_ptr(), b_, n, k,
        _spec_on(key, str(dev)).data_ptr(), q, tiles.data_ptr(),
        _folds_cached(n_total, str(dev)).data_ptr(), n0, n_total,
        out.data_ptr(), shape == "small")
    return out


def pairsum(x: torch.Tensor, spec, n0: int = 0, n_total: Optional[int] = None,
            state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The state after points n0 .. n0 + n of the sums ``spec`` over
    ``x`` (B, n, K) float32, continuing ``state`` ((B, Q, STATE), zeros
    when None). ``spec``: (Q, 3) rows (kind, a column, b column or ONE);
    ``n_total``: the whole axis's length (n when None). ``totals`` reads
    the sums once every point is in."""
    n_total = x.shape[1] if n_total is None else n_total
    if x.is_cuda:
        key = _spec_key(spec)
        _check(x, key, n0, n_total, state)
        return _launch(x, key, n0, n_total, state)
    if x.device.type != "cpu":
        raise ValueError(f"pairsum: unsupported device {x.device}")
    return pairsum_ref(x, spec, n0, n_total, state)


def sums(x: torch.Tensor, spec) -> torch.Tensor:
    """(B, Q) sums ``spec`` over the whole point axis of ``x``."""
    return totals(pairsum(x, spec), spec, x.shape[1])


# ---------------------------------------------------------------------------
# Chains of fused multiply-adds
# ---------------------------------------------------------------------------

# fma_chain_kernel's descriptor (csrc/pairsum.cu FmaDesc), in int64 words:
# the index's 4 sizes, its total, the column count, then per column 3
# flags and 10 operands of (address, 4 strides)
DIMS, MAX_TERMS, MAX_COLS = 4, 4, 4
_OPERAND = 1 + DIMS
_COLUMN = 3 + (2 + 2 * MAX_TERMS) * _OPERAND
_DESC = DIMS + 2 + MAX_COLS * _COLUMN


class Chain:
    """One output of ``fma_chains``: the first term's product (negated
    where ``neg_first``), then fma(a, b, acc) for each further term (a, b)
    in order, then ``+ add`` rounded on its own. Operands are float32
    tensors that broadcast to the launch's shape."""

    def __init__(self, terms, neg_first: bool = False, add=None):
        self.terms = list(terms)
        self.neg_first, self.add = neg_first, add

    def plain(self, shape) -> torch.Tensor:
        terms = [(a.expand(shape), b.expand(shape)) for a, b in self.terms]
        a, b = terms.pop(0)
        acc = -(a * b) if self.neg_first else a * b
        for a, b in terms:
            acc = gnn._fma32(a, b, acc)
        return acc + self.add if self.add is not None else acc

    def operands(self) -> list:
        return [t for ab in self.terms for t in ab] + (
            [] if self.add is None else [self.add])


def _operand(desc: np.ndarray, at: int, t: torch.Tensor, shape) -> None:
    v = t.expand(shape)
    if any(st < 0 for st in v.stride()) or sum(
            (sz - 1) * st for sz, st in zip(shape, v.stride())) >= 1 << 32:
        raise ValueError("fma_chains: an operand reaches 2^32 entries")
    pad = DIMS - len(shape)
    desc[at] = v.data_ptr()
    desc[at + 1 + pad:at + 1 + DIMS] = v.stride()


def fma_chains(chains, shape, outs=None) -> list:
    """The outputs of ``chains`` (``Chain``s) over the broadcast index
    ``shape`` (at most 4 dimensions), into ``outs`` (tensors of that
    shape, views allowed) or new contiguous tensors: on CUDA operands one
    ``fma_chain_kernel`` launch for all of them, each operand read
    through its strides (a broadcast one is not copied); on CPU operands
    the plain chains (``gnn._fma32``, which equals it)."""
    shape = torch.Size(shape)
    ops = [t for c in chains for t in c.operands()]
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("fma_chains: operands must be float32")
    if not any(t.is_cuda for t in ops):
        _count(PLAIN_CALLS, "fma")
        got = [c.plain(shape) for c in chains]
        if outs is None:
            return got
        for o, g in zip(outs, got):
            o.copy_(g)
        return outs
    dev = ops[0].device
    if (len(shape) > DIMS or len(chains) > MAX_COLS
            or any(not 1 <= len(c.terms) <= MAX_TERMS for c in chains)
            or any(t.device != dev for t in ops)):
        raise ValueError(f"fma_chains: {len(chains)} chains over {shape} "
                         f"beyond the kernel's {MAX_COLS} chains of "
                         f"{MAX_TERMS} terms over {DIMS} dimensions, or "
                         f"operands on other devices")
    if outs is None:
        outs = [torch.empty(shape, dtype=torch.float32, device=dev)
                for _ in chains]
    elif any(o.shape != shape or o.device != dev or o.dtype != torch.float32
             for o in outs):
        raise ValueError("fma_chains: outputs must be float32 of the shape")
    if shape.numel():
        desc = fma_desc(chains, shape, outs)       # alive through the call
        run("fma", dev, desc.ctypes.data)
    return outs


def fma_desc(chains, shape, outs) -> np.ndarray:
    """fma_chain_kernel's descriptor of ``chains`` over ``shape``, into
    ``outs`` (float32 tensors of that shape)."""
    if shape.numel() >= 1 << 31:
        raise ValueError(f"fma_chains: {shape.numel()} entries >= 2^31")
    desc = np.zeros(_DESC, np.int64)
    desc[DIMS - len(shape):DIMS] = shape
    desc[:DIMS - len(shape)] = 1
    desc[DIMS] = shape.numel()
    desc[DIMS + 1] = len(chains)
    for j, (c, out) in enumerate(zip(chains, outs)):
        at = DIMS + 2 + j * _COLUMN
        desc[at:at + 3] = (len(c.terms), c.neg_first, c.add is not None)
        at += 3
        for t in (out, c.add):
            if t is not None:
                _operand(desc, at, t, shape)
            at += _OPERAND
        for a, b in c.terms:
            _operand(desc, at, a, shape)
            _operand(desc, at + MAX_TERMS * _OPERAND, b, shape)
            at += _OPERAND
    return desc

