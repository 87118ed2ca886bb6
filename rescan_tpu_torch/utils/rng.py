"""PCG32 generator matching the reference's ``msh_rand_*`` semantics.

The reference pipeline is deterministic because every stochastic component
seeds a local PCG32 generator with a fixed constant (SURVEY.md §4). We
reproduce the same generator (seeding: lib/msh/msh_std.h:1434-1443, step:
:1447-1456, float mapping: :1412-1421) so that host-side sampling steps
(mesh resampling, merge shuffles, RANSAC sampling) can be made sample-exact
with the reference when useful for oracle testing. Device-side algorithms
use ``jax.random`` instead; parity there is gated on metrics, not bits.
"""

from __future__ import annotations

import numpy as np

_MUL = 0x5851F42D4C957F2D
_M1 = 0xFF51AFD7ED558CCD
_M2 = 0xC4CEB9FE1A85EC53
_MASK64 = 0xFFFFFFFFFFFFFFFF
_MASK32 = 0xFFFFFFFF


def _murmur3_avalanche64(h: int) -> int:
    h &= _MASK64
    h ^= h >> 33
    h = (h * _M1) & _MASK64
    h ^= h >> 33
    h = (h * _M2) & _MASK64
    h ^= h >> 33
    return h


class MshRand:
    """Bit-exact replica of msh_rand (PCG32 with Gustavsson seeding).
    Pure Python integer arithmetic — called per SA iteration, so the
    numpy-scalar version's ~7 us/draw overhead matters."""

    __slots__ = ("state", "inc")

    def __init__(self, seed: int):
        value = _murmur3_avalanche64(((seed & _MASK32) << 1) | 1)
        self.state = 0
        self.inc = ((value << 1) & _MASK64) | 1
        self.next_u32()
        self.state = (self.state + _murmur3_avalanche64(value)) & _MASK64
        self.next_u32()

    def next_u32(self) -> int:
        old = self.state
        self.state = (old * _MUL + self.inc) & _MASK64
        xorshifted = (((old >> 18) ^ old) >> 27) & _MASK32
        rot = old >> 59
        return ((xorshifted >> rot)
                | (xorshifted << ((-rot) & 31))) & _MASK32

    def next_f32(self) -> float:
        # float in [0, 1): bitcast(127 << 23 | value >> 9) - 1.0
        # (msh_std.h:1412-1421). The bitcast yields 1.0 + m * 2^-23 with a
        # 23-bit mantissa m — exact in f32 AND f64, so the quotient below
        # is bit-identical to the reference's bitcast-and-subtract.
        return (self.next_u32() >> 9) * (1.0 / 8388608.0)

    def next_range(self, lo: int, hi: int) -> int:
        # msh_rand_range (msh_std.h:1464-1470): inclusive range via float
        # scale. The reference multiplies in f32 — replicate that rounding
        # (an f64 product truncates differently for ~0.4% of draws at
        # 1e5-sized ranges), keeping this stream bit-exact with both the
        # reference and the native rescan_ransac_triplets sampler.
        rng = (hi - lo) + 1
        if rng <= 0:
            return lo
        return lo + int(np.float32(self.next_f32()) * np.float32(rng))


class MshDiscreteDistribution:
    """Alias-method sampler replicating msh_discrete_distrib_t
    (lib/msh/msh_std.h:1863-1942) including its table construction order.
    Table construction runs in the native host library when available
    (bit-exact same stack order/f64 arithmetic; RANSAC rebuilds the table
    every round over ~10^5 weights)."""

    def __init__(self, weights: np.ndarray, seed: int):
        weights = np.asarray(weights, dtype=np.float64)
        n = len(weights)
        self.rand = MshRand(seed)
        self.n = n
        try:
            from ..core import native
            self.prob, self.alias = native.alias_build(weights)
            return
        except Exception:
            pass
        total = weights.sum()
        pdf = (weights / total) if total > 1e-8 else np.zeros(n)
        pdf = list(pdf)
        avg = 1.0 / n
        prob = np.ones(n, dtype=np.float64)
        alias = np.zeros(n, dtype=np.int64)
        small, large = [], []
        for i in range(n):
            (large if pdf[i] >= avg else small).append(i)
        while small and large:
            l = small.pop()
            g = large.pop()
            prob[l] = pdf[l] * n
            alias[l] = g
            pdf[g] = (pdf[g] + pdf[l]) - avg
            (large if pdf[g] >= avg else small).append(g)
        # remaining entries keep prob 1.0 (initialized above)
        self.prob = prob
        self.alias = alias

    def sample(self) -> int:
        col = self.rand.next_range(0, self.n - 1)
        coin = self.rand.next_f32() < self.prob[col]
        return int(col if coin else self.alias[col])


def distrib2pdf(dist: np.ndarray) -> np.ndarray:
    """msh_distrib2pdf (msh_std.h:1843-1849): normalize, no-op if sum ~ 0."""
    dist = np.asarray(dist, dtype=np.float64)
    s = dist.sum()
    if s <= 1e-8:
        return dist.copy()
    return dist / s


def pdfsample_linear(pdf: np.ndarray, prob: float) -> int:
    """msh_pdfsample_linear (msh_std.h:1967-1977): linear CDF walk."""
    idx = 0
    n = len(pdf)
    while idx < n and prob > pdf[idx]:
        prob -= pdf[idx]
        idx += 1
    return idx
