"""XLA:CPU's f32 ``exp``, ``arccos``, ``cos`` and ``sin``, computed as the
JAX package's compiled code computes them, so that the port's scores
(rescan_tpu/ops/score.py:160-166) and the ICP's rotation
(rescan_tpu/ops/icp.py:43-45) equal the JAX package's bit for bit.

What XLA:CPU runs (jax/jaxlib 0.9.0; read from the optimised HLO, the
LLVM IR and the object code of ``jax.jit(jnp.exp)`` etc. dumped with
``XLA_FLAGS=--xla_dump_to=DIR``, and from the disassembly of the host's
libm, glibc 2.36; then held bit for bit to ``jnp`` on millions of
arguments, tests/test_torch_xla_math.py):

* ``exp``: XLA's own vectorised polynomial (no libm call): the argument
  clamped to [-87.8, 88.8], ``n = floor(fma(x, log2e, 0.5))`` clamped to
  [-127, 127], ``r = fma(-n, C2, fma(-n, C1, x))``, a degree-5
  polynomial in Horner form of fused multiply-adds, ``fma(p, r*r, r) +
  1``, times ``2^n`` built from the exponent bits. XLA runs with
  denormals flushed to zero, so a result below FLT_MIN is 0.
* ``arccos``: CHLO's expansion ``atan2(sqrt((1 - x) * (1 + x)), x)``;
  the ``atan2`` is a call of libm's ``atan2f`` (glibc's fdlibm code:
  float arithmetic, no fused operations), whose ``atanf`` reduces the
  argument to one of five ranges and sums an 11-term odd polynomial.
* ``cos`` and ``sin``: calls of libm's ``cosf``/``sinf`` (glibc's, the
  variant built for CPUs with FMA): the argument in f64, reduced by
  pi/2 (below 120 by ``x - n * pi/2`` as one fused operation, beyond by
  the 2/pi bit table), a degree-4 polynomial in f64 with fused
  multiply-adds, rounded to f32 once.

Each function has a plain PyTorch version here (explicit float32 or
float64 steps; the fused operations of f32 through ``gnn._fma32``, of
f64 through ``_fma64``, both correctly rounded) and ``__device__``
functions in ``csrc/xla_math.cuh`` with the same steps
(``__fmaf_rn``, ``__fma_rn``, no ``expf``/``acosf``/``__cosf``), which
``csrc/pairsum.cu`` exposes as ``xla_math_kernel`` and uses in its
scoring pass and the ICP step's tail (``icp_tail_kernel``: the rotation's
cos and sin). ``exp``, ``acos`` and ``sincos`` launch that kernel on CUDA
tensors and take the plain version on CPU tensors; the two give the same
bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pairsum
from .gnn import _fma32

# xla_math_kernel's operations (csrc/pairsum.cu)
EXP, ACOS, SINCOS = range(3)

_I32 = torch.int32
_I64 = torch.int64


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# ---------------------------------------------------------------------------
# exp
# ---------------------------------------------------------------------------

_EXP_LO, _EXP_HI = _f32(0xc2af999a), _f32(0x42b1999a)     # -87.8, 88.8
_LOG2E = _f32(0x3fb8aa3b)
_EXP_C1, _EXP_C2 = _f32(0x3f318000), _f32(0xb95e8083)     # ln 2, hi + lo
_EXP_P = [_f32(b) for b in (0x39506967, 0x3ab743ce, 0x3c088908,
                            0x3d2aa9c1, 0x3e2aaaaa)]
_ONE_BITS = 0x3f800000                                     # 127 << 23


def exp_ref(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 exp, plain PyTorch."""
    x = x.float()
    # clamps that keep a NaN (fcmp uge / ule and a select)
    x = torch.where(x < _EXP_LO, _EXP_LO, x)
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    fx = torch.floor(_fma32(x, _c(x, _LOG2E), _c(x, 0.5)))
    fx = torch.where(fx < -127.0, -127.0, fx)
    fx = torch.where(fx > 127.0, 127.0, fx)
    r = _fma32(-fx, _c(x, _EXP_C1), x)
    r = _fma32(-fx, _c(x, _EXP_C2), r)
    y = _c(x, _EXP_P[0])
    for p in _EXP_P[1:] + [0.5]:
        y = _fma32(y, r, _c(x, p))
    y = _fma32(y, r * r, r) + 1.0
    n = torch.where(torch.isnan(fx), 0.0, fx).to(_I32)
    out = y * ((n << 23) + _ONE_BITS).view(torch.float32)
    # flush to zero: 2^-127 has no exponent bits, and y * 2^-126 is below
    # FLT_MIN exactly when y < 1
    return torch.where((n == -127) | ((n == -126) & (y < 1.0)), 0.0, out)


def _c(like: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(like, v)


# ---------------------------------------------------------------------------
# arccos = atan2f(sqrtf((1 - x) * (1 + x)), x), glibc's atan2f and atanf
# ---------------------------------------------------------------------------

_ATANHI = [_f32(b) for b in (0x3eed6338, 0x3f490fda, 0x3f7b985e,
                             0x3fc90fda)]
_ATANLO = [_f32(b) for b in (0x31ac3769, 0x33222168, 0x33140fb4,
                             0x33a22168)]
_AT = [_f32(b) for b in (0x3eaaaaab, 0xbe4ccccd, 0x3e124925, 0xbde38e38,
                         0x3dba2e6e, 0xbd9d8795, 0x3d886b35, 0xbd6ef16b,
                         0x3d4bda59, 0xbd15a221, 0x3c8569d7)]
_PI, _PI_O_2, _PI_O_4 = _f32(0x40490fdb), _f32(0x3fc90fdb), _f32(0x3f490fdb)
_PI_LO = _f32(0xb3bbbd2e)
_TINY = float(np.float32(1e-30))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(_I32)


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's atanf (fdlibm s_atanf.c), float arithmetic."""
    hx = _bits(x)
    ix = hx & 0x7fffffff
    ax = x.abs()
    one = 1.0
    # the reduced argument and its table entry (-1: none)
    r = torch.where(ix < 0x3f300000, (ax + ax - one) / (ax + 2.0),
                    (ax - one) / (ax + one))
    r = torch.where(ix < 0x3f980000, r, torch.where(
        ix < 0x401c0000, (ax - 1.5) / (ax * 1.5 + one), -one / ax))
    tid = torch.where(ix < 0x3f300000, 0, torch.where(
        ix < 0x3f980000, 1, torch.where(ix < 0x401c0000, 2, 3)))
    small = ix < 0x3ee00000
    r = torch.where(small, x, r)
    z = r * r
    w = z * z
    s1 = _c(x, _AT[10])
    for k in (8, 6, 4, 2, 0):
        s1 = s1 * w + _AT[k]
    s1 = s1 * z
    s2 = _c(x, _AT[9])
    for k in (7, 5, 3, 1):
        s2 = s2 * w + _AT[k]
    s2 = s2 * w
    t = r * (s1 + s2)
    hi = torch.tensor(_ATANHI, device=x.device)[tid]
    lo = torch.tensor(_ATANLO, device=x.device)[tid]
    big = hi - ((t - lo) - r)
    out = torch.where(small, x - t, torch.where(hx < 0, -big, big))
    out = torch.where(ix < 0x31000000, x, out)
    inf = _ATANHI[3] + _ATANLO[3]
    out = torch.where(ix >= 0x4c000000, torch.where(
        hx > 0, inf, -inf), out)
    return torch.where(ix > 0x7f800000, x + x, out)


def _atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's atan2f (fdlibm e_atan2f.c), float arithmetic."""
    hx, hy = _bits(x), _bits(y)
    ix, iy = hx & 0x7fffffff, hy & 0x7fffffff
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    k = (iy - ix) >> 23
    z = _atanf((y / x).abs())
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    z = torch.where(k > 60, _PI_O_2 + 0.5 * _PI_LO, z)
    pi_t = _c(x, _TINY) + _PI
    out = torch.where(m == 0, z, torch.where(
        m == 1, -z, torch.where(m == 2, _PI - (z - _PI_LO),
                                (z - _PI_LO) - _PI)))
    # y infinite, then x infinite, x zero, y zero (the later wins)
    half = _c(x, _TINY) + _PI_O_2
    out = torch.where(iy == 0x7f800000, torch.where(hy < 0, -half, half),
                      out)
    quarter = _c(x, _PI_O_4) + _TINY
    three = _c(x, 3.0) * _PI_O_4 + _TINY
    x_inf = torch.where(iy == 0x7f800000, torch.where(
        m == 0, quarter, torch.where(m == 1, -quarter, torch.where(
            m == 2, three, -three))), torch.where(
        m == 0, 0.0, torch.where(m == 1, -0.0, torch.where(
            m == 2, pi_t, -pi_t))))
    out = torch.where(ix == 0x7f800000, x_inf, out)
    out = torch.where(ix == 0, torch.where(hy < 0, -half, half), out)
    out = torch.where(iy == 0, torch.where(
        m < 2, y, torch.where(m == 2, pi_t, -pi_t)), out)
    out = torch.where(hx == 0x3f800000, _atanf(y), out)
    return torch.where((ix > 0x7f800000) | (iy > 0x7f800000), x + y, out)


def acos_ref(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 arccos, plain PyTorch."""
    x = x.float()
    # torch's f32 sqrt on the CPU is not correctly rounded; the f64 one
    # rounded to f32 is (53 >= 2 * 24 + 2 bits)
    return _atan2f(((1.0 - x) * (x + 1.0)).double().sqrt().float(), x)


# ---------------------------------------------------------------------------
# cos and sin: glibc's sinf/cosf, FMA variant, in f64
# ---------------------------------------------------------------------------

_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_PI63 = float.fromhex("0x1.921fb54442d18p-62")
_SIGN = (1.0, -1.0, -1.0, 1.0)
# (c0, c1, c2, c3, c4) of table 0 (table 1 is their negation), and
# (s1, s2, s3) of both
_CC = [float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_SS = [float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13")]
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = 134217729.0 * a                  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """Correctly rounded f64 fused multiply-add (the product exact as
    a double-double, the sum of its low part and the addition's error
    rounded to odd, then one rounding: Boldo and Melquiond). For the
    finite, unscaled arguments of the sin/cos polynomials."""
    ph = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, ph)
    s, e = _two_sum(tl, pl)
    bits = s.view(_I64)
    nudge = (e != 0) & ((bits & 1) == 0)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    s = torch.where(nudge, bits + step, bits).view(torch.float64)
    out = th + s
    return torch.where(ph == 0, c + ph, out)


def _poly(xs, x2, neg, odd):
    """sinf_poly: the sine polynomial of xs (even n) or the cosine one of
    x2 (odd n); ``neg``: the second table, whose cosine coefficients are
    negated."""
    cs = [torch.where(neg, -v, v) for v in
          (_c(x2, c) for c in _CC)]
    x4 = x2 * x2
    c1 = _fma64(x2, cs[1], cs[0])
    c2 = _fma64(x2, cs[4], cs[3])
    x6 = x2 * x4
    cos = _fma64(c2, x6, _fma64(x4, cs[2], c1))
    s1 = _fma64(x2, _c(x2, _SS[2]), _c(x2, _SS[1]))
    x3 = x2 * xs
    x5 = x2 * x3
    sin = _fma64(s1, x5, _fma64(x3, _c(x2, _SS[0]), xs))
    return torch.where(odd, cos, sin)


def _reduce_large(xi: torch.Tensor):
    """(x, n): glibc's reduce_large over the 2/pi bit table, in 64-bit
    integer arithmetic (modulo 2^64, as the C code's unsigned)."""
    arr = torch.tensor(_INV_PIO4, dtype=_I64, device=xi.device)
    idx = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xffffff) | 0x800000) << shift            # < 2^31
    res0 = (m * arr[idx]) & 0xffffffff
    res1 = m * arr[idx + 4]
    res2 = m * arr[idx + 8]
    res0 = ((res2 >> 32) & 0xffffffff) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.double() * _PI63, n


def _sincos_ref(y: torch.Tensor, want_cos: bool) -> torch.Tensor:
    y = y.float()
    hy = _bits(y).to(_I64)
    xi = hy & 0xffffffff
    top = (hy >> 20) & 0x7ff
    x = y.double()
    zero = torch.zeros_like(hy)
    # |y| < 120: n = round(y * 2/pi), by the shift of a truncation
    r = x * _HPI_INV
    n_fast = ((torch.where(top <= 0x42e, r, 0.0).to(_I32) + 0x800000)
              >> 24).to(_I64)
    x_fast = _fma64(-n_fast.double(), _c(x, _HPI), x)
    x_large, n_large = _reduce_large(torch.where(top <= 0x42e, zero, xi))
    small = top <= 0x3f3
    fast = top <= 0x42e
    xr = torch.where(small, x, torch.where(fast, x_fast, x_large))
    n = torch.where(small, zero, torch.where(fast, n_fast, n_large))
    # the sign's and table's index: n, or n + sign beyond 120
    ns = torch.where(fast, n, n + ((hy >> 31) & 1))
    sign = torch.tensor(_SIGN, dtype=torch.float64, device=y.device)[ns & 3]
    odd = (n & 1) == (0 if want_cos else 1)
    v = _poly(xr * sign, xr * xr, (ns & 2) != 0, odd).float()
    tiny = top <= 0x397
    v = torch.where(tiny, 1.0 if want_cos else y, v)
    return torch.where(top > 0x7f7, (y - y) / (y - y), v)


def cos_ref(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 cos (glibc's cosf), plain PyTorch."""
    return _sincos_ref(x, True)


def sin_ref(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 sin (glibc's sinf), plain PyTorch."""
    return _sincos_ref(x, False)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_PLAIN = {EXP: exp_ref, ACOS: acos_ref}


def _apply(op: int, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"xla_math: want float32, got {x.dtype}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"xla_math: unsupported device {x.device}")
        pairsum._count(pairsum.PLAIN_CALLS, "xla_math")
        if op == SINCOS:
            return torch.stack([cos_ref(x), sin_ref(x)])
        return _PLAIN[op](x)
    x = x.contiguous()
    out = torch.empty((2,) + x.shape if op == SINCOS else x.shape,
                      dtype=torch.float32, device=x.device)
    if x.numel():
        pairsum.run("xla_math", x.device, op, x.data_ptr(), out.data_ptr(),
                    x.numel())
    return out


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 exp of every entry."""
    return _apply(EXP, x)


def acos(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 arccos of every entry."""
    return _apply(ACOS, x)


def sincos(x: torch.Tensor) -> torch.Tensor:
    """(2, *x.shape): XLA:CPU's f32 cos and sin of every entry, in one
    launch on the card."""
    return _apply(SINCOS, x)
