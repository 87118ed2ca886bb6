// XLA:CPU's f32 exp, arccos, cos and sin as device functions, step for
// step as ops/xla_math.py's plain versions compute them (which hold them
// bit for bit to jnp): XLA's own exp polynomial, glibc's fdlibm
// atan2f/atanf behind CHLO's arccos expansion, glibc's FMA-built
// sinf/cosf in f64. Every operation is an explicit IEEE intrinsic
// (__fmaf_rn, __fma_rn, __fdiv_rn, ...): none of the card's own
// transcendentals (expf, acosf, __cosf) is used, and the file is built
// with -fmad=false so nothing else is fused.
#pragma once

namespace xla_math {

// ---------------------------------------------------------------------------
// exp: XLA's polynomial; denormal results flushed to zero, as XLA runs
// ---------------------------------------------------------------------------

__device__ __forceinline__ float expf_(float x) {
  const float lo = __uint_as_float(0xc2af999au), hi = __uint_as_float(0x42b1999au);
  x = x < lo ? lo : x;  // a NaN passes both clamps
  x = x > hi ? hi : x;
  float fx = floorf(__fmaf_rn(x, __uint_as_float(0x3fb8aa3bu), 0.5f));
  fx = fx < -127.0f ? -127.0f : fx;
  fx = fx > 127.0f ? 127.0f : fx;
  float r = __fmaf_rn(-fx, __uint_as_float(0x3f318000u), x);
  r = __fmaf_rn(-fx, __uint_as_float(0xb95e8083u), r);
  float y = __uint_as_float(0x39506967u);
  y = __fmaf_rn(y, r, __uint_as_float(0x3ab743ceu));
  y = __fmaf_rn(y, r, __uint_as_float(0x3c088908u));
  y = __fmaf_rn(y, r, __uint_as_float(0x3d2aa9c1u));
  y = __fmaf_rn(y, r, __uint_as_float(0x3e2aaaaau));
  y = __fmaf_rn(y, r, 0.5f);
  y = __fadd_rn(__fmaf_rn(y, __fmul_rn(r, r), r), 1.0f);
  const int n = isnan(fx) ? 0 : static_cast<int>(fx);
  const float p2 = __uint_as_float((static_cast<unsigned>(n) << 23) + 0x3f800000u);
  const float out = __fmul_rn(y, p2);
  return (n == -127 || (n == -126 && y < 1.0f)) ? 0.0f : out;
}

// ---------------------------------------------------------------------------
// arccos: atan2f(sqrtf((1 - x) * (1 + x)), x), glibc's atan2f and atanf
// ---------------------------------------------------------------------------

__device__ __forceinline__ float atanf_(float x) {
  const float atanhi[4] = {__uint_as_float(0x3eed6338u), __uint_as_float(0x3f490fdau),
                           __uint_as_float(0x3f7b985eu), __uint_as_float(0x3fc90fdau)};
  const float atanlo[4] = {__uint_as_float(0x31ac3769u), __uint_as_float(0x33222168u),
                           __uint_as_float(0x33140fb4u), __uint_as_float(0x33a22168u)};
  const int hx = __float_as_int(x);
  const int ix = hx & 0x7fffffff;
  if (ix > 0x7f800000) return __fadd_rn(x, x);
  if (ix >= 0x4c000000) {
    const float inf = __fadd_rn(atanhi[3], atanlo[3]);
    return hx > 0 ? inf : -inf;
  }
  if (ix < 0x31000000) return x;
  int id = -1;
  float r = x;
  if (ix >= 0x3ee00000) {
    const float ax = fabsf(x);
    if (ix < 0x3f300000) {
      id = 0;
      r = __fdiv_rn(__fsub_rn(__fadd_rn(ax, ax), 1.0f), __fadd_rn(ax, 2.0f));
    } else if (ix < 0x3f980000) {
      id = 1;
      r = __fdiv_rn(__fsub_rn(ax, 1.0f), __fadd_rn(ax, 1.0f));
    } else if (ix < 0x401c0000) {
      id = 2;
      r = __fdiv_rn(__fsub_rn(ax, 1.5f), __fadd_rn(__fmul_rn(ax, 1.5f), 1.0f));
    } else {
      id = 3;
      r = __fdiv_rn(-1.0f, ax);
    }
  }
  const float z = __fmul_rn(r, r);
  const float w = __fmul_rn(z, z);
  float s1 = __uint_as_float(0x3c8569d7u);
  s1 = __fadd_rn(__fmul_rn(s1, w), __uint_as_float(0x3d4bda59u));
  s1 = __fadd_rn(__fmul_rn(s1, w), __uint_as_float(0x3d886b35u));
  s1 = __fadd_rn(__fmul_rn(s1, w), __uint_as_float(0x3dba2e6eu));
  s1 = __fadd_rn(__fmul_rn(s1, w), __uint_as_float(0x3e124925u));
  s1 = __fadd_rn(__fmul_rn(s1, w), __uint_as_float(0x3eaaaaabu));
  s1 = __fmul_rn(s1, z);
  float s2 = __uint_as_float(0xbd15a221u);
  s2 = __fadd_rn(__fmul_rn(s2, w), __uint_as_float(0xbd6ef16bu));
  s2 = __fadd_rn(__fmul_rn(s2, w), __uint_as_float(0xbd9d8795u));
  s2 = __fadd_rn(__fmul_rn(s2, w), __uint_as_float(0xbde38e38u));
  s2 = __fadd_rn(__fmul_rn(s2, w), __uint_as_float(0xbe4ccccdu));
  s2 = __fmul_rn(s2, w);
  const float t = __fmul_rn(r, __fadd_rn(s1, s2));
  if (id < 0) return __fsub_rn(x, t);
  const float big = __fsub_rn(atanhi[id], __fsub_rn(__fsub_rn(t, atanlo[id]), r));
  return hx < 0 ? -big : big;
}

__device__ __forceinline__ float atan2f_(float y, float x) {
  const float pi = __uint_as_float(0x40490fdbu), pi_o_2 = __uint_as_float(0x3fc90fdbu);
  const float pi_o_4 = __uint_as_float(0x3f490fdbu), pi_lo = __uint_as_float(0xb3bbbd2eu);
  const float tiny = 1.0e-30f;
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return __fadd_rn(x, y);
  if (hx == 0x3f800000) return atanf_(y);
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  if (iy == 0) {
    if (m < 2) return y;
    const float p = __fadd_rn(tiny, pi);
    return m == 2 ? p : -p;
  }
  const float half = __fadd_rn(tiny, pi_o_2);
  if (ix == 0) return hy < 0 ? -half : half;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      const float q = __fadd_rn(pi_o_4, tiny);
      const float q3 = __fadd_rn(__fmul_rn(3.0f, pi_o_4), tiny);
      return m == 0 ? q : m == 1 ? -q : m == 2 ? q3 : -q3;
    }
    const float p = __fadd_rn(tiny, pi);
    return m == 0 ? 0.0f : m == 1 ? -0.0f : m == 2 ? p : -p;
  }
  if (iy == 0x7f800000) return hy < 0 ? -half : half;
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60)
    z = __fadd_rn(pi_o_2, __fmul_rn(0.5f, pi_lo));
  else if (hx < 0 && k < -60)
    z = 0.0f;
  else
    z = atanf_(fabsf(__fdiv_rn(y, x)));
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(pi, __fsub_rn(z, pi_lo));
    default: return __fsub_rn(__fsub_rn(z, pi_lo), pi);
  }
}

__device__ __forceinline__ float acosf_(float x) {
  return atan2f_(__fsqrt_rn(__fmul_rn(__fsub_rn(1.0f, x), __fadd_rn(x, 1.0f))), x);
}

// ---------------------------------------------------------------------------
// cos and sin: glibc's sinf/cosf (FMA variant), in f64
// ---------------------------------------------------------------------------

__device__ const unsigned INV_PIO4[24] = {
    0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u,
    0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u, 0x29fc2757u, 0xfc2757d1u,
    0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu, 0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u,
    0xc0db6295u, 0xdb629599u, 0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u};

// glibc's reduce_large: x mod pi/2 from the 2/pi bit table, and n
__device__ __forceinline__ double reduce_large_(unsigned xi, int* np) {
  const unsigned* arr = &INV_PIO4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  const unsigned m = ((xi & 0xffffffu) | 0x800000u) << shift;
  unsigned long long res0 = static_cast<unsigned>(m * arr[0]);
  const unsigned long long res1 = static_cast<unsigned long long>(m) * arr[4];
  const unsigned long long res2 = static_cast<unsigned long long>(m) * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const unsigned long long n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = static_cast<int>(n);
  return __dmul_rn(static_cast<double>(static_cast<long long>(res0)),
                   0x1.921fb54442d18p-62);
}

// sinf_poly: the sine polynomial of xs, or (odd) the cosine one of x2; neg:
// the second table, whose cosine coefficients are negated
__device__ __forceinline__ float sinf_poly_(double xs, double x2, bool neg, bool odd) {
  if (odd) {
    const double g = neg ? -1.0 : 1.0;
    const double x4 = __dmul_rn(x2, x2);
    const double c1 = __fma_rn(x2, g * -0x1.ffffffd0c621cp-2, g * 0x1p0);
    const double c2 = __fma_rn(x2, g * 0x1.99343027bf8c3p-16, g * -0x1.6c087e89a359dp-10);
    const double x6 = __dmul_rn(x2, x4);
    const double c = __fma_rn(x4, g * 0x1.55553e1068f19p-5, c1);
    return __double2float_rn(__fma_rn(c2, x6, c));
  }
  const double s1 = __fma_rn(x2, -0x1.994eb3774cf24p-13, 0x1.1107605230bc4p-7);
  const double x3 = __dmul_rn(x2, xs);
  const double x5 = __dmul_rn(x2, x3);
  const double s = __fma_rn(x3, -0x1.555545995a603p-3, xs);
  return __double2float_rn(__fma_rn(s1, x5, s));
}

__device__ __forceinline__ float sincosf_(float y, bool want_cos) {
  const unsigned xi = __float_as_uint(y);
  const unsigned top = (xi >> 20) & 0x7ff;
  if (top > 0x7f7) return __fdiv_rn(__fsub_rn(y, y), __fsub_rn(y, y));
  if (top <= 0x397) return want_cos ? 1.0f : y;
  const double x = static_cast<double>(y);
  double xr = x;
  int n = 0, ns = 0;
  if (top > 0x3f3 && top <= 0x42e) {
    const double r = __dmul_rn(x, 0x1.45f306dc9c883p+23);
    n = (__double2int_rz(r) + 0x800000) >> 24;
    xr = __fma_rn(-static_cast<double>(n), 0x1.921fb54442d18p+0, x);
    ns = n;
  } else if (top > 0x42e) {
    xr = reduce_large_(xi, &n);
    ns = n + static_cast<int>(xi >> 31);
  }
  const double sign = ((ns & 3) == 1 || (ns & 3) == 2) ? -1.0 : 1.0;
  const bool odd = want_cos ? (n & 1) == 0 : (n & 1) == 1;
  return sinf_poly_(__dmul_rn(xr, sign), __dmul_rn(xr, xr), (ns & 2) != 0, odd);
}

}  // namespace xla_math
