// Per-pair sums over points in the JAX package's order (ops/pairsum.py),
// and the rest of the ICP step's arithmetic in that order: an elementwise
// correctly rounded fused multiply-add (ops/pairsum.py ``fma``) and the
// batched 6x6 solve (ops/lu6.py).
//
// One thread per (pair, quantity): it walks the pair's points in index
// order, ``acc0 = fma(a[n], b[n], acc0)``, and where the shared
// push-depth table says a segment ends (a 32-entry window of a jnp.sum, a
// k-block of Eigen's product), adds the finished level into the next one
// and restarts it from 0; a LANES sum keeps 32 interleaved chains instead.
// A sum is sequential, so it is never cut into a tree; the pairs and
// quantities are the parallel axes. The accumulators come in from and go
// back to ``state``, so a point axis split over shards continues one sum.
//
// Built with -fmad=false: the only fused operations are the explicit
// __fmaf_rn, and every other add is __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ops/pairsum.py STATE: five level accumulators (a0..a4 below), or 32
// lanes and a total
constexpr int STATE = 36;
constexpr int THREADS = 128;
constexpr int LANES = 4, LANES_TAIL = 5;   // ops/pairsum.py kinds
constexpr int LANE_COUNT = 32, LANE_TAIL = 32, LANE_TOTAL = 32;
constexpr float F32_TINY = 1.17549435e-38f;   // FLT_MIN

// one launch of THREADS-thread blocks (a host build of this file may
// define its own)
#ifndef PAIRSUM_LAUNCH
#define PAIRSUM_LAUNCH(kernel, blocks, stream, ...) \
  kernel<<<(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__)
#endif

// Points n0 .. n0 + n of a LANES sum (n0, n and n_total multiples of 32):
// point i of the first n_total - tail goes to lane i % 32 in index order;
// after the last of them the four 8-lane vectors are added
// ((v1 + v0) + v2) + v3 and the 8 lanes halved three times; the last
// ``tail`` points are then chained on one by one (LLVM's vectorized
// reduction, as XLA runs a one-pair dot). The lanes and then the total
// live in the state, so a run of points continues the one before it.
__device__ void lanes_sum(const float* row, int n, int k, int ia, int ib,
                          int n0, int n_total, int tail, float* st) {
  const int v = n_total - tail;
  const int hi = min(n0 + n, v);
  if (hi > n0) {
    float acc[LANE_COUNT];
#pragma unroll
    for (int l = 0; l < LANE_COUNT; ++l) acc[l] = st[l];
    for (int i = 0; i < hi - n0; i += LANE_COUNT) {
#pragma unroll
      for (int l = 0; l < LANE_COUNT; ++l) {
        const float* p = row + static_cast<size_t>(i + l) * k;
        acc[l] = __fmaf_rn(p[ia], ib >= 0 ? p[ib] : 1.0f, acc[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < LANE_COUNT; ++l) st[l] = acc[l];
  }
  if (n0 + n < v || n == 0) return;
  float s = st[LANE_TOTAL];
  if (n0 < v) {
    float r[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      r[l] = __fadd_rn(__fadd_rn(__fadd_rn(st[8 + l], st[l]), st[16 + l]),
                       st[24 + l]);
    }
#pragma unroll
    for (int h = 4; h > 0; h >>= 1) {
#pragma unroll
      for (int l = 0; l < h; ++l) r[l] = __fadd_rn(r[l], r[l + h]);
    }
    s = r[0];
  }
  for (int i = max(v, n0) - n0; i < n; ++i) {
    const float* p = row + static_cast<size_t>(i) * k;
    s = __fmaf_rn(p[ia], ib >= 0 ? p[ib] : 1.0f, s);
  }
  st[LANE_TOTAL] = s;
}

__global__ void __launch_bounds__(THREADS)
pairsum_kernel(const float* __restrict__ x, int n_pairs, int n, int k,
               const int* __restrict__ spec, int n_q,
               const int8_t* __restrict__ depth, int n0, int n_total,
               float* __restrict__ state) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_pairs * n_q) return;
  const int pair = t / n_q;
  const int q = t - pair * n_q;
  const int kind = spec[3 * q];
  const int ia = spec[3 * q + 1];
  const int ib = spec[3 * q + 2];
  float* st = state + static_cast<size_t>(t) * STATE;
  const float* row = x + static_cast<size_t>(pair) * n * k;
  if (kind == LANES || kind == LANES_TAIL) {
    lanes_sum(row, n, k, ia, ib, n0, n_total,
              kind == LANES_TAIL ? LANE_TAIL : 0, st);
    return;
  }
  float a0 = st[0], a1 = st[1], a2 = st[2], a3 = st[3], a4 = st[4];
  const int8_t* dp = depth + static_cast<size_t>(kind) * n_total + n0;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float* p = row + static_cast<size_t>(i) * k;
    a0 = ib >= 0 ? __fmaf_rn(p[ia], p[ib], a0) : __fadd_rn(a0, p[ia]);
    const int d = dp[i];
    if (d > 0) {
      a1 = __fadd_rn(a1, a0);
      a0 = 0.0f;
      if (d > 1) {
        a2 = __fadd_rn(a2, a1);
        a1 = 0.0f;
        if (d > 2) {
          a3 = __fadd_rn(a3, a2);
          a2 = 0.0f;
          if (d > 3) {
            a4 = __fadd_rn(a4, a3);
            a3 = 0.0f;
          }
        }
      }
    }
  }
  st[0] = a0;
  st[1] = a1;
  st[2] = a2;
  st[3] = a3;
  st[4] = a4;
}

__global__ void __launch_bounds__(THREADS)
fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) out[i] = __fmaf_rn(a[i], b[i], c[i]);
}

// ops/lu6.py, one thread per system: the order of OpenBLAS's sgetrf (getf2,
// left-looking) and the two strsm block solves that jaxlib calls.
constexpr int N6 = 6;

__device__ float chain(const float* x, int xs, const float* y, int ys, int n) {
  float acc = __fmul_rn(x[0], y[0]);
  for (int k = 1; k < n; ++k) acc = __fmaf_rn(x[k * xs], y[k * ys], acc);
  return acc;
}

// getf2's dot of length 1..4: fma(x0, y0, x1*y1) + fma(x2, y2, x3*y3)
__device__ float getf2_dot(const float* x, const float* y, int n) {
  float acc = n == 1 ? __fmul_rn(x[0], y[0])
                     : __fmaf_rn(x[0], y[0], __fmul_rn(x[1], y[N6]));
  if (n == 3) acc = __fadd_rn(acc, __fmul_rn(x[2], y[2 * N6]));
  if (n == 4) acc = __fadd_rn(acc, __fmaf_rn(x[2], y[2 * N6], __fmul_rn(x[3], y[3 * N6])));
  return acc;
}

__global__ void __launch_bounds__(THREADS)
lu6_kernel(const float* __restrict__ c, const float* __restrict__ rhs,
           float* __restrict__ out, int n_sys) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_sys) return;
  float a[N6 * N6], x[N6];
  int perm[N6];
  for (int i = 0; i < N6 * N6; ++i) a[i] = c[static_cast<size_t>(t) * N6 * N6 + i];
  for (int i = 0; i < N6; ++i) perm[i] = i;
  for (int j = 0; j < N6; ++j) {
    for (int i = 1; i < j; ++i)
      a[i * N6 + j] = __fsub_rn(a[i * N6 + j], getf2_dot(a + i * N6, a + j, i));
    if (j) {
      for (int r = j; r < N6; ++r)
        a[r * N6 + j] = __fsub_rn(a[r * N6 + j], chain(a + r * N6, 1, a + j, N6, j));
    }
    // the first entry of largest magnitude (a NaN counts as largest)
    int jp = j;
    float best = fabsf(a[j * N6 + j]);
    for (int r = j + 1; r < N6; ++r) {
      const float v = fabsf(a[r * N6 + j]);
      if (!isnan(best) && (isnan(v) || v > best)) {
        best = v;
        jp = r;
      }
    }
    const int pj = perm[j];
    perm[j] = perm[jp];
    perm[jp] = pj;
    const float piv = a[jp * N6 + j];
    if (piv != 0.0f) {
      for (int k = 0; k < N6; ++k) {
        const float v = a[j * N6 + k];
        a[j * N6 + k] = a[jp * N6 + k];
        a[jp * N6 + k] = v;
      }
      const float inv = __fdiv_rn(1.0f, piv);
      for (int r = j + 1; r < N6; ++r)
        a[r * N6 + j] = fabsf(piv) >= F32_TINY ? __fmul_rn(a[r * N6 + j], inv)
                                              : __fdiv_rn(a[r * N6 + j], piv);
    }
  }
  for (int r = 0; r < N6; ++r) x[r] = rhs[static_cast<size_t>(t) * N6 + perm[r]];
  // strsm lower, unit diagonal, row blocks [0, 4) and [4, 6)
  const int lower[3] = {0, 4, N6};
  for (int blk = 0; blk < 2; ++blk) {
    const int s = lower[blk], e = lower[blk + 1];
    if (s)
      for (int r = s; r < e; ++r) x[r] = __fsub_rn(x[r], chain(a + r * N6, 1, x, 1, s));
    for (int i = s; i < e; ++i)
      for (int r = i + 1; r < e; ++r) x[r] = __fmaf_rn(-x[i], a[r * N6 + i], x[r]);
  }
  // strsm upper, row blocks [4, 6) then [0, 4), each bottom-up
  float inv[N6];
  for (int i = 0; i < N6; ++i) inv[i] = __fdiv_rn(1.0f, a[i * N6 + i]);
  const int upper[3] = {N6, 4, 0};
  for (int blk = 0; blk < 2; ++blk) {
    const int e = upper[blk], s = upper[blk + 1];
    if (e < N6)
      for (int r = s; r < e; ++r)
        x[r] = __fsub_rn(x[r], chain(a + r * N6 + e, 1, x + e, 1, N6 - e));
    for (int i = e - 1; i >= s; --i) {
      x[i] = __fmul_rn(x[i], inv[i]);
      for (int r = s; r < i; ++r) x[r] = __fmaf_rn(-x[i], a[r * N6 + i], x[r]);
    }
  }
  for (int r = 0; r < N6; ++r) out[static_cast<size_t>(t) * N6 + r] = x[r];
}

}  // namespace

// x: (n_pairs, n, k) f32; spec: (n_q, 3) int32 (kind, a column, b column
// or -1); depth: (4, n_total) int8, the segment ends of the chained kinds;
// state: (n_pairs, n_q, STATE) f32, read and written. The points are
// n0 .. n0 + n of n_total.
extern "C" int pairsum_run(const float* x, int n_pairs, int n, int k,
                           const int* spec, int n_q, const int8_t* depth,
                           int n0, int n_total, float* state, void* stream) {
  const int total = n_pairs * n_q;
  if (total <= 0 || n <= 0) return 0;
  const int blocks = (total + THREADS - 1) / THREADS;
  PAIRSUM_LAUNCH(pairsum_kernel, blocks, stream, x, n_pairs, n, k, spec, n_q,
                 depth, n0, n_total, state);
  return static_cast<int>(cudaGetLastError());
}

// out = fma(a, b, c) elementwise over n f32 entries.
extern "C" int fma_run(const float* a, const float* b, const float* c,
                       float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  PAIRSUM_LAUNCH(fma_kernel, static_cast<unsigned>(blocks), stream, a, b, c,
                 out, n);
  return static_cast<int>(cudaGetLastError());
}

// x of c x = rhs for n_sys systems: c (n_sys, 6, 6), rhs and x (n_sys, 6),
// f32, row-major.
extern "C" int lu6_run(const float* c, const float* rhs, float* x, int n_sys,
                       void* stream) {
  if (n_sys <= 0) return 0;
  PAIRSUM_LAUNCH(lu6_kernel, (n_sys + THREADS - 1) / THREADS, stream, c, rhs,
                 x, n_sys);
  return static_cast<int>(cudaGetLastError());
}
