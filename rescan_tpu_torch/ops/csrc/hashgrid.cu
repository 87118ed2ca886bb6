// The JAX package's two other neighbour-search engines, for NVIDIA Hopper
// (sm_90a): the windowed hash grid (rescan_tpu/ops/hashgrid.py) and the
// dense scan (rescan_tpu/ops/dense_nn.py). Neither has a Pallas original:
// these kernels replace what XLA compiled for the two engines' jitted
// functions, as pairsum.cu does for the ICP step.
//
//   grid_radius_knn_kernel<K>       hashgrid.radius_knn: the K nearest
//                                   points with d2 < r^2, ascending
//   grid_nearest_gated_kernel<ABS>  hashgrid.nearest_gated: the nearest
//                                   point with d2 < r^2 passing the gate
//   dense_nearest_kernel<ABS>       dense_nn._nearest_chunk: the same
//                                   query over every point, by the
//                                   expansion |q|^2 + |p|^2 - 2 q.p
//
// The grid (hashgrid.build_grid): points sorted by cell id
// (cy * nz + cz) * nx + cx of a uniform grid of side `cell` from `origin`,
// and cell_start, the prefix offsets of the cells. A query's cell is
// floor((q - origin) * inv) with inv = f32(1 / cell), converted to int32
// with saturation (NaN to 0), as XLA converts; cx is clamped to the grid,
// cy and cz are not. Its window is the 9 runs (dy, dz in -1, 0, 1, dy
// outer) of the 3 x-adjacent cells cx - 1 .. cx + 1 (clamped), each run a
// contiguous range of sorted points cut to L = 3 * cap of them; a run whose
// row lies outside the grid is empty. The JAX functions gather the window
// as one (9 * L) axis; a thread here walks it in the same order.
//
// Bit-identity with XLA:CPU's compiled arithmetic (read by probes on
// jaxlib 0.9.0, tests/test_torch_hashgrid.py): d = p - q,
//   d2  = fma(dz, dz, fma(dy, dy, dx * dx))
//   dot = fma(nz, qz, fma(ny, qy, nx * qx))
// and for the dense engine, over coordinates centred by the index centre,
//   |q|^2, |p|^2 and q.p each fma(z, z', fma(y, y', x * x')),
//   d2 = max((|q|^2 + |p|^2) - 2 q.p, 0)
// written with explicit round-to-nearest intrinsics in a file built with
// -fmad=false. The gate is max(dot, 0) (|dot| with ABS) against
// gate_thr = cos_gate - 1e-6 formed in f32 by the caller.
//
// Selection rules, the JAX functions':
// - radius_knn keeps lax.top_k's order: ascending d2, and among equal d2
//   the lower window position first. A thread keeps its K best in
//   registers (unrolled compare-and-shift: a new point goes after every
//   equal one, and once placed every later entry moves down one), so the
//   list never reaches local memory. Empty slots give idx -1, d2 +inf.
// - nearest_gated is jnp.argmin over the window: the first minimum in
//   window order, i.e. a strict '<' while walking it in order.
// - the dense scan replaces its carry only on a strictly smaller d2 after
//   a first-occurrence argmin per tile: the first minimum in index order,
//   again a strict '<' in ascending order.
//
// The design is the simple one: a thread per query, 128 threads a CTA.
// The grid kernels read each candidate's row from global memory (points
// of one cell are contiguous, so the 9 runs are 9 streams); the dense
// kernel stages TILE points (x, y, z, |p|^2 as a float4, then the normal)
// in shared memory, one tile at a time, and every thread of the CTA scans
// them. What is left on the table (PERF.md): the grid threads of a warp
// walk windows of different lengths and read scattered rows; the dense
// scan evaluates every pair.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // threads (queries) per CTA
constexpr int TILE = 256;     // points per shared-memory tile (dense)

struct Grid {
  const float* points;     // (N, 3) sorted by cell id
  const float* normals;    // (N, 3) in the same order
  const int* perm;         // (N,) original index of each sorted point
  const int* cell_start;   // (nx * ny * nz + 1,) prefix offsets
  float ox, oy, oz;        // origin
  float inv;               // f32(1 / cell)
  int nx, ny, nz;
  int len;                 // L = 3 * cap
};

__device__ __forceinline__ int cell_of(float q, float o, float inv) {
  return __float2int_rd(__fmul_rn(__fsub_rn(q, o), inv));
}

// The window's run r (0..8: dy = r / 3 - 1, dz = r % 3 - 1) as the sorted
// range [s, e); empty when its row lies outside the grid.
__device__ __forceinline__ void run_range(const Grid& g, int cx, int cy, int cz,
                                          int r, int& s, int& e) {
  const long long yy = (long long)cy + (r / 3 - 1);
  const long long zz = (long long)cz + (r % 3 - 1);
  s = e = 0;
  if (yy < 0 || yy >= g.ny || zz < 0 || zz >= g.nz) return;
  const long long row = (yy * g.nz + zz) * g.nx;
  s = g.cell_start[row + max(cx - 1, 0)];
  e = min(g.cell_start[row + min(cx + 1, g.nx - 1) + 1], s + g.len);
}

__device__ __forceinline__ void query_cell(const Grid& g, float qx, float qy, float qz,
                                           int& cx, int& cy, int& cz) {
  cx = min(max(cell_of(qx, g.ox, g.inv), 0), g.nx - 1);
  cy = cell_of(qy, g.oy, g.inv);
  cz = cell_of(qz, g.oz, g.inv);
}

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

template <bool USE_ABS>
__device__ __forceinline__ float gate_of(float nd) {
  return USE_ABS ? fabsf(nd) : (nd > 0.0f ? nd : 0.0f);
}

template <int K>
__global__ void __launch_bounds__(THREADS) grid_radius_knn_kernel(
    Grid g, const float* __restrict__ q, int64_t m, float r2, int* __restrict__ out_idx,
    float* __restrict__ out_d2, int* __restrict__ out_cnt) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  int cx, cy, cz;
  query_cell(g, qx, qy, qz, cx, cy, cz);
  float bd[K];
  int bj[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bd[k] = INFINITY;
    bj[k] = 0;
  }
  for (int r = 0; r < 9; ++r) {
    int s, e;
    run_range(g, cx, cy, cz, r, s, e);
    for (int j = s; j < e; ++j) {
      const float* p = g.points + 3 * (int64_t)j;
      const float d2 = sq3(__fsub_rn(p[0], qx), __fsub_rn(p[1], qy), __fsub_rn(p[2], qz));
      if (d2 < r2 && d2 < bd[K - 1]) {
        float cd = d2;
        int cj = j;
        bool moved = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool take = moved || cd < bd[k];
          const float td = bd[k];
          const int tj = bj[k];
          bd[k] = take ? cd : td;
          bj[k] = take ? cj : tj;
          cd = take ? td : cd;
          cj = take ? tj : cj;
          moved = take;
        }
      }
    }
  }
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool found = bd[k] < INFINITY;
    out_idx[i * K + k] = found ? g.perm[bj[k]] : -1;
    out_d2[i * K + k] = bd[k];
    cnt += found;
  }
  out_cnt[i] = cnt;
}

template <bool USE_ABS>
__global__ void __launch_bounds__(THREADS) grid_nearest_gated_kernel(
    Grid g, const float* __restrict__ q, const float* __restrict__ qn, int64_t m, float r2,
    float gate_thr, int* __restrict__ out_idx, float* __restrict__ out_d2,
    float* __restrict__ out_dot) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  const float nx = qn[3 * i], ny = qn[3 * i + 1], nz = qn[3 * i + 2];
  int cx, cy, cz;
  query_cell(g, qx, qy, qz, cx, cy, cz);
  float best = INFINITY, best_gate = 0.0f;
  int best_j = -1;
  for (int r = 0; r < 9; ++r) {
    int s, e;
    run_range(g, cx, cy, cz, r, s, e);
    for (int j = s; j < e; ++j) {
      const float* p = g.points + 3 * (int64_t)j;
      const float d2 = sq3(__fsub_rn(p[0], qx), __fsub_rn(p[1], qy), __fsub_rn(p[2], qz));
      if (d2 < r2 && d2 < best) {
        const float* pn = g.normals + 3 * (int64_t)j;
        const float gate = gate_of<USE_ABS>(dot3(pn[0], pn[1], pn[2], nx, ny, nz));
        if (gate >= gate_thr) {
          best = d2;
          best_gate = gate;
          best_j = j;
        }
      }
    }
  }
  out_idx[i] = best_j >= 0 ? g.perm[best_j] : -1;
  out_d2[i] = best;
  out_dot[i] = best_gate;
}

template <bool USE_ABS>
__global__ void __launch_bounds__(THREADS) dense_nearest_kernel(
    const float* __restrict__ points, const float* __restrict__ normals, int n_valid,
    const float* __restrict__ center, const float* __restrict__ q,
    const float* __restrict__ qn, int64_t m, float r2, float gate_thr,
    int* __restrict__ out_idx, float* __restrict__ out_d2, float* __restrict__ out_dot) {
  __shared__ float4 s_pos[TILE];  // x y z |p|^2
  __shared__ float s_nrm[3][TILE];
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < m;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (live) {
    qx = __fsub_rn(q[3 * i], center[0]);
    qy = __fsub_rn(q[3 * i + 1], center[1]);
    qz = __fsub_rn(q[3 * i + 2], center[2]);
    nx = qn[3 * i];
    ny = qn[3 * i + 1];
    nz = qn[3 * i + 2];
  }
  const float q2 = sq3(qx, qy, qz);
  float best = INFINITY, best_gate = 0.0f;
  int best_j = -1;
  for (int t0 = 0; t0 < n_valid; t0 += TILE) {
    const int cnt = min(TILE, n_valid - t0);
    __syncthreads();  // the previous tile is read by every thread
    for (int k = threadIdx.x; k < cnt; k += THREADS) {
      const float* p = points + 3 * (int64_t)(t0 + k);
      const float* pn = normals + 3 * (int64_t)(t0 + k);
      s_pos[k] = make_float4(p[0], p[1], p[2], sq3(p[0], p[1], p[2]));
      s_nrm[0][k] = pn[0];
      s_nrm[1][k] = pn[1];
      s_nrm[2][k] = pn[2];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < cnt; ++k) {
      const float4 p = s_pos[k];
      const float cross = dot3(qx, qy, qz, p.x, p.y, p.z);
      float d2 = __fsub_rn(__fadd_rn(q2, p.w), __fmul_rn(2.0f, cross));
      d2 = d2 < 0.0f ? 0.0f : d2;
      if (d2 < r2 && d2 < best) {
        const float gate = gate_of<USE_ABS>(dot3(nx, ny, nz, s_nrm[0][k], s_nrm[1][k],
                                                  s_nrm[2][k]));
        if (gate >= gate_thr) {
          best = d2;
          best_gate = gate;
          best_j = t0 + k;
        }
      }
    }
  }
  if (live) {
    out_idx[i] = best_j;
    out_d2[i] = best;
    out_dot[i] = best_gate;
  }
}

unsigned int blocks_for(int64_t m) { return (unsigned int)((m + THREADS - 1) / THREADS); }

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError(), so a refused launch is reported at once.

extern "C" int grid_radius_knn(const float* points, const int* perm, const int* cell_start,
                               float ox, float oy, float oz, float inv, int nx, int ny, int nz,
                               int len, const float* q, int64_t m, float r2, int k,
                               int* out_idx, float* out_d2, int* out_cnt, void* stream) {
  if (m <= 0) return 0;
  const Grid g{points, nullptr, perm, cell_start, ox, oy, oz, inv, nx, ny, nz, len};
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 8)
    grid_radius_knn_kernel<8><<<blocks_for(m), THREADS, 0, s>>>(g, q, m, r2, out_idx, out_d2,
                                                                 out_cnt);
  else if (k == 16)
    grid_radius_knn_kernel<16><<<blocks_for(m), THREADS, 0, s>>>(g, q, m, r2, out_idx, out_d2,
                                                                  out_cnt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int grid_nearest_gated(const float* points, const float* normals, const int* perm,
                                  const int* cell_start, float ox, float oy, float oz,
                                  float inv, int nx, int ny, int nz, int len, const float* q,
                                  const float* qn, int64_t m, float r2, float gate_thr,
                                  int use_abs_dot, int* out_idx, float* out_d2,
                                  float* out_dot, void* stream) {
  if (m <= 0) return 0;
  const Grid g{points, normals, perm, cell_start, ox, oy, oz, inv, nx, ny, nz, len};
  cudaStream_t s = (cudaStream_t)stream;
  if (use_abs_dot)
    grid_nearest_gated_kernel<true><<<blocks_for(m), THREADS, 0, s>>>(
        g, q, qn, m, r2, gate_thr, out_idx, out_d2, out_dot);
  else
    grid_nearest_gated_kernel<false><<<blocks_for(m), THREADS, 0, s>>>(
        g, q, qn, m, r2, gate_thr, out_idx, out_d2, out_dot);
  return (int)cudaGetLastError();
}

extern "C" int dense_nearest(const float* points, const float* normals, int n_valid,
                             const float* center, const float* q, const float* qn, int64_t m,
                             float r2, float gate_thr, int use_abs_dot, int* out_idx,
                             float* out_d2, float* out_dot, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_abs_dot)
    dense_nearest_kernel<true><<<blocks_for(m), THREADS, 0, s>>>(
        points, normals, n_valid, center, q, qn, m, r2, gate_thr, out_idx, out_d2, out_dot);
  else
    dense_nearest_kernel<false><<<blocks_for(m), THREADS, 0, s>>>(
        points, normals, n_valid, center, q, qn, m, r2, gate_thr, out_idx, out_d2, out_dot);
  return (int)cudaGetLastError();
}
