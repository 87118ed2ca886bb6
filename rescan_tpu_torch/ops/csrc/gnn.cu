// Gated nearest-neighbour search over a Morton-sorted scene slab, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rescan_tpu/ops/pallas_nn.py::_nn_kernel
// (launched by _run_kernel, pallas_call at :453) in both of its forms:
//   K1  want_idx=false (gated_min_pallas)    -> (d2, dot)
//   K2  want_idx=true  (nearest_gated_pallas) -> (idx, d2, dot)
// and folds in its XLA block prologue (K3, pallas_nn.py:419-441): each
// CTA reduces the bounding box of its own 128 queries and walks the tile
// bounds itself, so no per-block near-tile list is materialised.
//
// Semantics, per query (q, n): among slab columns p with d2 = |q - p|^2
// strictly below r^2 and gate g = max(n . n_p, 0) (|n . n_p| with
// USE_ABS) at least gate_thr (= cos_gate - 1e-6, formed in f32 by the
// caller), the smallest d2; ties go to the lowest Morton-sorted column.
// Outputs d2 (+inf when nothing qualifies), the g of that column (0 when
// nothing qualifies) and, for K2, the column mapped through perm to the
// original point index (-1 when nothing qualifies).
//
// Bit-identity with the reference: queries are centred by the slab
// centre in f32; d2 and the normal dot use the exact fused-multiply-add
// pattern the reference's compiled arithmetic uses,
//   d2  = fma(dz, dz, fma(dx, dx, dy * dy))
//   dot = fma(nz, pz, fma(nx, px, ny * py))
// written with explicit round-to-nearest intrinsics, and the file is
// built with -fmad=false so the compiler contracts nothing else. Each
// thread scans the columns of every near tile in ascending order and
// replaces its best only on a strict '<', which is the reference's
// first-index argmin within a tile and strict '<' across ascending tiles.
// The near-tile test is the reference's f32 expression: tile bounds
// against the block bbox dilated by radj = sqrt(r^2).
//
// What bounds it on the H100: per (query, column) pair the work is three
// subtractions, a multiply and two FMAs plus a compare (the normal dot
// only for in-radius columns), all on the FP32 pipes, with the column
// read as a shared-memory broadcast. With K = 3 there is nothing for the
// tensor cores. The scene tiles of a block are staged once per CTA into
// shared memory (CHUNK columns at a time) and reused by all 128 queries,
// so device-memory traffic is small next to the pair arithmetic; blocks
// whose bbox is near no tile (padding queries) exit after the bounds
// walk. Faster variants (several queries per thread, skipping padding
// blocks at launch) are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;     // queries per CTA, one per thread
constexpr int CHUNK = 512;  // slab columns staged in shared memory at a time

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool WANT_IDX, bool USE_ABS>
__global__ void __launch_bounds__(BQ) gnn_kernel(
    const float* __restrict__ q_pos, const float* __restrict__ q_nrm,
    int64_t m, const float* __restrict__ slab, int64_t n_pad,
    const float* __restrict__ tile_bounds, int n_tiles, int tile,
    const int* __restrict__ perm, const float* __restrict__ center,
    float r2, float radj, float gate_thr, int* __restrict__ out_idx,
    float* __restrict__ out_d2, float* __restrict__ out_dot) {
  __shared__ float s_x[CHUNK], s_y[CHUNK], s_z[CHUNK];
  __shared__ float s_nx[CHUNK], s_ny[CHUNK], s_nz[CHUNK];
  __shared__ float s_red[6][BQ / 32];
  __shared__ float s_box[6];

  const int tid = threadIdx.x;
  const int64_t qi = (int64_t)blockIdx.x * BQ + tid;
  const bool valid = qi < m;

  float qx = 0.f, qy = 0.f, qz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (valid) {
    qx = __fsub_rn(q_pos[3 * qi + 0], center[0]);
    qy = __fsub_rn(q_pos[3 * qi + 1], center[1]);
    qz = __fsub_rn(q_pos[3 * qi + 2], center[2]);
    nx = q_nrm[3 * qi + 0];
    ny = q_nrm[3 * qi + 1];
    nz = q_nrm[3 * qi + 2];
  }

  // K3: bounding box of this block's real queries
  float v[6] = {valid ? qx : INFINITY,  valid ? qy : INFINITY,
                valid ? qz : INFINITY,  valid ? qx : -INFINITY,
                valid ? qy : -INFINITY, valid ? qz : -INFINITY};
  for (int k = 0; k < 3; ++k) v[k] = warp_min(v[k]);
  for (int k = 3; k < 6; ++k) v[k] = warp_max(v[k]);
  if ((tid & 31) == 0)
    for (int k = 0; k < 6; ++k) s_red[k][tid >> 5] = v[k];
  __syncthreads();
  if (tid < 6) {
    float a = s_red[tid][0];
    for (int w = 1; w < BQ / 32; ++w)
      a = tid < 3 ? fminf(a, s_red[tid][w]) : fmaxf(a, s_red[tid][w]);
    s_box[tid] = a;
  }
  __syncthreads();
  const float lo_x = __fsub_rn(s_box[0], radj), hi_x = __fadd_rn(s_box[3], radj);
  const float lo_y = __fsub_rn(s_box[1], radj), hi_y = __fadd_rn(s_box[4], radj);
  const float lo_z = __fsub_rn(s_box[2], radj), hi_z = __fadd_rn(s_box[5], radj);

  float best_d2 = INFINITY, best_dot = 0.f;
  int best_col = -1;

  for (int t = 0; t < n_tiles; ++t) {
    const float* b = tile_bounds + 8 * (int64_t)t;
    // the same for every thread of the block, so the barriers below are
    // reached uniformly
    const bool near = (b[0] <= hi_x) && (b[4] >= lo_x) && (b[1] <= hi_y) &&
                      (b[5] >= lo_y) && (b[2] <= hi_z) && (b[6] >= lo_z);
    if (!near) continue;
    for (int c0 = 0; c0 < tile; c0 += CHUNK) {
      const int64_t base = (int64_t)t * tile + c0;
      const int cn = min(CHUNK, tile - c0);
      __syncthreads();
      for (int j = tid; j < cn; j += BQ) {
        s_x[j] = slab[0 * n_pad + base + j];
        s_y[j] = slab[1 * n_pad + base + j];
        s_z[j] = slab[2 * n_pad + base + j];
        s_nx[j] = slab[4 * n_pad + base + j];
        s_ny[j] = slab[5 * n_pad + base + j];
        s_nz[j] = slab[6 * n_pad + base + j];
      }
      __syncthreads();
      if (!valid) continue;
      for (int j = 0; j < cn; ++j) {
        const float dx = __fsub_rn(qx, s_x[j]);
        const float dy = __fsub_rn(qy, s_y[j]);
        const float dz = __fsub_rn(qz, s_z[j]);
        const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
        if (d2 < r2 && d2 < best_d2) {
          const float nd = __fmaf_rn(nz, s_nz[j], __fmaf_rn(nx, s_nx[j], __fmul_rn(ny, s_ny[j])));
          const float g = USE_ABS ? fabsf(nd) : (nd > 0.f ? nd : 0.f);
          if (g >= gate_thr) {
            best_d2 = d2;
            best_dot = g;
            best_col = (int)(base + j);
          }
        }
      }
    }
  }

  if (valid) {
    out_d2[qi] = best_d2;
    out_dot[qi] = best_dot;
    if (WANT_IDX) out_idx[qi] = best_col >= 0 ? perm[best_col] : -1;
  }
}

template <bool WANT_IDX, bool USE_ABS>
void launch(const float* q_pos, const float* q_nrm, int64_t m, const float* slab,
            int64_t n_pad, const float* tile_bounds, int n_tiles, int tile,
            const int* perm, const float* center, float r2, float radj,
            float gate_thr, int* out_idx, float* out_d2, float* out_dot,
            cudaStream_t stream) {
  const unsigned int grid = (unsigned int)((m + BQ - 1) / BQ);
  gnn_kernel<WANT_IDX, USE_ABS><<<grid, BQ, 0, stream>>>(
      q_pos, q_nrm, m, slab, n_pad, tile_bounds, n_tiles, tile, perm, center,
      r2, radj, gate_thr, out_idx, out_d2, out_dot);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and
// returns cudaGetLastError(), so a refused launch is reported at once.
extern "C" int gnn_query(const float* q_pos, const float* q_nrm, int64_t m,
                         const float* slab, int64_t n_pad,
                         const float* tile_bounds, int n_tiles, int tile,
                         const int* perm, const float* center, float r2,
                         float radj, float gate_thr, int use_abs_dot,
                         int want_idx, int* out_idx, float* out_d2,
                         float* out_dot, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (want_idx) {
    if (use_abs_dot)
      launch<true, true>(q_pos, q_nrm, m, slab, n_pad, tile_bounds, n_tiles, tile,
                         perm, center, r2, radj, gate_thr, out_idx, out_d2, out_dot, s);
    else
      launch<true, false>(q_pos, q_nrm, m, slab, n_pad, tile_bounds, n_tiles, tile,
                          perm, center, r2, radj, gate_thr, out_idx, out_d2, out_dot, s);
  } else {
    if (use_abs_dot)
      launch<false, true>(q_pos, q_nrm, m, slab, n_pad, tile_bounds, n_tiles, tile,
                          perm, center, r2, radj, gate_thr, out_idx, out_d2, out_dot, s);
    else
      launch<false, false>(q_pos, q_nrm, m, slab, n_pad, tile_bounds, n_tiles, tile,
                           perm, center, r2, radj, gate_thr, out_idx, out_d2, out_dot, s);
  }
  return (int)cudaGetLastError();
}
