// Gated nearest-neighbour search over a Morton-sorted scene slab, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rescan_tpu/ops/pallas_nn.py::_nn_kernel
// (launched by _run_kernel, pallas_call at :453) in both of its forms:
//   K1  want_idx=false (gated_min_pallas)    -> (d2, dot)
//   K2  want_idx=true  (nearest_gated_pallas) -> (idx, d2, dot)
// and folds in its XLA block prologue (K3, pallas_nn.py:419-441).
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
// built with -fmad=false so the compiler contracts nothing else. Every
// query visits its candidate columns in ascending order and replaces its
// best only on a strict '<', which is the reference's first-index argmin.
//
// What bounds it on the H100. Per (query, column) pair the work is three
// subtractions, a multiply, two FMAs and a compare on the FP32 pipes (the
// normal dot only for the rare column that beats the best so far); K = 3
// leaves nothing for the tensor cores. The function's bound is the larger
// of its bytes (24 B in and 8-12 B out per query, 24-28 B per slab point)
// and the FP32 work of the pairs within r; on the bench launches the two
// are about equal (PERF.md). What separates the kernel from it is (a) the
// pairs it evaluates that lie outside r and (b) the time per evaluated
// pair. The design, against both:
//
// 1. One CTA = one warp = one 128-query block, the reference's query
//    block (QPT = 4 Morton-adjacent queries per thread: query
//    b*128 + k*32 + lane in slot k, so loads and stores coalesce). The
//    tile test is the reference's f32 expression on this block's bbox,
//    so the tiles visited are the reference's.
// 2. A parallel prologue: the 32 lanes test 32 tile bounds per step;
//    __ballot_sync and __popc compact the near tiles into an ascending
//    list in shared memory (refilled in rounds when it fills up). A block
//    near no tile (far padding queries) writes (+inf, 0, -1) and exits
//    after ceil(n_tiles / 32) steps.
// 3. Run-level pruning inside near tiles: the slab's run table holds the
//    bounds of every RUN-column run (the plain version prunes with the
//    same table). The warp tests 32 runs per step (one per lane) against
//    the bbox of each of its QPT slots of 32 queries, dilated by
//    slack = radj * 1.0001 + 1e-6: a run no slot reaches is skipped, and
//    within a run the slots it does not reach are skipped (both branches
//    warp-uniform). A (run, slot) pair is dropped only when none of the
//    run's columns can pass d2 < r^2 for any query of the slot, so no
//    result changes.
// 4. Asynchronous staging: the surviving runs' six rows (x y z nx ny nz,
//    each a 128-byte, 16-byte-aligned segment of an SoA slab row) are
//    copied with cp.async into a ring of NSTAGE shared-memory stages of
//    STAGE_RUNS runs; stage k+1 is in flight while the warp tests stage k.
// 5. Several queries per thread: each column's x, y, z (read as float4
//    over 4 columns) feed QPT distance tests; each query screens its 4
//    new d2 with one compare (their min against its best, which starts
//    at r^2), and only a query that may improve takes the exact
//    sequential path (gate, strict '<', ascending columns).
// 6. Residency (measured on the H100, PERF.md): 80 registers and 9,944 B
//    of shared memory per one-warp CTA, no local memory in any
//    instantiation. Shared memory sets the residency at 21 CTAs per SM;
//    registers alone would allow 25, the CTA slots 32. K1's scoring time
//    over a carveout sweep (21, 12, 5, 2 CTAs) fits 9.0 ms + 175 ms /
//    (CTAs per SM) within 4 %: warps hide part of the latency, and 32
//    CTAs would save about 16 %; the rest is time per pair that more
//    warps do not hide. A query's normal, best gate and best column live
//    in shared memory (QueryState), its position and best d2 in
//    registers. Measured and rejected (PERF.md): distances of all slots
//    before their tests; an algebraic screen |q|^2 + |p|^2 - 2q.p; 3-run
//    stages.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int QPT = 4;                 // queries per thread
constexpr int BQ = WARP * QPT;         // queries per CTA (one warp)
constexpr int RUN = 32;                // columns per run of the run table
constexpr int STAGE_RUNS = 4;          // runs per shared-memory stage
constexpr int NSTAGE = 2;              // stages in the ring
constexpr int STAGE_COLS = STAGE_RUNS * RUN;
constexpr int ROWS = 6;                // x y z nx ny nz
constexpr int CHUNKS_PER_ROW = RUN * 4 / 16;   // 16-byte copies per row
constexpr int CHUNKS_PER_RUN = ROWS * CHUNKS_PER_ROW;
constexpr int TILE_LIST = 256;         // near-tile list capacity

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the newest committed group complete (this thread's copies)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Box {
  float lo[3], hi[3];
};

// bounds (min xyz at 0:3, max xyz at 4:7, as float4 pairs) against a box
__device__ __forceinline__ bool box_hits(const float4& lo, const float4& hi,
                                         const Box& box) {
  return (lo.x <= box.hi[0]) && (hi.x >= box.lo[0]) && (lo.y <= box.hi[1]) &&
         (hi.y >= box.lo[1]) && (lo.z <= box.hi[2]) && (hi.z >= box.lo[2]);
}

__device__ __forceinline__ bool box_hits(const float* b, const Box& box) {
  return box_hits(*reinterpret_cast<const float4*>(b),
                  *reinterpret_cast<const float4*>(b + 4), box);
}

// The warp's stream of surviving runs, in ascending column order, each
// with the mask of the query slots whose 32-query box it reaches. All of
// its state is warp-uniform (it comes from ballots and shuffles), so every
// lane walks it in step.
struct RunStream {
  const float* tile_bounds;
  const float* run_bounds;
  int n_tiles, runs_per_tile, lane;
  const Box* boxes;                 // shared: [0] tile test, [1 + k] slot k
  int* s_tiles;
  int t_scan = 0, li = 0, ln = 0;   // tile scan position; list cursor/length
  int tile = -1, grp = 0;           // current tile and its 32-run group
  unsigned mask = 0;                // surviving runs of the group left
  unsigned lane_slots = 0;          // slot mask of this lane's run
  unsigned slots = 0;               // slot mask of the run next() returned

  // the prologue, in rounds: compact the next near tiles into s_tiles
  __device__ __forceinline__ void refill() {
    li = ln = 0;
    while (t_scan < n_tiles && ln + WARP <= TILE_LIST) {
      const int t = t_scan + lane;
      const bool near = t < n_tiles && box_hits(tile_bounds + 8 * (int64_t)t, boxes[0]);
      const unsigned m = __ballot_sync(0xffffffffu, near);
      if (near) s_tiles[ln + __popc(m & ((1u << lane) - 1u))] = t;
      ln += __popc(m);
      t_scan += WARP;
    }
    __syncwarp();
  }

  // the 32 runs of the current group, one per lane, against each slot's
  // box; a run survives when it reaches at least one slot
  __device__ __forceinline__ void test_group() {
    const int k = grp * WARP + lane;
    lane_slots = 0;
    if (k < runs_per_tile) {
      const float* b = run_bounds + 8 * ((int64_t)tile * runs_per_tile + k);
      const float4 lo = *reinterpret_cast<const float4*>(b);
      const float4 hi = *reinterpret_cast<const float4*>(b + 4);
#pragma unroll
      for (int q = 0; q < QPT; ++q)
        if (box_hits(lo, hi, boxes[1 + q])) lane_slots |= 1u << q;
    }
    mask = __ballot_sync(0xffffffffu, lane_slots != 0);
  }

  // next surviving run (global run index), or -1 when none is left
  __device__ __forceinline__ int64_t next() {
    for (;;) {
      if (mask) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1u;
        slots = __shfl_sync(0xffffffffu, lane_slots, b);
        return (int64_t)tile * runs_per_tile + grp * WARP + b;
      }
      if (tile >= 0 && (grp + 1) * WARP < runs_per_tile) {
        ++grp;
        test_group();
        continue;
      }
      if (li == ln) {
        if (t_scan >= n_tiles) return -1;
        refill();
        if (li == ln) return -1;
      }
      tile = s_tiles[li++];
      grp = 0;
      test_group();
    }
  }
};

// Fill one stage with the stream's next surviving runs (their ids in
// s_run) and start their copies as one cp.async group; returns the number
// of runs (0: the stream is done). Slab rows x y z nx ny nz are rows
// 0 1 2 4 5 6.
__device__ __forceinline__ int fill_stage(RunStream& rs, int64_t* s_run,
                                          unsigned* s_slots,
                                          float (*s_col)[STAGE_COLS],
                                          const float* slab, int64_t n_pad,
                                          int lane) {
  int n = 0;
  for (; n < STAGE_RUNS; ++n) {
    const int64_t r = rs.next();
    if (r < 0) break;
    if (lane == 0) {
      s_run[n] = r;
      s_slots[n] = rs.slots;
    }
  }
  __syncwarp();
  for (int c = lane; c < n * CHUNKS_PER_RUN; c += WARP) {
    const int slot = c / CHUNKS_PER_RUN, rem = c % CHUNKS_PER_RUN;
    const int row = rem / CHUNKS_PER_ROW, part = rem % CHUNKS_PER_ROW;
    const int64_t slab_row = row < 3 ? row : row + 1;
    cp_async16(&s_col[row][slot * RUN + part * 4],
               slab + slab_row * n_pad + s_run[slot] * RUN + part * 4);
  }
  cp_async_commit();
  return n;
}

// What each query keeps outside the registers: its normal (read only on
// the exact path) and its best column and gate, in shared memory,
// indexed [slot * 32 + lane].
struct QueryState {
  float nrm[3][BQ];
  float dot[BQ];
  int col[BQ];
};

template <bool USE_ABS>
__device__ __forceinline__ float gate_of(float nx, float ny, float nz, float px,
                                         float py, float pz) {
  const float nd = __fmaf_rn(nz, pz, __fmaf_rn(nx, px, __fmul_rn(ny, py)));
  return USE_ABS ? fabsf(nd) : (nd > 0.f ? nd : 0.f);
}

// Every query of the slots in `sm` (all of them unless GUARD) against the
// RUN columns of one staged run (`cols` is its x row; y z nx ny nz follow
// STAGE_COLS apart), in ascending column order. Each float4 of x, y, z
// feeds QPT x 4 distance tests; a query whose 4 new d2 cannot beat its
// best skips the exact sequential path (a lane-divergent branch; the
// pairs within r are under 1 % of those evaluated on the bench launches).
template <bool USE_ABS, bool GUARD>
__device__ __forceinline__ void test_run(const float* cols, int col0, unsigned sm,
                                         const float (&qx)[QPT], const float (&qy)[QPT],
                                         const float (&qz)[QPT], QueryState& qs, int lane,
                                         float gate_thr, float (&best)[QPT]) {
#pragma unroll 2
  for (int j = 0; j < RUN; j += 4) {
    const float4 X = *reinterpret_cast<const float4*>(cols + j);
    const float4 Y = *reinterpret_cast<const float4*>(cols + STAGE_COLS + j);
    const float4 Z = *reinterpret_cast<const float4*>(cols + 2 * STAGE_COLS + j);
    const float cx[4] = {X.x, X.y, X.z, X.w};
    const float cy[4] = {Y.x, Y.y, Y.z, Y.w};
    const float cz[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      if (GUARD && !(sm & (1u << k))) continue;  // warp-uniform
      float d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float dx = __fsub_rn(qx[k], cx[c]);
        const float dy = __fsub_rn(qy[k], cy[c]);
        const float dz = __fsub_rn(qz[k], cz[c]);
        d[c] = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
      }
      if (fminf(fminf(d[0], d[1]), fminf(d[2], d[3])) < best[k]) {
        // exact sequential path: this query, columns in ascending order
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (d[c] < best[k]) {
            const float* p = cols + j + c;
            const int at = k * WARP + lane;
            const float g = gate_of<USE_ABS>(qs.nrm[0][at], qs.nrm[1][at], qs.nrm[2][at],
                                             p[3 * STAGE_COLS], p[4 * STAGE_COLS],
                                             p[5 * STAGE_COLS]);
            if (g >= gate_thr) {
              best[k] = d[c];
              qs.dot[at] = g;
              qs.col[at] = col0 + j + c;
            }
          }
        }
      }
    }
  }
}

template <bool WANT_IDX, bool USE_ABS>
__global__ void __launch_bounds__(WARP, 16) gnn_kernel(
    const float* __restrict__ q_pos, const float* __restrict__ q_nrm,
    int64_t m, const float* __restrict__ slab, int64_t n_pad,
    const float* __restrict__ tile_bounds, int n_tiles, int tile,
    const float* __restrict__ run_bounds, const int* __restrict__ perm,
    const float* __restrict__ center, float r2, float radj, float slack,
    float gate_thr, int* __restrict__ out_idx, float* __restrict__ out_d2,
    float* __restrict__ out_dot) {
  __shared__ __align__(16) float s_col[NSTAGE][ROWS][STAGE_COLS];
  __shared__ int64_t s_run[NSTAGE][STAGE_RUNS];
  __shared__ unsigned s_slots[NSTAGE][STAGE_RUNS];
  __shared__ int s_tiles[TILE_LIST];
  __shared__ Box s_box[1 + QPT];
  __shared__ QueryState s_q;

  const int lane = threadIdx.x;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;

  float qx[QPT], qy[QPT], qz[QPT];
  float best[QPT];
  float blo[3] = {INFINITY, INFINITY, INFINITY};
  float bhi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int64_t qi = q0 + k * WARP + lane;
    const bool valid = qi < m;
    qx[k] = qy[k] = qz[k] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) s_q.nrm[a][k * WARP + lane] = valid ? q_nrm[3 * qi + a] : 0.f;
    if (valid) {
      qx[k] = __fsub_rn(q_pos[3 * qi + 0], center[0]);
      qy[k] = __fsub_rn(q_pos[3 * qi + 1], center[1]);
      qz[k] = __fsub_rn(q_pos[3 * qi + 2], center[2]);
    }
    // slot k's box: the bbox of its 32 real queries, dilated by the run
    // test's slack (empty when the slot has none)
    const float v[3] = {qx[k], qy[k], qz[k]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lo = warp_min(valid ? v[a] : INFINITY);
      const float hi = warp_max(valid ? v[a] : -INFINITY);
      blo[a] = fminf(blo[a], lo);
      bhi[a] = fmaxf(bhi[a], hi);
      if (lane == 0) {
        s_box[1 + k].lo[a] = __fsub_rn(lo, slack);
        s_box[1 + k].hi[a] = __fadd_rn(hi, slack);
      }
    }
    // best starts at r^2: "d2 < best" is then "d2 < r^2 and below the
    // best so far", the reference's two tests in one
    best[k] = r2;
    s_q.dot[k * WARP + lane] = 0.f;
    s_q.col[k * WARP + lane] = -1;
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // K3: the reference's near-tile test, block bbox dilated by radj
      s_box[0].lo[a] = __fsub_rn(blo[a], radj);
      s_box[0].hi[a] = __fadd_rn(bhi[a], radj);
    }
  }
  __syncwarp();

  RunStream rs;
  rs.tile_bounds = tile_bounds;
  rs.run_bounds = run_bounds;
  rs.n_tiles = n_tiles;
  rs.runs_per_tile = tile / RUN;
  rs.lane = lane;
  rs.boxes = s_box;
  rs.s_tiles = s_tiles;

  int buf = 0;
  int n = fill_stage(rs, s_run[0], s_slots[0], s_col[0], slab, n_pad, lane);
  while (n > 0) {
    // stage buf^1 is in flight while stage buf is tested
    const int n_next =
        fill_stage(rs, s_run[buf ^ 1], s_slots[buf ^ 1], s_col[buf ^ 1], slab, n_pad, lane);
    cp_async_wait_prev();  // this lane's copies of stage buf landed
    __syncwarp();          // ... and every lane's
    // every query of the slots each run reaches, columns ascending
    for (int rr = 0; rr < n; ++rr) {
      const int col0 = (int)(s_run[buf][rr] * RUN);
      const unsigned sm = s_slots[buf][rr];
      const float* cols = &s_col[buf][0][rr * RUN];
      // all slots reached (the common case) runs without the slot tests
      if (sm == (1u << QPT) - 1u)
        test_run<USE_ABS, false>(cols, col0, sm, qx, qy, qz, s_q, lane, gate_thr, best);
      else
        test_run<USE_ABS, true>(cols, col0, sm, qx, qy, qz, s_q, lane, gate_thr, best);
    }
    __syncwarp();  // stage buf is free for the next fill
    buf ^= 1;
    n = n_next;
  }

#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int64_t qi = q0 + k * WARP + lane;
    if (qi < m) {
      const int col = s_q.col[k * WARP + lane];
      const bool found = col >= 0;
      out_d2[qi] = found ? best[k] : INFINITY;
      out_dot[qi] = s_q.dot[k * WARP + lane];
      if (WANT_IDX) out_idx[qi] = found ? perm[col] : -1;
    }
  }
}

template <bool WANT_IDX, bool USE_ABS>
void launch(const float* q_pos, const float* q_nrm, int64_t m, const float* slab,
            int64_t n_pad, const float* tile_bounds, int n_tiles, int tile,
            const float* run_bounds, const int* perm, const float* center, float r2,
            float radj, float slack, float gate_thr, int* out_idx, float* out_d2,
            float* out_dot, cudaStream_t stream) {
  const unsigned int grid = (unsigned int)((m + BQ - 1) / BQ);
  gnn_kernel<WANT_IDX, USE_ABS><<<grid, WARP, 0, stream>>>(
      q_pos, q_nrm, m, slab, n_pad, tile_bounds, n_tiles, tile, run_bounds, perm,
      center, r2, radj, slack, gate_thr, out_idx, out_d2, out_dot);
}

const void* kernel_of(int want_idx, int use_abs_dot) {
  if (want_idx) return use_abs_dot ? (const void*)gnn_kernel<true, true>
                                   : (const void*)gnn_kernel<true, false>;
  return use_abs_dot ? (const void*)gnn_kernel<false, true>
                     : (const void*)gnn_kernel<false, false>;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and
// returns cudaGetLastError(), so a refused launch is reported at once.
extern "C" int gnn_query(const float* q_pos, const float* q_nrm, int64_t m,
                         const float* slab, int64_t n_pad,
                         const float* tile_bounds, int n_tiles, int tile,
                         const float* run_bounds, const int* perm,
                         const float* center, float r2, float radj, float slack,
                         float gate_thr, int use_abs_dot, int want_idx,
                         int* out_idx, float* out_d2, float* out_dot,
                         void* stream) {
  if (m <= 0) return 0;
  if (tile % RUN != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define GNN_ARGS                                                                    \
  q_pos, q_nrm, m, slab, n_pad, tile_bounds, n_tiles, tile, run_bounds, perm, center, \
      r2, radj, slack, gate_thr, out_idx, out_d2, out_dot, s
  if (want_idx && use_abs_dot)
    launch<true, true>(GNN_ARGS);
  else if (want_idx)
    launch<true, false>(GNN_ARGS);
  else if (use_abs_dot)
    launch<false, true>(GNN_ARGS);
  else
    launch<false, false>(GNN_ARGS);
#undef GNN_ARGS
  return (int)cudaGetLastError();
}

// Residency of one instantiation on the current device, for the
// measurement (chip_smoke.py): sets its preferred shared-memory carveout
// (percent of the most the SM allows; -1 restores the driver's default),
// then writes out[0..3] = resident CTAs per SM (the occupancy calculator
// at 32 threads), registers per thread, static shared bytes per CTA and
// local (spill) bytes per thread.
extern "C" int gnn_kernel_info(int want_idx, int use_abs_dot, int carveout, int* out) {
  const void* fn = kernel_of(want_idx, use_abs_dot);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       carveout);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, WARP, 0);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}
