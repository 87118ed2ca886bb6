// The LoD levels' greedy Poisson-disk pass, for NVIDIA Hopper (sm_90a).
// It replaces no Pallas kernel: the JAX package, like the reference
// (rs_pointcloud__compute_level_poisson, lib/rs/rs_pointcloud.h:985-1106),
// builds its levels on the host, with native/rescan_host.cpp's
// rescan_poisson_subsample. That pass walks level 0 in index order and keeps
// a point iff no point kept before it lies within the level's voxel r:
//   d = p_j - p_i,  d2 = (dx * dx + dy * dy) + dz * dz,  neighbours iff
//   d2 < r2 = r * r,
// each operation rounded in f32 (no contraction: this file is built with
// -fmad=false and writes the operations as round-to-nearest intrinsics).
//
// The kept set is the lexicographically first maximal independent set of
// the graph "d2 < r2", and it is computed here exactly, in rounds over a
// worklist of the undecided points (every point at first). A round is two
// passes over the worklist:
//   keep_kernel  a point whose earlier neighbours (index j < i) are all
//                dropped is kept;
//   drop_kernel  a point kept in this round drops its later neighbours
//                (j > i), as the greedy pass does: a kept point is rare
//                at the coarse levels, so pushing from it walks far fewer
//                windows than each undecided point looking for a kept one.
// then the points still undecided are compacted, in order, into the next
// worklist. Each pass reads only the state that the pass itself cannot
// write (keep reads "dropped", drop "kept" and writes "dropped" only over
// "undecided": a later neighbour of a point kept in a round is never kept
// in it), so a round decides the same points however its threads
// interleave: the rounds, and the result, are deterministic. The lowest
// undecided point is decided in every round (its earlier neighbours are all
// dropped: a kept one would have dropped it), so the loop ends; on level 0
// in the scans' random order the undecided points shrink geometrically and
// a level takes a handful of rounds. Afterwards the kept flags are
// compacted in index order: the ascending indices rescan_poisson_subsample
// returns.
//
// The grid (one a level): cells of side `cell` >= r (chosen by the caller,
// ops/levels.py, with a margin over r so that float rounding in the cell
// index never puts two neighbours two cells apart), cell id
// (cy * nz + cz) * nx + cx as in hashgrid.cu, so a row of three x-adjacent
// cells is one contiguous run of the sorted points, and a point's window is
// the nine runs of its 3 x 3 (y, z) rows. It is built here by a counting
// sort: a histogram (atomicAdd, whose return value is the point's place in
// its cell), an exclusive scan of the counts, a scatter. The order within a
// cell depends on the atomics, which changes nothing: a point's decision
// depends on the set of its neighbours, not on their order.
//
// Every scan (the cells' counts, the worklist, the kept flags) is the same
// three passes: tile_sum_kernel (one sum per tile of TILE elements),
// tiles_scan_kernel (one block a level scans its tiles' sums), and
// tile_apply_kernel (each tile's own exclusive scan plus its offset).
//
// One launch serves every level (up to MAX_LEVELS): its blocks are cut into
// per-level ranges (Launch::first), so a round is five launches whatever
// the number of levels. A round reads its worklists' lengths on the device
// and writes the next round's there, so the host queues several rounds at
// once (poisson_rounds), each launched over a bound of its lengths that the
// host knows, and reads their lengths and the kept counts after them in one
// small copy: the threads and blocks past a worklist's end return at once,
// and a round over empty worklists does nothing.
//
// What bounds it: the windows, walked one point a thread. A point reads the
// sorted points of its nine runs (16 bytes each, x y z and its index) until
// it can decide, and a kept point all of them, one dependent load after
// another: a round lasts as long as its longest walk (a kept point at the
// coarsest level, ~1,500 points), not as long as its bytes or its total
// walks (PERF.md). The sorted points of a
// scan (~14 MB) stay in the 50 MB L2 across the passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // threads a block
constexpr int ITEMS = 4;                // elements a thread in the scans
constexpr int TILE = THREADS * ITEMS;   // elements a block in the scans
constexpr int MAX_LEVELS = 4;

constexpr int UNDECIDED = 0, KEPT = 1, DROPPED = 2;

}  // namespace

// One level, as the caller lays it out (ops/levels.py mirrors it with
// ctypes). Every array is on the device.
struct PoissonLevel {
  float ox, oy, oz;   // the grid's origin
  float inv;          // f32(1 / cell)
  int nx, ny, nz;     // the grid's cells along x, y, z
  float r2;           // f32(voxel) * f32(voxel)
  int ncells;         // nx * ny * nz
  int pad;
  int* cell_start;    // (ncells + 1,) zeros in; the cells' counts, then offsets
  int* cell;          // (n,) each point's cell
  int* rank;          // (n,) each point's place in its cell
  int* slot;          // (n,) each point's place in the sorted order
  float4* sorted;     // (n,) x y z and the point's index (as bits)
  int* state;         // (n,) UNDECIDED / KEPT / DROPPED, by sorted place
  int* work;          // (n,) this round's worklist (sorted places)
  int* next;          // (n,) the next round's
  int* tile_sum;      // (ceil((max(n, ncells) + 1) / TILE),) per-tile sums
  int* out;           // (kept,) the kept indices, ascending
};

namespace {

enum Mode { CELLS = 0, WORK = 1, OUT = 2 };

struct Launch {
  PoissonLevel lv[MAX_LEVELS];
  int len[MAX_LEVELS];            // elements of this launch, per level (a
                                  // bound of len_in's where that is set)
  int first[MAX_LEVELS + 1];      // the first block of each level
  int nlev;
  const int* len_in;              // a round: its worklists' lengths, or null
  int* len_out;                   // a round: the next worklists' lengths
  int* kept;                      // a round: grows by the points kept
};

// Level l's elements in this launch: a round's worklist length, read on
// the device, else len[l].
__device__ __forceinline__ int length_of(const Launch& a, int l) {
  return a.len_in ? a.len_in[l] : a.len[l];
}

// The level of this block, and the block's place within the level.
__device__ __forceinline__ int level_of(const Launch& a, int& b) {
  int l = 0;
  while (l + 1 < a.nlev && (int)blockIdx.x >= a.first[l + 1]) ++l;
  b = (int)blockIdx.x - a.first[l];
  return l;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int axis_cell(float q, float o, float inv, int n) {
  return clampi(__float2int_rd(__fmul_rn(__fsub_rn(q, o), inv)), 0, n - 1);
}

__device__ __forceinline__ float dist2(float4 a, float4 b) {
  const float dx = __fsub_rn(b.x, a.x), dy = __fsub_rn(b.y, a.y),
              dz = __fsub_rn(b.z, a.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Walk the window of the sorted point p until visit(q, c) returns true for
// the point c at sorted place q; true if it did.
template <class Visit>
__device__ __forceinline__ bool walk(const PoissonLevel& L, float4 p, Visit visit) {
  const int cx = axis_cell(p.x, L.ox, L.inv, L.nx);
  const int cy = axis_cell(p.y, L.oy, L.inv, L.ny);
  const int cz = axis_cell(p.z, L.oz, L.inv, L.nz);
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, L.nx - 1);
  for (int yy = max(cy - 1, 0); yy <= min(cy + 1, L.ny - 1); ++yy) {
    for (int zz = max(cz - 1, 0); zz <= min(cz + 1, L.nz - 1); ++zz) {
      const int row = (yy * L.nz + zz) * L.nx;
      const int e = L.cell_start[row + x1 + 1];
      for (int q = L.cell_start[row + x0]; q < e; ++q)
        if (visit(q, L.sorted[q])) return true;
    }
  }
  return false;
}

// --- the grid ---------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) cell_hist_kernel(Launch a, const float* points) {
  int b;
  const int l = level_of(a, b);
  const PoissonLevel& L = a.lv[l];
  const int i = b * THREADS + threadIdx.x;
  if (i >= a.len[l]) return;
  const float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
  const int c = (axis_cell(y, L.oy, L.inv, L.ny) * L.nz + axis_cell(z, L.oz, L.inv, L.nz)) *
                    L.nx + axis_cell(x, L.ox, L.inv, L.nx);
  L.cell[i] = c;
  L.rank[i] = atomicAdd(&L.cell_start[c], 1);
}

__global__ void __launch_bounds__(THREADS) cell_scatter_kernel(Launch a, const float* points) {
  int b;
  const int l = level_of(a, b);
  const PoissonLevel& L = a.lv[l];
  const int i = b * THREADS + threadIdx.x;
  if (i >= a.len[l]) return;
  const int s = L.cell_start[L.cell[i]] + L.rank[i];
  L.slot[i] = s;
  L.sorted[s] = make_float4(points[3 * i], points[3 * i + 1], points[3 * i + 2],
                            __int_as_float(i));
  L.state[s] = UNDECIDED;
  L.work[s] = s;
}

// --- a round ----------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) keep_kernel(Launch a) {
  int b;
  const int l = level_of(a, b);
  const PoissonLevel& L = a.lv[l];
  const int t = b * THREADS + threadIdx.x;
  if (t >= length_of(a, l)) return;
  const int s = L.work[t];
  const float4 p = L.sorted[s];
  const int i = __float_as_int(p.w);
  if (walk(L, p, [&](int q, float4 c) {
        return __float_as_int(c.w) < i && dist2(p, c) < L.r2 && L.state[q] != DROPPED;
      }))
    return;
  L.state[s] = KEPT;
  atomicAdd(&a.kept[l], 1);
}

__global__ void __launch_bounds__(THREADS) drop_kernel(Launch a) {
  int b;
  const int l = level_of(a, b);
  const PoissonLevel& L = a.lv[l];
  const int t = b * THREADS + threadIdx.x;
  if (t >= length_of(a, l)) return;
  const int s = L.work[t];
  if (L.state[s] != KEPT) return;
  const float4 p = L.sorted[s];
  const int i = __float_as_int(p.w);
  walk(L, p, [&](int q, float4 c) {
    if (__float_as_int(c.w) > i && dist2(p, c) < L.r2 && L.state[q] == UNDECIDED)
      L.state[q] = DROPPED;
    return false;
  });
}

// --- the scans --------------------------------------------------------------

// Element k's value in a scan of the given mode.
template <int MODE>
__device__ __forceinline__ int value_of(const PoissonLevel& L, int k) {
  if (MODE == CELLS) return L.cell_start[k];
  if (MODE == WORK) return L.state[L.work[k]] == UNDECIDED;
  return L.state[L.slot[k]] == KEPT;
}

// The exclusive prefix of v over the block's threads; `total` the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int s[THREADS];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const int add = threadIdx.x >= (unsigned)off ? s[threadIdx.x - off] : 0;
    __syncthreads();
    s[threadIdx.x] += add;
    __syncthreads();
  }
  const int incl = s[threadIdx.x];
  total = s[THREADS - 1];
  __syncthreads();  // s is read before the next scan writes it
  return incl - v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) tile_sum_kernel(Launch a) {
  int b;
  const int l = level_of(a, b);
  const PoissonLevel& L = a.lv[l];
  const int len = length_of(a, l);
  if (b * TILE >= len) return;  // the whole block: no tile to sum
  const int k0 = b * TILE + threadIdx.x * ITEMS;
  int v = 0;
  for (int k = k0; k < min(k0 + ITEMS, len); ++k) v += value_of<MODE>(L, k);
  int total;
  block_exclusive_scan(v, total);
  if (threadIdx.x == 0) L.tile_sum[b] = total;
}

// One block a level: the tiles' sums become their exclusive offsets; in a
// round the level's total goes to len_out[level].
__global__ void __launch_bounds__(THREADS) tiles_scan_kernel(Launch a) {
  const int l = blockIdx.x;
  const PoissonLevel& L = a.lv[l];
  const int tiles = (length_of(a, l) + TILE - 1) / TILE;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += THREADS) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? L.tile_sum[t] : 0;
    int total;
    const int ex = block_exclusive_scan(v, total);
    if (t < tiles) L.tile_sum[t] = carry + ex;
    carry += total;
  }
  if (a.len_out && threadIdx.x == 0) a.len_out[l] = carry;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) tile_apply_kernel(Launch a) {
  int b;
  const int l = level_of(a, b);
  const PoissonLevel& L = a.lv[l];
  const int len = length_of(a, l);
  if (b * TILE >= len) return;  // the whole block
  const int k0 = b * TILE + threadIdx.x * ITEMS;
  const int k1 = min(k0 + ITEMS, len);
  int v[ITEMS];
  int sum = 0;
  for (int u = 0; u < ITEMS; ++u) {
    v[u] = k0 + u < k1 ? value_of<MODE>(L, k0 + u) : 0;
    sum += v[u];
  }
  int total;
  int pos = L.tile_sum[b] + block_exclusive_scan(sum, total);
  for (int u = 0; u < ITEMS && k0 + u < k1; ++u) {
    const int k = k0 + u;
    if (MODE == CELLS)
      L.cell_start[k] = pos;
    else if (v[u] && MODE == WORK)
      L.next[pos] = L.work[k];
    else if (v[u])
      L.out[pos] = k;
    pos += v[u];
  }
}

// --- launches -----------------------------------------------------------------

// A launch over `len[l]` elements of each level, `per` elements a block
// (no round: len_in, len_out and kept null).
Launch make_launch(const PoissonLevel* lv, int nlev, const int* len, int per, unsigned& blocks) {
  Launch a{};
  a.nlev = nlev;
  a.first[0] = 0;
  for (int l = 0; l < nlev; ++l) {
    a.lv[l] = lv[l];
    a.len[l] = len[l];
    a.first[l + 1] = a.first[l] + (len[l] + per - 1) / per;
  }
  blocks = (unsigned)a.first[nlev];
  return a;
}

int check_levels(int nlev) {
  return nlev < 1 || nlev > MAX_LEVELS ? (int)cudaErrorInvalidValue : 0;
}

// A scan over len[l] elements of each level; in a round (MODE WORK) over
// len_in's, which len bounds, its totals into len_out.
template <int MODE>
int scan(const PoissonLevel* lv, int nlev, const int* len, const int* len_in, int* len_out,
         cudaStream_t s) {
  unsigned blocks;
  Launch a = make_launch(lv, nlev, len, TILE, blocks);
  a.len_in = len_in;
  a.len_out = len_out;
  if (blocks) tile_sum_kernel<MODE><<<blocks, THREADS, 0, s>>>(a);
  tiles_scan_kernel<<<(unsigned)nlev, THREADS, 0, s>>>(a);
  if (blocks) tile_apply_kernel<MODE><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// allocates nothing, and returns cudaGetLastError(), so a refused launch is
// reported at once.

// The levels' grids over the n points (x y z rows): each level's
// cell_start zeroed by the caller.
extern "C" int poisson_grid(const PoissonLevel* lv, int nlev, const float* points, int n,
                            void* stream) {
  if (int rc = check_levels(nlev)) return rc;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int len[MAX_LEVELS];
  for (int l = 0; l < nlev; ++l) len[l] = n;
  unsigned blocks;
  const Launch a = make_launch(lv, nlev, len, THREADS, blocks);
  cell_hist_kernel<<<blocks, THREADS, 0, s>>>(a, points);
  int cells[MAX_LEVELS];
  for (int l = 0; l < nlev; ++l) cells[l] = lv[l].ncells + 1;
  if (int rc = scan<CELLS>(lv, nlev, cells, nullptr, nullptr, s)) return rc;
  cell_scatter_kernel<<<blocks, THREADS, 0, s>>>(a, points);
  return (int)cudaGetLastError();
}

// `rounds` rounds over each level's worklist of sorted places, queued at
// once. Round r reads the worklists' lengths lens[r * MAX_LEVELS + l] (row
// 0 set by the caller), compacts the points still undecided into the other
// worklist and writes their number to lens[(r + 1) * MAX_LEVELS + l]; the
// worklists alternate between work (round 0's) and next. m[l] bounds row
// 0's lengths, hence every row's, and sizes every round's launches.
// kept[l] (zeroed by the caller before the first round) grows by the
// points kept.
extern "C" int poisson_rounds(const PoissonLevel* lv, int nlev, const int* m, int rounds,
                              int* lens, int* kept, void* stream) {
  if (int rc = check_levels(nlev)) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  PoissonLevel cur[MAX_LEVELS];
  for (int l = 0; l < nlev; ++l) cur[l] = lv[l];
  for (int r = 0; r < rounds; ++r) {
    const int* len_in = lens + r * MAX_LEVELS;
    int* len_out = lens + (r + 1) * MAX_LEVELS;
    unsigned blocks;
    Launch a = make_launch(cur, nlev, m, THREADS, blocks);
    a.len_in = len_in;
    a.kept = kept;
    if (blocks) {
      keep_kernel<<<blocks, THREADS, 0, s>>>(a);
      drop_kernel<<<blocks, THREADS, 0, s>>>(a);
    }
    if (int rc = scan<WORK>(cur, nlev, m, len_in, len_out, s)) return rc;
    for (int l = 0; l < nlev; ++l) {
      int* w = cur[l].work;
      cur[l].work = cur[l].next;
      cur[l].next = w;
    }
  }
  return 0;
}

// The kept points of each level, their indices ascending, into its out.
extern "C" int poisson_output(const PoissonLevel* lv, int nlev, int n, void* stream) {
  if (int rc = check_levels(nlev)) return rc;
  if (n <= 0) return 0;
  int len[MAX_LEVELS];
  for (int l = 0; l < nlev; ++l) len[l] = n;
  return scan<OUT>(lv, nlev, len, nullptr, nullptr, (cudaStream_t)stream);
}

extern "C" int poisson_max_levels() { return MAX_LEVELS; }
