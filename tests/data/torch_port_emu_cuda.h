// Host emulation of the CUDA subset that rescan_tpu_torch/ops/csrc/gnn.cu,
// pairsum.cu (with xla_math.cuh), hashgrid.cu and levels.cu use, so that their kernel
// logic can be built with g++ and run on the CPU
// (tests/test_torch_gnn_emulated.py, tests/test_torch_pairsum.py,
// tests/test_torch_hashgrid.py, tests/test_torch_dense_nn.py,
// tests/test_torch_levels.py). In emulate_launch a block is one warp: 32
// std::threads that meet at a barrier for every warp collective; in
// emulate_block_launch a block of 32 threads is the same, and a larger
// block (no warp collective) is one fiber a thread on the calling thread,
// each run in turn up to its next __syncthreads, the order reversed every
// other round and the first round's order alternating from block to block
// and from launch to launch, so that a read that races a write shows in
// either order, in the first phase too, wherever a launch has two blocks or
// a test launches twice; blocks run one after another. cp.async becomes a plain copy; the f32 and f64
// intrinsics are the host's IEEE operations (fmaf and fma are correctly
// rounded fused multiply-adds).
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <ucontext.h>

#include <algorithm>
#include <barrier>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

// 16-byte aligned, as on the card: a float4 access off 16 bytes faults
// there, and g++'s aligned moves make it fault here too
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
static thread_local dim3 threadIdx;
static dim3 blockIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// residency means nothing on the host: the queries report zeros
enum cudaFuncAttribute { cudaFuncAttributePreferredSharedMemoryCarveout };
struct cudaFuncAttributes {
  int numRegs;
  size_t sharedSizeBytes, localSizeBytes;
};
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int,
                                                                 size_t) {
  *n = 0;
  return cudaSuccess;
}
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) {
  *a = {};
  return cudaSuccess;
}

using std::max;  // CUDA's device min/max
using std::min;

inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __fma_rn(double a, double b, double c) { return fma(a, b, c); }
inline float __double2float_rn(double a) { return static_cast<float>(a); }
inline int __double2int_rz(double a) { return static_cast<int>(a); }
// cvt.rmi.s32.f32: floor, saturated to int32, NaN to 0
inline int __float2int_rd(float a) {
  if (a != a) return 0;
  const float f = floorf(a);
  if (f >= 2147483648.0f) return INT32_MAX;
  if (f < -2147483648.0f) return INT32_MIN;
  return static_cast<int>(f);
}
inline float __uint_as_float(unsigned v) {
  float f;
  memcpy(&f, &v, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned v;
  memcpy(&v, &f, 4);
  return v;
}
inline int __float_as_int(float f) { return static_cast<int>(__float_as_uint(f)); }
inline float __int_as_float(int v) { return __uint_as_float(static_cast<unsigned>(v)); }
// the old value, as on the card
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(v); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

static std::barrier<>* g_warp;
static unsigned g_ballot;
static float g_lanes[32];

inline void __syncwarp() { g_warp->arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, bool b) {
  g_warp->arrive_and_wait();
  if (threadIdx.x == 0) g_ballot = 0;
  g_warp->arrive_and_wait();
  if (b) __atomic_fetch_or(&g_ballot, 1u << threadIdx.x, __ATOMIC_SEQ_CST);
  g_warp->arrive_and_wait();
  const unsigned r = g_ballot;
  g_warp->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  g_lanes[threadIdx.x] = v;
  g_warp->arrive_and_wait();
  const float r = g_lanes[threadIdx.x ^ o];
  g_warp->arrive_and_wait();
  return r;
}
// one barrier a shuffle: the lanes write one of two buffers by turns, and a
// buffer is written again only after every lane has passed the next
// shuffle's barrier, so after all its readers
static float g_shfl[2][32];
static thread_local unsigned g_shfl_turn;
inline float __shfl_sync(unsigned, float v, int src) {
  float* buf = g_shfl[g_shfl_turn++ & 1];
  buf[threadIdx.x] = v;
  g_warp->arrive_and_wait();
  return buf[src & 31];
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  static unsigned lanes[32];
  lanes[threadIdx.x] = v;
  g_warp->arrive_and_wait();
  const unsigned r = lanes[src];
  g_warp->arrive_and_wait();
  return r;
}

// stands in for kernel<<<grid, 32>>>(...)
inline void emulate_launch(unsigned grid, const std::function<void()>& body) {
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> warp(32);
    g_warp = &warp;
    std::vector<std::thread> lanes;
    for (unsigned l = 0; l < 32; ++l)
      lanes.emplace_back([&body, l] {
        threadIdx.x = l;
        body();
      });
    for (auto& t : lanes) t.join();
  }
}

// stands in for kernel<<<grid, threads>>>(...) of a kernel that meets at
// __syncthreads
static std::barrier<>* g_block;
// the fibers of a block of more than a warp: the scheduler's context, each
// thread's, and whether it has ended
static ucontext_t g_sched;
static std::vector<ucontext_t> g_fiber;
static std::vector<char> g_fiber_done;
static const std::function<void()>* g_fiber_body;
static bool g_in_fibers;
// fiber launches so far: their parity sets the first round's order
static unsigned g_fiber_launches;
inline void __syncthreads() {
  if (g_in_fibers)
    swapcontext(&g_fiber[threadIdx.x], &g_sched);
  else
    g_block->arrive_and_wait();
}
inline void fiber_entry() {
  (*g_fiber_body)();
  g_fiber_done[threadIdx.x] = 1;
}
inline void emulate_block_launch(unsigned grid, unsigned threads,
                                 const std::function<void()>& body) {
  if (threads == 32) {
    // a block of one warp: its warp collectives meet at the block's barrier
    for (unsigned b = 0; b < grid; ++b) {
      blockIdx.x = b;
      std::barrier<> block(threads);
      g_block = g_warp = &block;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < threads; ++t)
        ts.emplace_back([&body, t] {
          threadIdx.x = t;
          body();
        });
      for (auto& t : ts) t.join();
    }
    return;
  }
  constexpr size_t STACK = 256 << 10;
  std::unique_ptr<char[]> stacks(new char[threads * STACK]);
  g_fiber.assign(threads, ucontext_t{});
  g_fiber_done.assign(threads, 0);
  g_fiber_body = &body;
  g_in_fibers = true;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) {
      ucontext_t& c = g_fiber[t];
      getcontext(&c);
      c.uc_stack.ss_sp = stacks.get() + t * STACK;
      c.uc_stack.ss_size = STACK;
      c.uc_link = &g_sched;
      makecontext(&c, fiber_entry, 0);
      g_fiber_done[t] = 0;
    }
    // a round: every live thread up to its next barrier or its end; the
    // first round backward in every other block and launch
    for (unsigned round = (b + g_fiber_launches) & 1, live = threads; live; ++round) {
      live = 0;
      for (unsigned k = 0; k < threads; ++k) {
        const unsigned t = round & 1 ? threads - 1 - k : k;
        if (g_fiber_done[t]) continue;
        threadIdx.x = t;
        swapcontext(&g_sched, &g_fiber[t]);
        live += !g_fiber_done[t];
      }
    }
  }
  g_in_fibers = false;
  ++g_fiber_launches;
}
