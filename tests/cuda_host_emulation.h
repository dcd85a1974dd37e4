// What the host emulators of the port's CUDA sources share: the CUDA
// names a kernel uses, and blocks whose threads run as coroutines.
//
// Each block runs with its blockDim.x threads: each thread is a coroutine
// (ucontext) with its own stack, and __syncthreads() yields to a
// scheduler that resumes the threads in turn, so every thread reaches a
// barrier before any passes it.  It checks what the threads compute and
// where they meet, not races within a barrier interval, and it does not
// check that nvcc accepts the source.  A source's own emulator
// (tests/*_host_emulation.cpp) includes this header, adds what only its
// source uses and includes the source.
#pragma once

#include <ucontext.h>

#include <cmath>
#include <cstddef>
#include <functional>
#include <vector>

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) double2 {
  double x, y;
};
static inline float2 make_float2(float x, float y) { return float2{x, y}; }
static inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
static inline double2 make_double2(double x, double y) {
  return double2{x, y};
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

static dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0), blockDim(1, 1, 1);

namespace emu {
constexpr size_t kStack = 256 * 1024;
static ucontext_t scheduler;
static std::vector<ucontext_t> threads;
static std::vector<char> stacks;
static std::vector<bool> done;
static unsigned current = 0;
static const std::function<void()>* body = nullptr;

static void yield() { swapcontext(&threads[current], &scheduler); }

static void trampoline() {
  (*body)();
  done[current] = true;
}  // returns to uc_link, the scheduler

// Runs `fn` as `nthreads` threads of one block, to the end.
static void run_block(unsigned nthreads, const std::function<void()>& fn) {
  threads.resize(nthreads);
  stacks.resize(nthreads * kStack);
  done.assign(nthreads, false);
  body = &fn;
  for (unsigned t = 0; t < nthreads; ++t) {
    getcontext(&threads[t]);
    threads[t].uc_stack.ss_sp = stacks.data() + t * kStack;
    threads[t].uc_stack.ss_size = kStack;
    threads[t].uc_link = &scheduler;
    makecontext(&threads[t], trampoline, 0);
  }
  unsigned live = nthreads;
  while (live > 0) {
    for (unsigned t = 0; t < nthreads; ++t) {
      if (done[t]) continue;
      current = t;
      threadIdx = dim3(t, 0, 0);
      swapcontext(&scheduler, &threads[t]);
      if (done[t]) --live;
    }
  }
}

// Runs `fn` as every block of the grid `g`, one block after another, each
// with b.x threads.
static void run_grid(dim3 g, dim3 b, const std::function<void()>& fn) {
  blockDim = b;
  for (unsigned by = 0; by < g.y; ++by)
    for (unsigned bx = 0; bx < g.x; ++bx) {
      blockIdx = dim3(bx, by, 0);
      run_block(b.x, fn);
    }
}
}  // namespace emu

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
static inline void __syncthreads() { emu::yield(); }

typedef void* cudaStream_t;
typedef int cudaError_t;
static const cudaError_t cudaSuccess = 0;
static cudaError_t cudaGetLastError() { return cudaSuccess; }
