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
//
// The warp collectives (__shfl_sync, __shfl_up_sync, __shfl_xor_sync,
// __ballot_sync, __syncwarp) are yields too: each lane leaves its value
// in its warp's slot, yields, and reads its source's when it resumes.
// Threads resume in turn, so between a lane's yield and its return every
// other thread of the block runs once: the lanes of a warp that pass the
// same collectives in the same order (the whole warp, full mask) meet at
// each one.  Two slots alternate, so a lane that runs on into its next
// collective does not overwrite a value its warp still reads.
// __syncthreads counts the block's threads in: each yields until the
// last has arrived, then once more, so that the lanes of a warp leave
// it in the same round whatever collectives other warps pass meanwhile.
#pragma once

#include <ucontext.h>

#include <cmath>
#include <cstddef>
#include <cstring>
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

// a warp's exchange slots: two alternating values a lane, and each
// lane's next slot
struct WarpSlots {
  unsigned long long value[2][32];
  unsigned next[32];
};
static std::vector<WarpSlots> warp_slots;

static unsigned barrier_arrived = 0, barrier_generation = 0;

static void yield() { swapcontext(&threads[current], &scheduler); }

static void barrier() {
  const unsigned gen = barrier_generation;
  if (++barrier_arrived == threads.size()) {
    barrier_arrived = 0;
    ++barrier_generation;
  }
  do {
    yield();
  } while (barrier_generation == gen);
}

// Leaves `mine` in the calling lane's slot, yields, and returns the
// slot's values of all 32 lanes of its warp.
template <class T>
static void warp_exchange(T mine, T (&all)[32]) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "one slot a lane");
  WarpSlots& w = warp_slots[current / 32];
  const unsigned lane = current % 32, p = w.next[lane];
  w.next[lane] ^= 1u;
  std::memcpy(&w.value[p][lane], &mine, sizeof(T));
  yield();
  for (unsigned l = 0; l < 32; ++l)
    std::memcpy(&all[l], &w.value[p][l], sizeof(T));
}

static void trampoline() {
  (*body)();
  done[current] = true;
}  // returns to uc_link, the scheduler

// Runs `fn` as `nthreads` threads of one block, to the end.
static void run_block(unsigned nthreads, const std::function<void()>& fn) {
  threads.resize(nthreads);
  stacks.resize(nthreads * kStack);
  done.assign(nthreads, false);
  warp_slots.assign((nthreads + 31) / 32, WarpSlots{});
  barrier_arrived = 0;
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
static inline void __syncthreads() { emu::barrier(); }

static inline void __syncwarp(unsigned = 0xffffffffu) { emu::yield(); }

template <class T>
static T __shfl_sync(unsigned, T v, int src) {
  T all[32];
  emu::warp_exchange(v, all);
  return all[src & 31];
}

template <class T>
static T __shfl_up_sync(unsigned, T v, unsigned delta) {
  T all[32];
  emu::warp_exchange(v, all);
  const unsigned lane = emu::current % 32;
  return lane >= delta ? all[lane - delta] : v;
}

template <class T>
static T __shfl_xor_sync(unsigned, T v, int mask) {
  T all[32];
  emu::warp_exchange(v, all);
  return all[(emu::current % 32) ^ (mask & 31)];
}

static inline unsigned __ballot_sync(unsigned, int pred) {
  int all[32];
  emu::warp_exchange(pred, all);
  unsigned bits = 0;
  for (unsigned l = 0; l < 32; ++l)
    if (all[l]) bits |= 1u << l;
  return bits;
}

typedef void* cudaStream_t;
typedef int cudaError_t;
static const cudaError_t cudaSuccess = 0;
static cudaError_t cudaGetLastError() { return cudaSuccess; }
