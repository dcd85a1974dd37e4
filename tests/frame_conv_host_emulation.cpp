// Host emulation of convopeq_tpu_torch/csrc/frame_conv.cu, for checking
// the kernels on a machine without a GPU.
//
// Each block runs with its blockDim.x threads (fused_packed_rows keeps
// values in per-thread registers and needs its real block size): each
// thread is a coroutine (ucontext) with its own stack, the dynamic shared
// memory is
// one buffer of the block, and __syncthreads() yields to a scheduler that
// resumes the threads in turn, so every thread reaches a barrier before
// any passes it.  It checks what the threads compute and where they meet,
// not races within a barrier interval, and it does not check that nvcc
// accepts the source.  Build:
//   g++ -O2 -std=c++17 -shared -fPIC -o libframe_conv_emu.so \
//       tests/frame_conv_host_emulation.cpp
#include <ucontext.h>

#include <cmath>
#include <cstddef>
#include <functional>
#include <vector>

#define FRAME_CONV_HOST_EMULATION 1

struct float2 {
  float x, y;
};
struct alignas(16) double2 {
  double x, y;
};
static inline float2 make_float2(float x, float y) { return float2{x, y}; }
static inline double2 make_double2(double x, double y) {
  return double2{x, y};
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

static dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0), blockDim(1, 1, 1);
static void* emu_smem = nullptr;

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
}  // namespace emu

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
static inline void __syncthreads() { emu::yield(); }

// explicitly rounded arithmetic: one IEEE operation each, fma unrounded
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fmaf_rn(float a, float b, float c) {
  return std::fma(a, b, c);
}
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline double __fma_rn(double a, double b, double c) {
  return std::fma(a, b, c);
}

static inline void sincospif(float x, float* s, float* c) {
  const double a = (double)x * M_PI;
  *s = (float)std::sin(a);
  *c = (float)std::cos(a);
}
static inline void sincospi(double x, double* s, double* c) {
  const long double a = (long double)x * 3.141592653589793238462643383279L;
  *s = (double)std::sin(a);
  *c = (double)std::cos(a);
}

typedef void* cudaStream_t;
typedef int cudaError_t;
static const cudaError_t cudaSuccess = 0;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
static cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
static cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace emu {
struct Launch {
  dim3 grid, block;
  size_t smem;
  template <class Kernel>
  auto operator()(Kernel kernel) const {
    const dim3 g = grid, b = block;
    const size_t bytes = smem;
    return [g, b, bytes, kernel](auto... args) {
      std::vector<double2> buf(bytes / sizeof(double2) + 1);
      emu_smem = buf.data();
      blockDim = b;
      const std::function<void()> fn = [&]() { kernel(args...); };
      for (unsigned by = 0; by < g.y; ++by)
        for (unsigned bx = 0; bx < g.x; ++bx) {
          blockIdx = dim3(bx, by, 0);
          run_block(b.x, fn);
        }
      emu_smem = nullptr;
    };
  }
};
}  // namespace emu

#define FC_LAUNCH(kernel, grid, block, smem, stream) \
  emu::Launch{(grid), (block), (smem)}(kernel)
#define FC_DYNAMIC_SMEM(type, name) \
  type* name = reinterpret_cast<type*>(emu_smem)

#include "../convopeq_tpu_torch/csrc/frame_conv.cu"
