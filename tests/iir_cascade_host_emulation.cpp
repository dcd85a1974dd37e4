// Host emulation of convopeq_tpu_torch/csrc/iir_cascade.cu, for checking
// the kernel on a machine without a GPU, on the coroutine blocks of
// tests/cuda_host_emulation.h: every block runs its kThreads threads, the
// warp collectives are the header's, and the dynamic shared memory is one
// buffer of the block (blocks run one after another, so the first block's
// eight warps take every tile, in turn).
//
// IIR_INCLUSIVE_EVERY (default 1) lets only the tiles k with
// k % IIR_INCLUSIVE_EVERY == 0 publish their inclusive state, so that the
// look-back walks over the aggregates of the others.  Build (one line):
//   g++ -O2 -std=c++17 -fno-strict-aliasing -shared -fPIC
//       [-DIIR_INCLUSIVE_EVERY=3] -o libiir_cascade_emu.so
//       tests/iir_cascade_host_emulation.cpp
#include "cuda_host_emulation.h"

#define IIR_HOST_EMULATION 1

static void* emu_smem = nullptr;

#ifndef IIR_INCLUSIVE_EVERY
#define IIR_INCLUSIVE_EVERY 1
#endif
#define IIR_PUBLISH_INCLUSIVE(k) ((k) % IIR_INCLUSIVE_EVERY == 0)

using std::fma;

// explicitly rounded arithmetic: one IEEE operation each
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dsub_rn(double a, double b) { return a - b; }
static inline double __dmul_rn(double a, double b) { return a * b; }

static inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
static inline void __nanosleep(unsigned) {}
static inline void __threadfence() {}
static inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
static inline void __stcg(double* p, double v) { *p = v; }
static inline double __ldcg(const double* p) { return *p; }

enum { cudaDevAttrMultiProcessorCount = 16 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
static cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
static cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
static cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;
  return cudaSuccess;
}
template <class F>
static cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F,
                                                                 int,
                                                                 size_t) {
  *n = 1;
  return cudaSuccess;
}

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
      run_grid(g, b, [&]() { kernel(args...); });
      emu_smem = nullptr;
    };
  }
};
}  // namespace emu

#define IIR_LAUNCH(kernel, grid, block, smem, stream) \
  emu::Launch{(grid), (block), (size_t)(smem)}(kernel)
#define IIR_DYNAMIC_SMEM(type, name) \
  type& name = *reinterpret_cast<type*>(emu_smem)

#include "../convopeq_tpu_torch/csrc/iir_cascade.cu"
