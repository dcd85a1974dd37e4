// Host emulation of convopeq_tpu_torch/csrc/frame_conv.cu, for checking
// the kernels on a machine without a GPU, on the coroutine blocks of
// tests/cuda_host_emulation.h.
//
// Each block runs with its blockDim.x threads (fused_packed_rows keeps
// values in per-thread registers and needs its real block size), and the
// dynamic shared memory is one buffer of the block.  Build:
//   g++ -O2 -std=c++17 -shared -fPIC -o libframe_conv_emu.so \
//       tests/frame_conv_host_emulation.cpp
#include "cuda_host_emulation.h"

#define FRAME_CONV_HOST_EMULATION 1

static void* emu_smem = nullptr;

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

enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
static cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }

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

#define FC_LAUNCH(kernel, grid, block, smem, stream) \
  emu::Launch{(grid), (block), (smem)}(kernel)
#define FC_DYNAMIC_SMEM(type, name) \
  type* name = reinterpret_cast<type*>(emu_smem)

#include "../convopeq_tpu_torch/csrc/frame_conv.cu"
