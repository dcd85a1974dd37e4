// Host emulation of convopeq_tpu_torch/csrc/frame_conv.cu, for checking
// the kernels' index and transform arithmetic on a machine without a GPU.
//
// Each block runs as one thread (blockDim.x == 1): the kernels stride
// their loops by blockDim.x, so one thread does the whole block's work,
// and __syncthreads() is a no-op.  It checks what each block computes,
// not races between threads, and it does not check that nvcc accepts
// the source.  Build:
//   g++ -O2 -std=c++17 -shared -fPIC -o libframe_conv_emu.so \
//       tests/frame_conv_host_emulation.cpp
#include <cmath>
#include <cstddef>
#include <vector>

#define FRAME_CONV_HOST_EMULATION 1

struct float2 {
  float x, y;
};
static inline float2 make_float2(float x, float y) { return float2{x, y}; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

static dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0), blockDim(1, 1, 1);
static float2* emu_smem = nullptr;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
static inline void __syncthreads() {}

static inline void sincospif(float x, float* s, float* c) {
  const double a = (double)x * M_PI;
  *s = (float)std::sin(a);
  *c = (float)std::cos(a);
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
  dim3 grid;
  size_t smem;
  template <class Kernel>
  auto operator()(Kernel kernel) const {
    const dim3 g = grid;
    const size_t bytes = smem;
    return [g, bytes, kernel](auto... args) {
      std::vector<float2> buf(bytes / sizeof(float2) + 1);
      emu_smem = buf.data();
      blockDim = dim3(1, 1, 1);
      threadIdx = dim3(0, 0, 0);
      for (unsigned by = 0; by < g.y; ++by)
        for (unsigned bx = 0; bx < g.x; ++bx) {
          blockIdx = dim3(bx, by, 0);
          kernel(args...);
        }
      emu_smem = nullptr;
    };
  }
};
}  // namespace emu

#define FC_LAUNCH(kernel, grid, block, smem, stream) \
  emu::Launch{(grid), (smem)}(kernel)
#define FC_DYNAMIC_SMEM(name) float2* name = emu_smem

#include "../convopeq_tpu_torch/csrc/frame_conv.cu"
