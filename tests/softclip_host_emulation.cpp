// Host emulation of convopeq_tpu_torch/csrc/softclip.cu, for checking the
// kernel on a machine without a GPU, on the coroutine blocks of
// tests/cuda_host_emulation.h: every block runs its kThreads threads, and
// its static shared memory is a static of the kernel function, one for
// the block (blocks run one after another).  Build:
//   g++ -O2 -std=c++17 -fno-strict-aliasing -shared -fPIC \
//       -o libsoftclip_emu.so tests/softclip_host_emulation.cpp
#include "cuda_host_emulation.h"

#define SOFTCLIP_HOST_EMULATION 1
#define __shared__ static

namespace emu {
struct Launch {
  dim3 grid, block;
  template <class Kernel>
  auto operator()(Kernel kernel) const {
    const dim3 g = grid, b = block;
    return [g, b, kernel](auto... args) {
      run_grid(g, b, [&]() { kernel(args...); });
    };
  }
};
}  // namespace emu

#define SC_LAUNCH(kernel, grid, block, stream) \
  emu::Launch{(grid), (block)}(kernel)

#include "../convopeq_tpu_torch/csrc/softclip.cu"
