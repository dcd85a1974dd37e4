// Cycle probes of the causal frame MAC (csrc/frame_conv.cu), built beside
// it with the same flags by `python -m convopeq_tpu_torch.sweep probe mac`.
// Not part of any path: they say what sets the time of a MAC design on the
// card, in SM cycles read with clock64().
//
//   mac_probe_ring   the ring MAC that frame_conv.cu's replaced (one
//                    thread a bin walks the K frames of its channel,
//                    keeping the last P values of its bin in a
//                    shared-memory ring beside its P partition values;
//                    one accumulator; two shared loads a multiply-add),
//                    instrumented: each block writes the cycles from its
//                    first barrier to its last.  kLoopOnly keeps only the
//                    j loop, over a ring filled once, with no global
//                    load, ring store or Y store a frame: the rest of the
//                    full kernel's cycles is its per-frame work.
//   mac_probe_ring_occupancy, mac_probe_occupancy  blocks an SM of the
//                    ring MAC (as its mac_tile launched it) and of
//                    frame_conv.cu's causal_mac_kernel (as mac_block
//                    launches it), from
//                    cudaOccupancyMaxActiveBlocksPerMultiprocessor:
//                    shared memory and registers both count.
//   mac_probe_form   frame_conv.cu's MAC with another multiply-add in
//                    place of the shipped one (two multiplies, two fused
//                    multiply-adds and two adds, 14 register operands):
//                    MacFused, the complex multiply-add as four fused
//                    multiply-adds into the accumulator (12 operands), and
//                    MacHalf, two of them (6 operands; not the function):
//                    what the FP instructions and their operands cost.
#include "frame_conv.cu"

namespace {

// bins a block of the ring MAC for P (its mac_tile)
template <class T>
int ring_tile(int P) {
  for (int bt = 128; bt >= 32; bt >>= 1)
    if ((size_t)2 * P * bt * sizeof(T) <= (size_t)kMacSmemMax) return bt;
  return 0;
}

template <class T, bool kLoopOnly>
__global__ void mac_probe_ring_kernel(const T* __restrict__ X,
                                      const T* __restrict__ H,
                                      T* __restrict__ Yout, int K, int B,
                                      int P, int bt, long long* cycles) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  T* ring = fc_smem;
  T* hs = fc_smem + P * bt;
  const int c = blockIdx.x;
  const int b0 = blockIdx.y * bt;
  const int nb = (B - b0 < bt) ? (B - b0) : bt;
  __syncthreads();
  const long long c0 = clock64();
  for (int lb = threadIdx.x; lb < nb; lb += blockDim.x) {
    const int b = b0 + lb;
    for (int j = 0; j < P; ++j) hs[j * bt + lb] = H[(size_t)j * B + b];
    const T* Xc = X + (size_t)c * K * B + b;
    T* Yc = Yout + (size_t)c * K * B + b;
    if (kLoopOnly) {
      for (int f = 0; f < P; ++f)
        ring[f * bt + lb] = Xc[(size_t)(f < K ? f : K - 1) * B];
      T tot = Cx<T>::make(Real(0), Real(0));
      int slot = 0;
      for (int f = 0; f < K; ++f) {
        const int jmax = (f < P - 1) ? f : (P - 1);
        T acc = Cx<T>::make(Real(0), Real(0));
        int s = slot;
        for (int j = 0; j <= jmax; ++j) {
          const T xv = ring[s * bt + lb];
          const T hv = hs[j * bt + lb];
          acc.x += xv.x * hv.x - xv.y * hv.y;
          acc.y += xv.x * hv.y + xv.y * hv.x;
          s = (s == 0) ? (P - 1) : (s - 1);
        }
        tot = cadd(tot, acc);
        slot = (slot + 1 == P) ? 0 : (slot + 1);
      }
      Yc[0] = tot;
      continue;
    }
    int slot = 0;
    T xn = Xc[0];
    for (int f = 0; f < K; ++f) {
      const T xf = xn;
      if (f + 1 < K) xn = Xc[(size_t)(f + 1) * B];
      ring[slot * bt + lb] = xf;
      const int jmax = (f < P - 1) ? f : (P - 1);
      T acc = Cx<T>::make(Real(0), Real(0));
      int s = slot;
      for (int j = 0; j <= jmax; ++j) {
        const T xv = ring[s * bt + lb];
        const T hv = hs[j * bt + lb];
        acc.x += xv.x * hv.x - xv.y * hv.y;
        acc.y += xv.x * hv.y + xv.y * hv.x;
        s = (s == 0) ? (P - 1) : (s - 1);
      }
      Yc[(size_t)f * B] = acc;
      slot = (slot + 1 == P) ? 0 : (slot + 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    cycles[blockIdx.y * gridDim.x + blockIdx.x] = clock64() - c0;
}

// one block (blocks = 1) or the whole grid of the ring MAC; cycles: one
// value a block
template <class T>
int mac_probe_ring(const void* X, const void* H, void* Y, int C, int K,
                   int B, int P, int loop_only, int one_block,
                   void* cycles) {
  const int bt = ring_tile<T>(P);
  if (bt == 0) return -1;
  const dim3 grid = one_block ? dim3(1, 1) : dim3(C, (B + bt - 1) / bt);
  const size_t smem = (size_t)2 * P * bt * sizeof(T);
  if (loop_only)
    return launch_kernel(mac_probe_ring_kernel<T, true>, grid, bt, smem, 0,
                         (const T*)X, (const T*)H, (T*)Y, K, B, P, bt,
                         (long long*)cycles);
  return launch_kernel(mac_probe_ring_kernel<T, false>, grid, bt, smem, 0,
                       (const T*)X, (const T*)H, (T*)Y, K, B, P, bt,
                       (long long*)cycles);
}

struct MacFused {
  static __device__ __forceinline__ void step(float2& acc, float2 x,
                                              float2 h) {
    acc.x = fmaf(x.x, h.x, acc.x);
    acc.x = fmaf(-x.y, h.y, acc.x);
    acc.y = fmaf(x.x, h.y, acc.y);
    acc.y = fmaf(x.y, h.x, acc.y);
  }
  static __device__ __forceinline__ void step(double2& acc, double2 x,
                                              double2 h) {
    acc.x = fma(x.x, h.x, acc.x);
    acc.x = fma(-x.y, h.y, acc.x);
    acc.y = fma(x.x, h.y, acc.y);
    acc.y = fma(x.y, h.x, acc.y);
  }
};

struct MacHalf {
  static __device__ __forceinline__ void step(float2& acc, float2 x,
                                              float2 h) {
    acc.x = fmaf(x.x, h.x, acc.x);
    acc.y = fmaf(x.y, h.y, acc.y);
  }
  static __device__ __forceinline__ void step(double2& acc, double2 x,
                                              double2 h) {
    acc.x = fma(x.x, h.x, acc.x);
    acc.y = fma(x.y, h.y, acc.y);
  }
};

template <class T>
int mac_probe_form(int form, const void* X, const void* H, void* Y, int C,
                   int K, int B, int P) {
  return form == 0
             ? causal_mac_impl<T, MacFused>(X, H, Y, C, K, B, P, nullptr)
             : causal_mac_impl<T, MacHalf>(X, H, Y, C, K, B, P, nullptr);
}

template <class Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            threads, smem);
}

}  // namespace

extern "C" {

int mac_probe_ring_c64(const void* X, const void* H, void* Y, int C, int K,
                       int B, int P, int loop_only, int one_block,
                       void* cycles) {
  return mac_probe_ring<float2>(X, H, Y, C, K, B, P, loop_only, one_block,
                                cycles);
}

int mac_probe_ring_c128(const void* X, const void* H, void* Y, int C, int K,
                        int B, int P, int loop_only, int one_block,
                        void* cycles) {
  return mac_probe_ring<double2>(X, H, Y, C, K, B, P, loop_only, one_block,
                                 cycles);
}

// out: (blocks an SM, threads a block, shared bytes a block, bins a
// block) of the ring MAC at P partitions, complex128 when c128
int mac_probe_ring_occupancy(int P, int c128, int* out) {
  const size_t item = c128 ? sizeof(double2) : sizeof(float2);
  const int bt = c128 ? ring_tile<double2>(P) : ring_tile<float2>(P);
  if (bt == 0) return -1;
  const size_t smem = 2 * P * bt * item;
  out[1] = bt;
  out[2] = (int)smem;
  out[3] = bt;
  return c128 ? occupancy(mac_probe_ring_kernel<double2, false>, bt, smem,
                          out)
              : occupancy(mac_probe_ring_kernel<float2, false>, bt, smem,
                          out);
}

// form 0: MacFused, 1: MacHalf
int mac_probe_form_c64(int form, const void* X, const void* H, void* Y,
                       int C, int K, int B, int P) {
  return mac_probe_form<float2>(form, X, H, Y, C, K, B, P);
}

int mac_probe_form_c128(int form, const void* X, const void* H, void* Y,
                        int C, int K, int B, int P) {
  return mac_probe_form<double2>(form, X, H, Y, C, K, B, P);
}

// out: (blocks an SM, threads a block, shared bytes a block, channels a
// block) of frame_conv.cu's MAC for C channels of P partitions
int mac_probe_occupancy(int C, int P, int c128, int* out) {
  const int G = c128 ? mac_block<double2>(C, P) : mac_block<float2>(C, P);
  if (G == 0) return -1;
  const size_t smem = c128 ? mac_smem<double2>(P, G) : mac_smem<float2>(P, G);
  out[1] = 32 * G;
  out[2] = (int)smem;
  out[3] = G;
  return c128 ? occupancy(causal_mac_kernel<double2>, 32 * G, smem, out)
              : occupancy(causal_mac_kernel<float2>, 32 * G, smem, out);
}

}  // extern "C"
