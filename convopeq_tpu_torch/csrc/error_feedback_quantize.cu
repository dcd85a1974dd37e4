// Sequential error-feedback dither quantizer, for Hopper (sm_90a), f32 and
// f64.  Replaces the TPU Pallas kernel of
// convopeq_tpu/ops/pallas_kernels.py:47 error_feedback_quantize (body
// `kernel`, :116; pallas_call :203), the last stage of every render to a
// fixed bit depth (convopeq_tpu/models/dither.py apply_dither).
//
// What it computes: per row r (stream x channel) and sample t, in order,
//   psycho       tmp = (x*h + d) + fb;  q = rint(tmp/scale)*scale;
//                err = tmp - q;  shift err into the 12-tap history
//   fixed        y = x*h - fb;  q = rint((clamp(y, -1, 1-scale) + d)
//                /scale)*scale;  err = clamp(q - y, +-2 scale); shift
//   fixed15      fixed, with q clamped to [-1, 1-scale] after rounding
//   lattice      y = x*h + fb;  q as fixed15;  err = clamp(q - y, +-2
//                scale) drives the 9-stage lattice advance with the
//                per-stage clamp +-2 (LatticeNoiseShaper.h:229-295,
//                defect included)
//   lattice_fir  the same with the textbook analysis-ladder store
//                (models/dither.py lattice_dither ladder="fir")
// where fb = c0*s0 + c1*s1 + ... summed left to right, d is the TPDF term
// formed as the JAX wrapper forms it (pallas_kernels.py:97-100), and
// rint rounds half to even.  Every multiply and every add is rounded on
// its own: the library is built with -fmad=false, because these
// trajectories are chaotic at the ULP level and a contracted multiply-add
// flips a rounding decision within a few hundred samples.  The kernel is
// then bit-identical to its plain PyTorch version (one op per launch),
// and its f64 build to the reference binary (built -ffp-contract=off).
//
// Design: one thread per row, the shaper state and the coefficients in
// registers (the coefficients arrive by value in the kernel's
// arguments).  A block is one warp of 32 rows.  It stages [32 rows x 64
// samples] tiles of x and of the uniforms through shared memory with
// time-contiguous, coalesced cp.async loads, double-buffered so that the
// next tile's loads are in flight during the sequential loop, and writes
// q through a shared tile the same way.  x, u and q keep their (R, N) /
// (R, N, 2) layouts: no transpose pass, no padding; the ragged last tile
// is masked, so the state returned is the state after sample N.  Rows
// are padded by one element in shared memory so that the 32 threads,
// each reading its own row at the same t, hit 32 different banks.
//
// What bounds it (config6: R = 512 rows, N = 480,000 samples, f32,
// lattice_fir): device traffic is 16 B a sample (x, two uniforms, q),
// 3.9 GB, about 1.2 ms at 3.35 TB/s; the arithmetic is ~83 f32 ops a
// sample, 20 GFLOP, 0.3 ms at 67 TFLOP/s.  But each row is one
// dependency chain: the feedback sum, the quantizer and the ladder are
// ~25-35 dependent f32 ops a step, so 480,000 steps take tens of ms
// whatever R is, and only R / 32 = 16 of the card's 132 SMs hold a warp.
// The chain, not memory, binds this kernel; shortening it would change
// the summation order, which the bit-exact contract forbids.  Measured
// on an H100 80GB HBM3 at 700 W: ~121 ms at that shape, ~252 ns a step,
// the same with one warp as with 16 and several times the chain's
// estimate (PERF.md).
//
// With EF_QUANTIZE_HOST_EMULATION defined only the arithmetic below (the
// per-sample step, the per-tile loop of one row, the constants and the
// mode dispatch) is compiled, for the host emulator
// tests/quantize_host_emulation.cpp, built with g++ -ffp-contract=off.

#ifndef EF_QUANTIZE_HOST_EMULATION
#include <cuda_runtime.h>
#define EF_HD __host__ __device__ __forceinline__
#else
#define EF_HD inline
#endif

#include <cmath>
#include <stddef.h>
#include <type_traits>

namespace {

enum { EF_PSYCHO = 0, EF_FIXED = 1, EF_FIXED15 = 2, EF_LATTICE = 3,
       EF_LATTICE_FIR = 4 };

constexpr int kEfMaxOrder = 16;
constexpr int kEfRows = 32;             // rows a block: one warp
constexpr int kEfTile = 64;             // samples a tile
constexpr int kEfLdx = kEfTile + 1;     // shared row stride of x and q
constexpr int kEfLdu = 2 * kEfTile + 1; // shared row stride of u

template <typename T>
struct EfConsts {
  T c[kEfMaxOrder];
  T headroom, scale, inv_scale, hi, err_lim, state_lim;
};

template <typename T>
EfConsts<T> ef_consts(const double* coeffs, int order, double scale,
                      double headroom) {
  EfConsts<T> k{};
  for (int i = 0; i < order && i < kEfMaxOrder; ++i) k.c[i] = (T)coeffs[i];
  k.headroom = (T)headroom;
  k.scale = (T)scale;
  k.inv_scale = (T)(1.0 / scale);
  k.hi = (T)(1.0 - scale);
  k.err_lim = (T)(2.0 * scale);
  k.state_lim = (T)2.0;
  return k;
}

EF_HD float ef_rint(float v) {
#ifdef __CUDA_ARCH__
  return rintf(v);
#else
  return std::rint(v);
#endif
}
EF_HD double ef_rint(double v) {
#ifdef __CUDA_ARCH__
  return rint(v);
#else
  return std::rint(v);
#endif
}

// min(max(v, lo), hi), NaN passing through (as torch.clamp).  f32 on the
// card: the NaN-propagating max and min instructions, two where the
// compare-and-select form takes four, with the same results.
template <typename T>
EF_HD T ef_clamp(T v, T lo, T hi) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same<T, float>::value) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(hi));
    return r;
  }
#endif
  return v < lo ? lo : (v > hi ? hi : v);
}

// One sample of one row: returns q, advances the state s in place.
template <typename T, int MODE, int ORDER>
EF_HD T ef_step(T xi, T u0, T u1, T (&s)[ORDER], const EfConsts<T>& k) {
  T fb = k.c[0] * s[0];
#pragma unroll
  for (int i = 1; i < ORDER; ++i) fb = fb + k.c[i] * s[i];
  constexpr bool kLattice = MODE == EF_LATTICE || MODE == EF_LATTICE_FIR;
  T q, err;
  if (MODE == EF_PSYCHO) {
    const T d = ((u0 - T(0.5)) + (u1 - T(0.5))) * k.scale;
    const T tmp = (xi * k.headroom + d) + fb;
    q = ef_rint(tmp * k.inv_scale) * k.scale;
    err = tmp - q;
  } else {
    const T d = ((u0 + u1) - T(1)) * k.scale;
    const T y = kLattice ? xi * k.headroom + fb : xi * k.headroom - fb;
    q = ef_rint((ef_clamp(y, T(-1), k.hi) + d) * k.inv_scale) * k.scale;
    if (MODE != EF_FIXED) q = ef_clamp(q, T(-1), k.hi);
    err = ef_clamp(q - y, -k.err_lim, k.err_lim);
  }
  if (MODE == EF_LATTICE) {
    // reference advanceState: s[i] <- clamp(k_i f_i + s[i])
    T fwd = err;
#pragma unroll
    for (int i = 0; i < ORDER; ++i) {
      const T si = s[i];
      const T nf = fwd + k.c[i] * si;
      s[i] = ef_clamp(k.c[i] * fwd + si, -k.state_lim, k.state_lim);
      fwd = nf;
    }
  } else if (MODE == EF_LATTICE_FIR) {
    // analysis ladder: s[i] <- clamp(g_{i-1}), g_{-1} = err
    T fwd = err, gprev = err;
#pragma unroll
    for (int i = 0; i < ORDER; ++i) {
      const T si = s[i];
      const T nf = fwd + k.c[i] * si;
      const T ng = k.c[i] * fwd + si;
      s[i] = ef_clamp(gprev, -k.state_lim, k.state_lim);
      gprev = ng;
      fwd = nf;
    }
  } else {
#pragma unroll
    for (int i = ORDER - 1; i > 0; --i) s[i] = s[i - 1];
    s[0] = err;
  }
  return q;
}

// `steps` samples of one row from a tile: x at xs[t], the uniforms at
// us[2t], us[2t+1]; q to qs[t].
template <typename T, int MODE, int ORDER>
EF_HD void ef_run_tile(const T* xs, const T* us, T* qs, int steps,
                       T (&s)[ORDER], const EfConsts<T>& k) {
#pragma unroll 4
  for (int t = 0; t < steps; ++t)
    qs[t] = ef_step<T, MODE, ORDER>(xs[t], us[2 * t], us[2 * t + 1], s, k);
}

// The (mode, order) pairs the kernel is built for: calls
// f(integral_constant<MODE>, integral_constant<ORDER>), or returns -1.
template <class F>
int ef_dispatch(int mode, int order, F&& f) {
  using std::integral_constant;
  switch (mode) {
    case EF_PSYCHO:
      if (order == 12)
        return f(integral_constant<int, EF_PSYCHO>(),
                 integral_constant<int, 12>());
      break;
    case EF_FIXED:
      if (order == 4)
        return f(integral_constant<int, EF_FIXED>(),
                 integral_constant<int, 4>());
      if (order == 16)
        return f(integral_constant<int, EF_FIXED>(),
                 integral_constant<int, 16>());
      break;
    case EF_FIXED15:
      if (order == 4)
        return f(integral_constant<int, EF_FIXED15>(),
                 integral_constant<int, 4>());
      if (order == 16)
        return f(integral_constant<int, EF_FIXED15>(),
                 integral_constant<int, 16>());
      break;
    case EF_LATTICE:
      if (order == 9)
        return f(integral_constant<int, EF_LATTICE>(),
                 integral_constant<int, 9>());
      break;
    case EF_LATTICE_FIR:
      if (order == 9)
        return f(integral_constant<int, EF_LATTICE_FIR>(),
                 integral_constant<int, 9>());
      break;
  }
  return -1;
}

#ifndef EF_QUANTIZE_HOST_EMULATION

template <typename T>
struct EfArgs {
  const T* x;         // (R, N)
  const T* u;         // (R, N, 2)
  const T* state_in;  // (R, ORDER)
  T* q;               // (R, N)
  T* state_out;       // (R, ORDER)
  int R, N;
};

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(saddr),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issue the loads of the tile at t0 (one commit group), coalesced: the
// warp reads each row's samples with neighbouring threads on
// neighbouring addresses.
template <typename T>
__device__ void ef_load_tile(const EfArgs<T>& a, int row0, int t0, T* sx,
                             T* su) {
  const int steps = min(kEfTile, a.N - t0);
  const int rows = min(kEfRows, a.R - row0);
  for (int r = 0; r < rows; ++r) {
    const size_t off = (size_t)(row0 + r) * a.N + t0;
    const T* xr = a.x + off;
    const T* ur = a.u + 2 * off;
    for (int j = threadIdx.x; j < steps; j += blockDim.x)
      cp_async_elem(sx + r * kEfLdx + j, xr + j);
    for (int j = threadIdx.x; j < 2 * steps; j += blockDim.x)
      cp_async_elem(su + r * kEfLdu + j, ur + j);
  }
  cp_async_commit();
}

template <typename T, int MODE, int ORDER>
__global__ void __launch_bounds__(kEfRows)
    ef_quantize_kernel(EfArgs<T> a, EfConsts<T> k) {
  extern __shared__ __align__(16) unsigned char ef_smem[];
  T* const base = reinterpret_cast<T*>(ef_smem);
  T* const sx0 = base;
  T* const sx1 = sx0 + kEfRows * kEfLdx;
  T* const su0 = sx1 + kEfRows * kEfLdx;
  T* const su1 = su0 + kEfRows * kEfLdu;
  T* const sq = su1 + kEfRows * kEfLdu;
  const int row0 = blockIdx.x * kEfRows;
  const int row = row0 + threadIdx.x;
  const bool active = row < a.R;

  T s[ORDER];
#pragma unroll
  for (int i = 0; i < ORDER; ++i)
    s[i] = active ? a.state_in[(size_t)row * ORDER + i] : T(0);

  const int ntiles = (a.N + kEfTile - 1) / kEfTile;
  ef_load_tile(a, row0, 0, sx0, su0);
  for (int tile = 0; tile < ntiles; ++tile) {
    const bool odd = tile & 1;
    const int t0 = tile * kEfTile;
    if (tile + 1 < ntiles)
      ef_load_tile(a, row0, t0 + kEfTile, odd ? sx0 : sx1, odd ? su0 : su1);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const int steps = min(kEfTile, a.N - t0);
    if (active)
      ef_run_tile<T, MODE, ORDER>(
          (odd ? sx1 : sx0) + threadIdx.x * kEfLdx,
          (odd ? su1 : su0) + threadIdx.x * kEfLdu, sq + threadIdx.x * kEfLdx,
          steps, s, k);
    __syncthreads();
    const int rows = min(kEfRows, a.R - row0);
    for (int r = 0; r < rows; ++r) {
      T* qr = a.q + (size_t)(row0 + r) * a.N + t0;
      for (int j = threadIdx.x; j < steps; j += blockDim.x)
        qr[j] = sq[r * kEfLdx + j];
    }
    // the next iteration's barrier orders these reads of sq before the
    // next tile's writes
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) a.state_out[(size_t)row * ORDER + i] = s[i];
  }
}

template <typename T>
int ef_launch(const void* x, const void* u, const void* state_in, void* q,
              void* state_out, int R, int N, int mode, const double* coeffs,
              int order, double scale, double headroom, void* stream) {
  if (R < 0 || N < 0 || order < 1 || order > kEfMaxOrder) return -1;
  const EfConsts<T> k = ef_consts<T>(coeffs, order, scale, headroom);
  const EfArgs<T> a{(const T*)x, (const T*)u, (const T*)state_in, (T*)q,
                    (T*)state_out, R, N};
  const size_t smem =
      (size_t)kEfRows * (3 * kEfLdx + 2 * kEfLdu) * sizeof(T);
  return ef_dispatch(mode, order, [&](auto m, auto o) -> int {
    constexpr int M = decltype(m)::value;
    constexpr int O = decltype(o)::value;
    if (R == 0) return 0;
    const cudaError_t err = cudaFuncSetAttribute(
        ef_quantize_kernel<T, M, O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ef_quantize_kernel<T, M, O><<<(R + kEfRows - 1) / kEfRows, kEfRows, smem,
                                  (cudaStream_t)stream>>>(a, k);
    return (int)cudaGetLastError();
  });
}

#endif  // EF_QUANTIZE_HOST_EMULATION

}  // namespace

#ifndef EF_QUANTIZE_HOST_EMULATION
extern "C" {

// x (R, N), u (R, N, 2), state_in and state_out (R, order), q (R, N), all
// contiguous, of the library's type; coeffs: `order` host doubles.
// Returns 0 on success, -1 for an unsupported mode, order or shape, else
// the CUDA error.
int error_feedback_quantize_f32(const void* x, const void* u,
                                const void* state_in, void* q,
                                void* state_out, int R, int N, int mode,
                                const double* coeffs, int order, double scale,
                                double headroom, void* stream) {
  return ef_launch<float>(x, u, state_in, q, state_out, R, N, mode, coeffs,
                          order, scale, headroom, stream);
}

int error_feedback_quantize_f64(const void* x, const void* u,
                                const void* state_in, void* q,
                                void* state_out, int R, int N, int mode,
                                const double* coeffs, int order, double scale,
                                double headroom, void* stream) {
  return ef_launch<double>(x, u, state_in, q, state_out, R, N, mode, coeffs,
                           order, scale, headroom, stream);
}

}  // extern "C"
#endif  // EF_QUANTIZE_HOST_EMULATION
