// The local 2x soft clip (ops/softclip.py `soft_clip_local2x`) as one
// pass over the signal, for Hopper (sm_90a), f32 and f64.
//
// It replaces no Pallas kernel: on the TPU, XLA fused the clip's
// elementwise passes and its two 16-tap FIRs.  Under eager PyTorch the
// same function was two cuDNN convolutions, a pad and ~70 elementwise
// passes over the signal (~69 ms a call at R = 512 rows x N = 480,000
// f32 on an H100).  The polyphase form, with c the 16 conv-phase taps of
// the 31-tap halfband and clip the soft clip:
//
//   ue[t] = clip(2 sum_s c[s] x[t-s])                   (t >= -15)
//   y[n]  = 0.5 clip(0.5 x[n-15]) + sum_r c[r] ue[n-r]
//
// with x = 0 before each row's start (zero history), every row of N
// samples on its own.
//
// What bounds it on the card: y is read once and written once, 8 B a
// sample in f32 (1.97 GB at R = 512, N = 480,000: 0.587 ms at 3.35
// TB/s); its ~150 operations a sample (two 16-tap FIRs, two clips with
// three IEEE divisions each where |v| passes the knee's start) take
// about as long at the f32 rate.  So the kernel has to move each byte
// once and keep the FIRs' reuse on chip:
//
// - A block takes one row's tile of kN outputs (16 KB of them: 4,096 f32,
//   2,048 f64) and brings the tile's input with a 32-sample left halo
//   (30 are needed) into shared memory, in 16-byte loads, with zeros
//   before the row's start and past its end.  Only the halo is read
//   twice: < 1% more bytes.
// - Phase 1: each thread item computes ue for 4 consecutive times, from a
//   20-sample window of x read from shared memory in five 16-byte loads
//   (consecutive threads on consecutive 16-byte words: no bank
//   conflict), into shared memory; the 16 values of ue before the tile
//   (its halo) are recomputed by each tile.
// - Phase 2: each thread item computes 4 consecutive outputs from a
//   20-value window of ue and an 8-sample window of x, adds the second
//   FIR and the direct branch, and writes them with 16-byte stores.
// - The taps and the clip's constants are a kernel argument in the
//   signal's type, made on the host from doubles at each launch; nothing
//   is copied to the device.
//
// The clip is ops/softclip.py's `soft_clip` (and its `fast_tanh_clip`)
// operation for operation, with the knee <= 1e-9 hard clip chosen on the
// host and IEEE division; nvcc may contract a multiply and an add into
// one FMA, and the FIRs sum in their own order, so the f32 kernel agrees
// with the plain version to rounding, not bit for bit.
//
// With SOFTCLIP_HOST_EMULATION defined, SC_LAUNCH, __shared__ and the
// CUDA names used here come from the host emulator
// tests/softclip_host_emulation.cpp, which runs every thread of a block
// as a coroutine that yields at each barrier.

#ifndef SOFTCLIP_HOST_EMULATION
#include <cuda_runtime.h>
#define SC_LAUNCH(kernel, grid, block, stream) \
  kernel<<<(grid), (block), 0, (stream)>>>
#endif

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 16;      // conv-phase taps of the 31-tap halfband
constexpr int kThreads = 256;
constexpr int kItem = 4;       // consecutive outputs a thread item
constexpr int kWin = 20;       // a FIR's window for kItem outputs
constexpr int kHalo = 32;      // x samples before the tile (30 needed)
constexpr int kTileBytes = 16384;

// A 16-byte vector of T.
template <class T>
struct Vec;

template <>
struct Vec<float> {
  typedef float4 type;
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(float4 v, float* w) {
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  static __device__ __forceinline__ float4 pack(const float* w) {
    return make_float4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<double> {
  typedef double2 type;
  static constexpr int n = 2;
  static __device__ __forceinline__ void unpack(double2 v, double* w) {
    w[0] = v.x;
    w[1] = v.y;
  }
  static __device__ __forceinline__ double2 pack(const double* w) {
    return make_double2(w[0], w[1]);
  }
};

// A block's tile: kN outputs; xs[q] = x[m0 - kHalo + q], q < kX;
// us[j] = ue[m0 - 16 + j], j < kU (ue[m0 - 16] is never read).
template <class T>
struct Tile {
  typedef typename Vec<T>::type V;
  static constexpr int kVec = Vec<T>::n;
  static constexpr int kN = kTileBytes / sizeof(T);
  static constexpr int kX = kN + kHalo;
  static constexpr int kU = kN + 16;
  V xs[kX / kVec];
  V us[kU / kVec];
};

// The taps and the clip's constants in T (soft_clip's scalars as the
// plain version rounds them: each derived in double, then to T).
template <class T>
struct Params {
  T c[kTaps];
  T threshold, knee, clip_start, two_knee, asymmetry;
  int hard;  // knee <= 1e-9: the hard clip at +-threshold
};

template <class T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/softclip.py `soft_clip`, one value.
template <class T>
__device__ __forceinline__ T clip(T x, const Params<T>& p) {
  if (p.hard) return clamp(x, -p.threshold, p.threshold);
  const T ax = x < T(0) ? -x : x;
  if (!(ax > p.clip_start)) return x;
  const T sign = x > T(0) ? T(1) : T(-1);
  const T t = clamp((ax - p.clip_start) / p.two_knee, T(0), T(1));
  const T ks = t * t * (T(3) - T(2) * t);
  // fast_tanh_clip((ax - threshold) / knee)
  const T z = clamp((ax - p.threshold) / p.knee, T(-4.5), T(4.5));
  const T z2 = z * z;
  const T num = z * (T(10395) + z2 * (T(1260) + z2 * T(21)));
  const T den = T(10395) + z2 * (T(4725) + z2 * (T(210) + z2));
  const T clipped = p.threshold + p.knee * (num / den);
  const T mixed = ax + (clipped - ax) * ks;
  const T factor = T(1) - p.asymmetry * (T(1) - sign) * T(0.5) * ks;
  return sign * mixed * factor;
}

// w[0, W) from 16-byte aligned shared memory at p.
template <class T, int W>
__device__ __forceinline__ void load_window(const T* p, T (&w)[W]) {
  typedef Vec<T> Vt;
  const typename Vt::type* v = reinterpret_cast<const typename Vt::type*>(p);
#pragma unroll
  for (int i = 0; i < W / Vt::n; ++i) Vt::unpack(v[i], w + i * Vt::n);
}

template <class T>
__device__ __forceinline__ void store_item(T* p, const T (&o)[kItem]) {
  typedef Vec<T> Vt;
  typename Vt::type* v = reinterpret_cast<typename Vt::type*>(p);
#pragma unroll
  for (int i = 0; i < kItem / Vt::n; ++i) v[i] = Vt::pack(o + i * Vt::n);
}

// out[u] = sum_s c[s] w[16 + u - s], u < kItem
template <class T>
__device__ __forceinline__ void fir(const Params<T>& p, const T (&w)[kWin],
                                    T (&out)[kItem]) {
#pragma unroll
  for (int u = 0; u < kItem; ++u) {
    T acc = p.c[0] * w[16 + u];
#pragma unroll
    for (int s = 1; s < kTaps; ++s) acc += p.c[s] * w[16 + u - s];
    out[u] = acc;
  }
}

// One block a tile of one row: block b takes row b / tiles, tile b % tiles.
// vec: 16-byte loads and stores of x and y are aligned (both pointers
// 16-byte aligned, N a multiple of the vector).
template <class T>
__global__ void __launch_bounds__(kThreads)
    soft_clip_local2x_kernel(const T* __restrict__ x, T* __restrict__ y,
                             int N, int tiles, int vec, const Params<T> p) {
  typedef Tile<T> Tl;
  typedef typename Tl::V V;
  constexpr int kVec = Tl::kVec;
  __shared__ Tl sm;
  T* xs = reinterpret_cast<T*>(sm.xs);
  T* us = reinterpret_cast<T*>(sm.us);
  const long long row = blockIdx.x / tiles;
  const int m0 = (int)(blockIdx.x % tiles) * Tl::kN;
  const T* xr = x + row * N;
  T* yr = y + row * N;

  // the tile's input and its halo, zeros outside [0, N)
  for (int v = threadIdx.x; v < Tl::kX / kVec; v += blockDim.x) {
    const int g = m0 - kHalo + v * kVec;
    if (vec && g >= 0 && g + kVec <= N) {
      sm.xs[v] = *reinterpret_cast<const V*>(xr + g);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        xs[v * kVec + e] = (g + e >= 0 && g + e < N) ? xr[g + e] : T(0);
    }
  }
  __syncthreads();

  // phase 1: us[j + u] = clip(2 sum_s c[s] x[m0 - 16 + j + u - s])
  for (int j = kItem * threadIdx.x; j < Tl::kU; j += kItem * blockDim.x) {
    T w[kWin];
    load_window(xs + j, w);
    T a[kItem];
    fir(p, w, a);
#pragma unroll
    for (int u = 0; u < kItem; ++u) a[u] = clip(T(2) * a[u], p);
    store_item(us + j, a);
  }
  __syncthreads();

  // phase 2: y[m0 + k + u] = 0.5 clip(0.5 x[m0 + k + u - 15])
  //                          + sum_r c[r] ue[m0 + k + u - r]
  for (int k = kItem * threadIdx.x; k < Tl::kN; k += kItem * blockDim.x) {
    const int m = m0 + k;
    if (m >= N) break;
    T v[kWin];
    load_window(us + k, v);
    T h[2 * kItem];
    load_window(xs + k + 16, h);  // h[1 + u] = x[m + u - 15]
    T o[kItem];
    fir(p, v, o);
#pragma unroll
    for (int u = 0; u < kItem; ++u)
      o[u] = T(0.5) * clip(T(0.5) * h[1 + u], p) + o[u];
    if (vec && m + kItem <= N) {
      store_item(yr + m, o);
    } else {
#pragma unroll
      for (int u = 0; u < kItem; ++u)
        if (m + u < N) yr[m + u] = o[u];
    }
  }
}

template <class T>
int soft_clip_local2x_impl(const void* x, void* y, int R, int N,
                           const double* taps, double threshold, double knee,
                           double asymmetry, void* stream) {
  typedef Tile<T> Tl;
  if (R < 1 || N < 1) return -1;
  const int tiles = (N + Tl::kN - 1) / Tl::kN;
  const long long blocks = (long long)R * tiles;
  if (blocks > 2147483647LL) return -1;
  Params<T> p;
  for (int s = 0; s < kTaps; ++s) p.c[s] = (T)taps[s];
  p.threshold = (T)threshold;
  p.knee = (T)knee;
  p.clip_start = (T)(threshold - knee);
  p.two_knee = (T)(2.0 * knee);
  p.asymmetry = (T)asymmetry;
  p.hard = knee <= 1.0e-9;
  const int vec = N % Tl::kVec == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  SC_LAUNCH(soft_clip_local2x_kernel<T>, dim3((unsigned)blocks),
            dim3(kThreads), (cudaStream_t)stream)
  ((const T*)x, (T*)y, N, tiles, vec, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: R contiguous rows of N values (y may not alias x); taps: the 16
// conv-phase taps (host doubles); threshold, knee, asymmetry: soft_clip's
// parameters.  Returns 0 on success, -1 for an unsupported shape, else
// the CUDA error.
int soft_clip_local2x_f32(const void* x, void* y, int R, int N,
                          const double* taps, double threshold, double knee,
                          double asymmetry, void* stream) {
  return soft_clip_local2x_impl<float>(x, y, R, N, taps, threshold, knee,
                                       asymmetry, stream);
}

int soft_clip_local2x_f64(const void* x, void* y, int R, int N,
                          const double* taps, double threshold, double knee,
                          double asymmetry, void* stream) {
  return soft_clip_local2x_impl<double>(x, y, R, N, taps, threshold, knee,
                                        asymmetry, stream);
}

}  // extern "C"
