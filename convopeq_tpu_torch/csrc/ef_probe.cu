// Latency probes for the error-feedback quantizer
// (csrc/error_feedback_quantize.cu), built beside it with the same flags
// (-fmad=false) by `python -m convopeq_tpu_torch.sweep probe`.  Not part of
// any path: they say what a step of the quantizer's recurrence costs on
// the card, in SM cycles read with clock64().
//
//   ef_probe_clock   the SM clock: clock64() against %globaltimer over a
//                    spin of `spins` iterations of one thread
//   ef_probe_step    (b) the quantizer's per-sample step (ef_step), one
//                    warp of 32 rows, fed from registers: xh and d of 8
//                    samples a row held in registers and replayed, no
//                    shared memory, no staging; with either rounding
//                    (rint, or the folded add pair)
//   ef_probe_tile    the chain warp's loop over one row of a stage
//                    (ef_run_tile), replayed over one stage in shared
//                    memory: the chain warp's shared loads and stores,
//                    without the copy warp
//   ef_probe_ops     (c) dependent chains of one instruction each (f32 and
//                    f64 add, multiply, NaN-passing max, round to
//                    integer, a shared-memory load chase), of a
//                    multiply and the kernel's clamp in f32 and f64, and
//                    of the kernel's rounding to the grid (ef_round) in
//                    f32 and f64, rint or folded, without and with the
//                    clamp of q
#include "error_feedback_quantize.cu"

namespace {

__global__ void ef_probe_clock_kernel(long long* out, int spins) {
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  long long c = c0;
  for (int i = 0; i < spins; ++i) c = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  out[0] = c - c0;
  out[1] = (long long)(ns1 - ns0);
}

constexpr int kProbeRegs = 8;  // samples a row replayed from registers

template <typename T, int MODE, int ORDER, bool FOLD>
__global__ void __launch_bounds__(32)
    ef_probe_step_kernel(const T* in, T* out, long long* cycles, int n,
                         EfConsts<T> k) {
  const int r = threadIdx.x;
  T xr[kProbeRegs], dr[kProbeRegs];
#pragma unroll
  for (int j = 0; j < kProbeRegs; ++j) {
    const T* v = in + (r * kProbeRegs + j) * 3;
    xr[j] = ef_xh(v[0], k);
    dr[j] = ef_dither<T, MODE>(v[1], v[2], k);
  }
  T s[ORDER];
#pragma unroll
  for (int i = 0; i < ORDER; ++i) s[i] = T(0);
  T acc = T(0);
  __syncwarp();
  const long long c0 = clock64();
  for (int t = 0; t < n; t += kProbeRegs) {
#pragma unroll
    for (int j = 0; j < kProbeRegs; ++j)
      acc = acc + ef_step<T, MODE, ORDER, FOLD>(xr[j], dr[j], s, k);
  }
  const long long c1 = clock64();
  out[r] = acc + s[0];
  if (r == 0) cycles[0] = c1 - c0;
}

template <typename T, int MODE, int ORDER, bool FOLD>
__global__ void __launch_bounds__(32)
    ef_probe_tile_kernel(const T* in, T* out, long long* cycles, int n,
                         EfConsts<T> k) {
  using Tl = EfTile<T>;
  extern __shared__ __align__(16) unsigned char ef_probe_smem[];
  T* const xq = reinterpret_cast<T*>(ef_probe_smem);
  T* const d = xq + kEfRows * Tl::kLd;
  const int r = threadIdx.x;
  for (int j = 0; j < Tl::kSteps; ++j) {
    const T* v = in + (r * kProbeRegs + j % kProbeRegs) * 3;
    xq[r * Tl::kLd + j] = ef_xh(v[0], k);
    d[r * Tl::kLd + j] = ef_dither<T, MODE>(v[1], v[2], k);
  }
  T s[ORDER];
#pragma unroll
  for (int i = 0; i < ORDER; ++i) s[i] = T(0);
  const int steps = n < Tl::kSteps ? n : Tl::kSteps;  // a runtime count
  __syncwarp();
  const long long c0 = clock64();
  for (int t = 0; t < n; t += Tl::kSteps)
    ef_run_tile<T, MODE, ORDER, FOLD>(xq + r * Tl::kLd, d + r * Tl::kLd,
                                      steps, s, k);
  const long long c1 = clock64();
  out[r] = xq[r * Tl::kLd] + s[0];
  if (r == 0) cycles[0] = c1 - c0;
}

// 16 dependent instructions, one asm statement each
#define EF_PROBE_16(op)                                                    \
  do {                                                                     \
    op; op; op; op; op; op; op; op; op; op; op; op; op; op; op; op;        \
  } while (0)

template <int OP>
__device__ long long ef_probe_chain(float& v, double& w, float a, double b,
                                    int reps) {
  const long long c0 = clock64();
  for (int i = 0; i < reps; ++i) {
    if (OP == 0) EF_PROBE_16(asm volatile("add.f32 %0, %0, %1;" : "+f"(v) : "f"(a)));
    if (OP == 1) EF_PROBE_16(asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(v) : "f"(a)));
    if (OP == 2) EF_PROBE_16(asm volatile("max.NaN.f32 %0, %0, %1;" : "+f"(v) : "f"(a)));
    if (OP == 3) EF_PROBE_16(asm volatile("cvt.rni.f32.f32 %0, %0;" : "+f"(v)));
    if (OP == 4) EF_PROBE_16(asm volatile("add.f64 %0, %0, %1;" : "+d"(w) : "d"(b)));
    if (OP == 5) EF_PROBE_16(asm volatile("mul.rn.f64 %0, %0, %1;" : "+d"(w) : "d"(b)));
    if (OP == 6) EF_PROBE_16(asm volatile("max.f64 %0, %0, %1;" : "+d"(w) : "d"(b)));
    if (OP == 7) EF_PROBE_16(asm volatile("cvt.rni.f64.f64 %0, %0;" : "+d"(w)));
  }
  return clock64() - c0;
}

// a multiply, then the kernel's clamp (ef_clamp), 16 times over
template <typename T>
__device__ long long ef_probe_mul_clamp(T& v, T a, int reps) {
  const long long c0 = clock64();
  for (int i = 0; i < reps; ++i)
    EF_PROBE_16(v = ef_clamp(v * a, T(-0.5), T(0.75)));
  return clock64() - c0;
}

// the kernel's rounding to the grid, 16 times over
template <typename T, bool CLAMP, bool FOLD>
__device__ long long ef_probe_round(T& v, const EfConsts<T>& k, int reps) {
  const long long c0 = clock64();
  for (int i = 0; i < reps; ++i)
    EF_PROBE_16((v = ef_round<T, CLAMP, FOLD>(v, k)));
  return clock64() - c0;
}

// the 8 chains above, the shared chase, the multiply-and-clamp in f32 and
// f64, and the roundings: f32 rint, folded, rint with the clamp of q,
// folded with it, then the same in f64
constexpr int kProbeOps = 19;

__global__ void __launch_bounds__(32)
    ef_probe_ops_kernel(long long* cycles, float a, double b, int reps,
                        EfConsts<float> kf, EfConsts<double> kd) {
  // each entry holds the shared address of the next: a chase of loads
  __shared__ unsigned chase[256];
  const unsigned base = (unsigned)__cvta_generic_to_shared(chase);
  for (int i = threadIdx.x; i < 256; i += 32)
    chase[i] = base + 4u * ((i + 33) & 255);
  __syncwarp();
  float v = a;
  double w = b;
  long long c[kProbeOps];
  c[0] = ef_probe_chain<0>(v, w, a, b, reps);
  c[1] = ef_probe_chain<1>(v, w, a, b, reps);
  c[2] = ef_probe_chain<2>(v, w, a, b, reps);
  c[3] = ef_probe_chain<3>(v, w, a, b, reps);
  c[4] = ef_probe_chain<4>(v, w, a, b, reps);
  c[5] = ef_probe_chain<5>(v, w, a, b, reps);
  c[6] = ef_probe_chain<6>(v, w, a, b, reps);
  c[7] = ef_probe_chain<7>(v, w, a, b, reps);
  unsigned j = base + 4u * threadIdx.x;
  const long long c0 = clock64();
  for (int i = 0; i < reps; ++i)
    EF_PROBE_16(asm volatile("ld.shared.u32 %0, [%0];" : "+r"(j)));
  c[8] = clock64() - c0;
  c[9] = ef_probe_mul_clamp(v, a, reps);
  c[10] = ef_probe_mul_clamp(w, b, reps);
  c[11] = ef_probe_round<float, false, false>(v, kf, reps);
  c[12] = ef_probe_round<float, false, true>(v, kf, reps);
  c[13] = ef_probe_round<float, true, false>(v, kf, reps);
  c[14] = ef_probe_round<float, true, true>(v, kf, reps);
  c[15] = ef_probe_round<double, false, false>(w, kd, reps);
  c[16] = ef_probe_round<double, false, true>(w, kd, reps);
  c[17] = ef_probe_round<double, true, false>(w, kd, reps);
  c[18] = ef_probe_round<double, true, true>(w, kd, reps);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kProbeOps; ++i) cycles[i] = c[i];
    cycles[kProbeOps] = (long long)(v + (float)w + (float)j);
  }
}

// tile = 0: ef_probe_step_kernel; 1: ef_probe_tile_kernel; fold: the
// rounding's form (1 the folded add pair: scale must allow it, ef_folds)
template <typename T>
int ef_probe_step(const void* in, void* out, void* cycles, int n, int mode,
                  const double* coeffs, int order, double scale,
                  double headroom, int tile, int fold) {
  using Tl = EfTile<T>;
  if (n < Tl::kSteps || n % Tl::kSteps || n % kProbeRegs) return -1;
  if (fold && !ef_folds<T>(mode, scale)) return -1;
  const EfConsts<T> k = ef_consts<T>(coeffs, order, scale, headroom);
  const size_t smem = (size_t)kEfRows * 2 * Tl::kLd * sizeof(T);
  return ef_dispatch(mode, order, [&](auto m, auto o) -> int {
    constexpr int M = decltype(m)::value;
    constexpr int O = decltype(o)::value;
    auto launch = [&](auto f) {
      constexpr bool F = decltype(f)::value;
      if (tile)
        ef_probe_tile_kernel<T, M, O, F><<<1, 32, smem>>>(
            (const T*)in, (T*)out, (long long*)cycles, n, k);
      else
        ef_probe_step_kernel<T, M, O, F><<<1, 32>>>(
            (const T*)in, (T*)out, (long long*)cycles, n, k);
      return (int)cudaGetLastError();
    };
    return fold ? launch(std::true_type()) : launch(std::false_type());
  });
}

}  // namespace

extern "C" {

int ef_probe_clock(void* out, int spins) {
  ef_probe_clock_kernel<<<1, 1>>>((long long*)out, spins);
  return (int)cudaGetLastError();
}

// in: 32 rows x 8 samples x (x, u0, u1); out: 32 values; cycles: 1
int ef_probe_step_f32(const void* in, void* out, void* cycles, int n,
                      int mode, const double* coeffs, int order,
                      double scale, double headroom, int tile, int fold) {
  return ef_probe_step<float>(in, out, cycles, n, mode, coeffs, order, scale,
                              headroom, tile, fold);
}

int ef_probe_step_f64(const void* in, void* out, void* cycles, int n,
                      int mode, const double* coeffs, int order,
                      double scale, double headroom, int tile, int fold) {
  return ef_probe_step<double>(in, out, cycles, n, mode, coeffs, order, scale,
                               headroom, tile, fold);
}

// cycles: kProbeOps + 1 values, each the cycles of 16 * reps instructions
// (of 16 * reps roundings for the last eight); the roundings at scale_f32
// and scale_f64 (powers of two that fold in every mode)
int ef_probe_ops(void* cycles, int reps, double scale_f32, double scale_f64) {
  if (!ef_folds<float>(EF_LATTICE_FIR, scale_f32) ||
      !ef_folds<double>(EF_LATTICE_FIR, scale_f64))
    return -1;
  ef_probe_ops_kernel<<<1, 32>>>((long long*)cycles, 1.0000001f, 1.0000001,
                                 reps, ef_consts<float>(nullptr, 0, scale_f32,
                                                        1.0),
                                 ef_consts<double>(nullptr, 0, scale_f64,
                                                   1.0));
  return (int)cudaGetLastError();
}

int ef_probe_op_count() { return kProbeOps; }

}  // extern "C"
