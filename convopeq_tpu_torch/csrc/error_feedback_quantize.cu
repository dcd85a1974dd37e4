// Sequential error-feedback dither quantizer, for Hopper (sm_90a), f32 and
// f64.  Replaces the TPU Pallas kernel of
// convopeq_tpu/ops/pallas_kernels.py:47 error_feedback_quantize (body
// `kernel`, :116; pallas_call :203), the last stage of every render to a
// fixed bit depth (convopeq_tpu/models/dither.py apply_dither).
//
// What it computes: per row r (stream x channel) and sample t, in order,
//   psycho       tmp = (xh + d) + fb;  q = rint(tmp/scale)*scale;
//                err = tmp - q;  shift err into the 12-tap history
//   fixed        y = xh - fb;  q = rint((clamp(y, -1, 1-scale) + d)
//                /scale)*scale;  err = clamp(q - y, +-2 scale); shift
//   fixed15      fixed, with q clamped to [-1, 1-scale] after rounding
//   lattice      y = xh + fb;  q as fixed15;  err = clamp(q - y, +-2
//                scale) drives the 9-stage lattice advance with the
//                per-stage clamp +-2 (LatticeNoiseShaper.h:229-295,
//                defect included)
//   lattice_fir  the same with the textbook analysis-ladder store
//                (models/dither.py lattice_dither ladder="fir")
// where xh = x*headroom, fb = c0*s0 + c1*s1 + ... summed left to right, d
// is the TPDF term formed as the JAX wrapper forms it
// (pallas_kernels.py:97-100): ((u0 + u1) - 1)*scale, psycho's ((u0 - .5)
// + (u1 - .5))*scale, and rint rounds half to even.  Where scale is a
// power of two, the rounding is folded into one add pair (ef_round):
// with K = 2^(digits-1)*scale (1.0 for 24 bits in f32), |v| < K rounds to
// the grid as z = (|v| + K) - K, since the ulp of [K, 2K) is scale and K /
// scale is even, and q = copysign(z, v) is rint(v/scale)*scale bit for
// bit, signed zeros included; |v| >= K is on the grid already.  Every
// multiply and every add is rounded on its own: the library is built
// with -fmad=false, because these trajectories are chaotic at the ULP
// level and a contracted multiply-add flips a rounding decision within a
// few hundred samples.  The kernel is then bit-identical to its plain
// PyTorch version (one op per launch, which forms xh and d up front as
// the copy warp does), and its f64 build to the reference binary (built
// -ffp-contract=off).
//
// What bounds it: each row is one dependency chain through the feedback
// sum, the quantizer and the ladder, so N samples take N steps of that
// chain whatever R is (rows are lanes of a warp: 32 of them cost one).
// Device traffic (16 B a sample in f32: x, two uniforms, q) would take
// ~1.2 ms at config6's shape (R = 512, N = 480,000); the chain's latency
// takes tens of ms.  Measured on an H100 80GB HBM3 at 700 W (PERF.md;
// `python -m convopeq_tpu_torch.sweep probe`): a dependent FADD, FMUL or
// FMNMX is 4.1 cycles, FRND 17, DADD and DMUL 8.1, the f64 clamp
// (compare and select) ~18; the rounding with the clamp of q takes 37.2
// cycles as FMUL, FRND, FMUL and the clamp, and ~18.8 folded (ef_round),
// so the f32 lattice_fir step's chain takes >= ~106 cycles (25.5 ms at
// config6's shape; >= 125 with rint) and the f64 one's >= ~202.  The step
// fed from registers runs 128 (f32) and 255 (f64), 148 and 279 with rint.
// The earlier design (one warp a block, staging its own tiles row by
// row between steps) ran ~500 and ~630: its staging code, ~20,000
// cycles a tile of dependent address arithmetic, loops and barriers, sat
// in series with the chain.  This design runs ~139 and ~279 cycles a
// step (33.6 ms at config6's shape; ~157 and ~311 with rint): the
// chain's own latency binds it.
//
// Design: a block is two warps over 32 rows.
// - The chain warp (warp 0) does only the recurrence: lane r holds row
//   r's state in registers (the coefficients are constant-bank operands),
//   takes xh and d from a shared stage in batches of kEfBatch steps (16-B
//   vector loads, issued a batch ahead, from a row stride of an odd
//   number of 16-B chunks so the 32 rows hit distinct banks), keeps the
//   batch's q in registers and stores it with vector stores over the xh
//   it replaces.  It waits on the stage's `full` mbarrier once a tile and
//   arrives on its `empty` one; no block barrier, no global access and no
//   address arithmetic but a pointer step a batch.
// - The copy warp (warp 1) runs on another scheduler of the SM: it brings
//   x and u into a ring of kEfStages stages with cp.async, forms xh and d
//   in the stage (the same single-rounded values the plain version
//   forms), arrives on `full`, and once the chain has released a stage
//   writes its q out before refilling it.  For a whole tile of a call
//   whose rows are 16-B aligned (every main path) this is straight-line
//   code, each lane a 16-B chunk of 16 rows: ~600 independent
//   instructions a tile against the chain's ~10,000 cycles.  The ragged
//   last tile and unaligned calls go row by row (16-B copies where a
//   span is aligned, values elsewhere), which is as slow as the earlier
//   staging.
// A tile is 256 B of a row (64 f32 or 32 f64 samples); the ragged last
// tile and batch are masked, so the state returned is the state after
// sample N.
//
// The per-row form (error_feedback_quantize_rows_*, lattice modes only):
// every row has its own nine coefficients, (R, 9) values of T on the
// card, which the chain lane loads into registers once before its loop
// (ef_row_consts); nothing else differs, and the shared form's
// instantiation (ROWS false) is the code above.  It simulates a whole
// CMA-ES population in one launch (models/learner.py: 18 candidates x 4
// levels x 2 channels = 144 rows), where a launch's time is set by its
// N steps, not its rows.
//
// With EF_QUANTIZE_HOST_EMULATION defined only the arithmetic (the step,
// the copy warp's xh and d, the chain warp's batched loop over one row of
// a stage), the tiling constants and the mode dispatch are compiled, for
// the host emulator tests/quantize_host_emulation.cpp, built with g++
// -ffp-contract=off.

#ifndef EF_QUANTIZE_HOST_EMULATION
#include <cuda_runtime.h>
#include <stdint.h>
#define EF_HD __host__ __device__ __forceinline__
#else
#define EF_HD inline
#endif

#include <cmath>
#include <limits>
#include <stddef.h>
#include <type_traits>

namespace {

enum { EF_PSYCHO = 0, EF_FIXED = 1, EF_FIXED15 = 2, EF_LATTICE = 3,
       EF_LATTICE_FIR = 4 };

constexpr int kEfMaxOrder = 16;
constexpr int kEfRows = 32;    // rows a block: the chain warp's lanes
constexpr int kEfBatch = 4;    // steps the chain warp loads and stores at once
constexpr int kEfStages = 4;   // stages in the ring

// A stage of T: for each of the 32 rows, xq (x, then xh, then q) and d
// at a row stride of kLd, and the raw uniforms at kLdu.
template <typename T>
struct EfTile {
  static constexpr int kSteps = 256 / (int)sizeof(T);       // 64 f32, 32 f64
  static constexpr int kLd = kSteps + 16 / (int)sizeof(T);  // 17 chunks of 16 B
  static constexpr int kLdu = 2 * kSteps;
  static constexpr int kStage = kEfRows * (2 * kLd + kLdu);  // values a stage
};

template <typename T>
struct EfConsts {
  T c[kEfMaxOrder];
  T headroom, scale, inv_scale, hi, err_lim, state_lim;
  T fold;  // K = 2^(digits-1)*scale, the folded rounding's add
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
  k.fold = (T)std::ldexp(scale, std::numeric_limits<T>::digits - 1);
  return k;
}

// The modes that clamp q to [-1, 1 - scale] after rounding.
constexpr bool ef_clamps_q(int mode) {
  return mode == EF_FIXED15 || mode == EF_LATTICE || mode == EF_LATTICE_FIR;
}

// Whether a launch rounds by the folded add pair (ef_round, FOLD true):
// scale is a power of two that is normal in T with K finite, and, in the
// modes that clamp q, K >= 1, so that |v| >= K lies past the clamp.  The
// same in f64: there too the folded form's step is the shorter in every
// mode on an H100 (`sweep probe`, the step fed from registers: 4.7 to 37
// cycles shorter).
template <typename T>
bool ef_folds(int mode, double scale) {
  using L = std::numeric_limits<T>;
  int e;
  if (!(scale >= (double)L::min()) || (double)(T)scale != scale ||
      std::frexp(scale, &e) != 0.5)
    return false;
  const double K = std::ldexp(scale, L::digits - 1);
  return K <= (double)L::max() && (!ef_clamps_q(mode) || K >= 1.0);
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

EF_HD float ef_abs(float v) {
#ifdef __CUDA_ARCH__
  return fabsf(v);
#else
  return std::fabs(v);
#endif
}
EF_HD double ef_abs(double v) {
#ifdef __CUDA_ARCH__
  return fabs(v);
#else
  return std::fabs(v);
#endif
}

EF_HD float ef_copysign(float v, float sign) {
#ifdef __CUDA_ARCH__
  return copysignf(v, sign);
#else
  return std::copysign(v, sign);
#endif
}
EF_HD double ef_copysign(double v, double sign) {
#ifdef __CUDA_ARCH__
  return copysign(v, sign);
#else
  return std::copysign(v, sign);
#endif
}

// min(v, hi), NaN passing through: f32 on the card the NaN-propagating
// min instruction.
template <typename T>
EF_HD T ef_min(T v, T hi) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same<T, float>::value) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(hi));
    return r;
  }
#endif
  return v > hi ? hi : v;
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

// The copy warp's terms: xh = x*headroom and the dither term d.
// The constants of one row in the per-row form: k with the row's ORDER
// coefficients (of T, as the shared form rounds its host doubles to T)
// in place of the shared ones; zeros for a lane past the last row.
template <typename T, int ORDER>
EF_HD EfConsts<T> ef_row_consts(const EfConsts<T>& k, const T* c) {
  EfConsts<T> r = k;
  for (int i = 0; i < ORDER; ++i) r.c[i] = c ? c[i] : T(0);
  return r;
}

template <typename T>
EF_HD T ef_xh(T x, const EfConsts<T>& k) { return x * k.headroom; }

template <typename T, int MODE>
EF_HD T ef_dither(T u0, T u1, const EfConsts<T>& k) {
  if (MODE == EF_PSYCHO) return ((u0 - T(0.5)) + (u1 - T(0.5))) * k.scale;
  return ((u0 + u1) - T(1)) * k.scale;
}

// v rounded half to even onto the grid of k.scale and, where CLAMP, q
// clamped to [-1, k.hi].  FOLD false: rint(v/scale)*scale, then the clamp.
// FOLD true (scale a power of two, ef_folds): z = (|v| + K) - K, and q is
// z, or |v| where |v| >= K (on the grid already), with v's sign; with the
// clamp (K >= 1, so |v| >= K gives z >= 1), min(z, v < 0 ? 1 : hi) with
// v's sign.  On the chain: the two adds, the select or the min, and the
// sign; |v| is an operand modifier of the first add, and the comparison
// and the limit's select run beside the adds.  The sign is the sign op,
// but a multiply by copysign(1, v) after the f32 clamp: the faster of the
// two in each on an H100 (the kernel's cycles a step: psycho f32 86.1
// against 86.6, lattice_fir f32 136.7 against 138.7; f64 equal).  Both
// forms give the same bits wherever v/scale is finite (|v| < 2^105 for 24
// bits in f32).
template <typename T, bool CLAMP, bool FOLD>
EF_HD T ef_round(T v, const EfConsts<T>& k) {
  if constexpr (FOLD) {
    const T a = ef_abs(v);
    const T z = (a + k.fold) - k.fold;
    if constexpr (!CLAMP) return ef_copysign(a < k.fold ? z : a, v);
    const T m = ef_min(z, v < T(0) ? T(1) : k.hi);
    if constexpr (std::is_same<T, float>::value)
      return m * ef_copysign(T(1), v);
    return ef_copysign(m, v);
  }
  const T q = ef_rint(v * k.inv_scale) * k.scale;
  return CLAMP ? ef_clamp(q, T(-1), k.hi) : q;
}

// One sample of one row: returns q, advances the state s in place.
template <typename T, int MODE, int ORDER, bool FOLD>
EF_HD T ef_step(T xh, T d, T (&s)[ORDER], const EfConsts<T>& k) {
  T fb = k.c[0] * s[0];
#pragma unroll
  for (int i = 1; i < ORDER; ++i) fb = fb + k.c[i] * s[i];
  constexpr bool kLattice = MODE == EF_LATTICE || MODE == EF_LATTICE_FIR;
  T q, err;
  if (MODE == EF_PSYCHO) {
    const T tmp = (xh + d) + fb;
    q = ef_round<T, false, FOLD>(tmp, k);
    err = tmp - q;
  } else {
    const T y = kLattice ? xh + fb : xh - fb;
    q = ef_round<T, ef_clamps_q(MODE), FOLD>(ef_clamp(y, T(-1), k.hi) + d,
                                              k);
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

// 16 B of T at p (16-B aligned), loaded and stored as one vector on the
// card
template <typename T>
struct EfVec {
  T v[16 / sizeof(T)];
};

template <typename T>
EF_HD EfVec<T> ef_ld16(const T* p) {
  EfVec<T> r;
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    r.v[0] = f.x; r.v[1] = f.y; r.v[2] = f.z; r.v[3] = f.w;
  } else {
    const double2 f = *reinterpret_cast<const double2*>(p);
    r.v[0] = f.x; r.v[1] = f.y;
  }
#else
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) r.v[j] = p[j];
#endif
  return r;
}

template <typename T>
EF_HD void ef_st16(T* p, const EfVec<T>& r) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  else
    *reinterpret_cast<double2*>(p) = make_double2(r.v[0], r.v[1]);
#else
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) p[j] = r.v[j];
#endif
}

// kEfBatch values at p: one 16-B vector in f32, two in f64
template <typename T>
struct EfBatch {
  T v[kEfBatch];
};

template <typename T>
EF_HD EfBatch<T> ef_load_batch(const T* p) {
  constexpr int V = 16 / (int)sizeof(T);
  EfBatch<T> b;
#pragma unroll
  for (int h = 0; h < kEfBatch / V; ++h) {
    const EfVec<T> w = ef_ld16(p + h * V);
#pragma unroll
    for (int j = 0; j < V; ++j) b.v[h * V + j] = w.v[j];
  }
  return b;
}

template <typename T>
EF_HD void ef_store_batch(T* p, const EfBatch<T>& b) {
  constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
  for (int h = 0; h < kEfBatch / V; ++h) {
    EfVec<T> w;
#pragma unroll
    for (int j = 0; j < V; ++j) w.v[j] = b.v[h * V + j];
    ef_st16(p + h * V, w);
  }
}

// The chain warp's work on one row of a stage: `steps` samples, xh at
// xq[t] and d at d[t]; q replaces xh at xq[t].  Whole batches load a
// batch ahead and store their q at once; the ragged rest runs a step at a
// time.
template <typename T, int MODE, int ORDER, bool FOLD>
EF_HD void ef_run_tile(T* xq, const T* d, int steps, T (&s)[ORDER],
                       const EfConsts<T>& k) {
  const int nb = steps / kEfBatch;
  EfBatch<T> xn{}, dn{};
  if (nb > 0) {
    xn = ef_load_batch(xq);
    dn = ef_load_batch(d);
  }
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    const EfBatch<T> xc = xn, dc = dn;
    if (b + 1 < nb) {
      xn = ef_load_batch(xq + (b + 1) * kEfBatch);
      dn = ef_load_batch(d + (b + 1) * kEfBatch);
    }
    EfBatch<T> qb;
#pragma unroll
    for (int j = 0; j < kEfBatch; ++j)
      qb.v[j] = ef_step<T, MODE, ORDER, FOLD>(xc.v[j], dc.v[j], s, k);
    ef_store_batch(xq + b * kEfBatch, qb);
  }
  for (int t = nb * kEfBatch; t < steps; ++t)
    xq[t] = ef_step<T, MODE, ORDER, FOLD>(xq[t], d[t], s, k);
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

// ------------------------------------------------ mbarriers and cp.async

__device__ __forceinline__ unsigned ef_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ef_bar_init(unsigned long long* bar,
                                            unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(ef_saddr(bar)),
               "r"(count)
               : "memory");
}

// one arrival of the calling thread (release: its earlier shared writes
// are visible to a thread that sees the phase complete)
__device__ __forceinline__ void ef_bar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(ef_saddr(bar))
      : "memory");
}

// wait until the phase of parity `parity` has completed (acquire)
__device__ __forceinline__ void ef_bar_wait(unsigned long long* bar,
                                            unsigned parity) {
  const unsigned addr = ef_saddr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

template <int BYTES>
__device__ __forceinline__ void ef_cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     ef_saddr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     ef_saddr(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

// ------------------------------------------------------------ copy warp

// A stage's regions: xq (x, xh, then q), d and the raw uniforms.
template <typename T>
struct EfStage {
  T* xq;
  T* d;
  T* u;
  __device__ EfStage(T* ring, int tile) {
    xq = ring + (tile % kEfStages) * EfTile<T>::kStage;
    d = xq + kEfRows * EfTile<T>::kLd;
    u = d + kEfRows * EfTile<T>::kLd;
  }
};

// The copy warp's three jobs on a tile of `steps` samples at t0.  A whole
// tile of a call whose rows are 16-B aligned takes straight-line code:
// lane l owns the 16-B chunk l % 16 of x (and its two chunks of u, its
// chunk of q) in the rows of parity l / 16, 16 rows a lane with no loop
// overhead and every chunk independent.  Anything else (the ragged last
// tile, a call with unaligned rows) goes row by row, lane by lane, with
// 16-B copies where a row's span is aligned and value copies elsewhere.
template <typename T>
struct EfCopy {
  static constexpr int V = 16 / (int)sizeof(T);  // values a chunk
  const EfArgs<T>& a;
  int lane, row0, rows;
  bool aligned;  // every row's spans of x, u and q 16-B aligned

  __device__ const T* x_at(int r, size_t t) const {
    return a.x + (size_t)(row0 + r) * a.N + t;
  }
  __device__ const T* u_at(int r, size_t t) const {
    return a.u + 2 * ((size_t)(row0 + r) * a.N + t);
  }
  __device__ T* q_at(int r, size_t t) const {
    return a.q + (size_t)(row0 + r) * a.N + t;
  }

  __device__ void get(const EfStage<T>& st, size_t t0, int steps) const {
    using Tl = EfTile<T>;
    if (aligned && steps == Tl::kSteps) {
      const int c = lane % 16, half = lane / 16;
#pragma unroll
      for (int i = 0; i < kEfRows / 2; ++i) {
        const int r = 2 * i + half;
        if (r < rows) {
          const size_t t = t0 + (size_t)c * V;
          ef_cp_async<16>(st.xq + r * Tl::kLd + c * V, x_at(r, t));
          ef_cp_async<16>(st.u + r * Tl::kLdu + 2 * c * V, u_at(r, t));
          ef_cp_async<16>(st.u + r * Tl::kLdu + 2 * c * V + V,
                          u_at(r, t) + V);
        }
      }
      return;
    }
    for (int r = 0; r < rows; ++r) {
      get_span(st.xq + r * Tl::kLd, x_at(r, t0), steps);
      get_span(st.u + r * Tl::kLdu, u_at(r, t0), 2 * steps);
    }
  }

  // n values from global src to shared dst (16-B aligned)
  __device__ void get_span(T* dst, const T* src, int n) const {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int nv = n / V;
      for (int c = lane; c < nv; c += 32)
        ef_cp_async<16>(dst + c * V, src + c * V);
      done = nv * V;
    }
    for (int j = done + lane; j < n; j += 32)
      ef_cp_async<(int)sizeof(T)>(dst + j, src + j);
  }

  // xh = x*headroom in place and d beside it
  template <int MODE>
  __device__ void form(const EfStage<T>& st, int steps,
                       const EfConsts<T>& k) const {
    using Tl = EfTile<T>;
    if (aligned && steps == Tl::kSteps) {
      const int c = lane % 16, half = lane / 16;
#pragma unroll 4
      for (int i = 0; i < kEfRows / 2; ++i) {
        const int r = 2 * i + half;
        T* xr = st.xq + r * Tl::kLd + c * V;
        const T* ur = st.u + r * Tl::kLdu + 2 * c * V;
        EfVec<T> x = ef_ld16(xr), d;
        const EfVec<T> u0 = ef_ld16(ur), u1 = ef_ld16(ur + V);
        T uv[2 * V];  // the chunk's V pairs (u0, u1)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          uv[j] = u0.v[j];
          uv[V + j] = u1.v[j];
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          x.v[j] = ef_xh(x.v[j], k);
          d.v[j] = ef_dither<T, MODE>(uv[2 * j], uv[2 * j + 1], k);
        }
        ef_st16(xr, x);
        ef_st16(st.d + r * Tl::kLd + c * V, d);
      }
      return;
    }
    using Pair = typename std::conditional<sizeof(T) == 4, float2,
                                           double2>::type;
    for (int r = 0; r < rows; ++r) {
      T* xr = st.xq + r * Tl::kLd;
      const Pair* ur = reinterpret_cast<const Pair*>(st.u + r * Tl::kLdu);
      for (int j = lane; j < steps; j += 32) {
        const Pair up = ur[j];
        xr[j] = ef_xh(xr[j], k);
        st.d[r * Tl::kLd + j] = ef_dither<T, MODE>(up.x, up.y, k);
      }
    }
  }

  // q (in xq) out to global
  __device__ void put(const EfStage<T>& st, size_t t0, int steps) const {
    using Tl = EfTile<T>;
    if (aligned && steps == Tl::kSteps) {
      const int c = lane % 16, half = lane / 16;
#pragma unroll
      for (int i = 0; i < kEfRows / 2; ++i) {
        const int r = 2 * i + half;
        if (r < rows)
          *reinterpret_cast<uint4*>(q_at(r, t0 + (size_t)c * V)) =
              *reinterpret_cast<const uint4*>(st.xq + r * Tl::kLd + c * V);
      }
      return;
    }
    for (int r = 0; r < rows; ++r) {
      T* dst = q_at(r, t0);
      const T* src = st.xq + r * Tl::kLd;
      int done = 0;
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        const int nv = steps / V;
        for (int c = lane; c < nv; c += 32)
          reinterpret_cast<uint4*>(dst)[c] =
              reinterpret_cast<const uint4*>(src)[c];
        done = nv * V;
      }
      for (int j = done + lane; j < steps; j += 32) dst[j] = src[j];
    }
  }
};

template <typename T, int MODE>
__device__ void ef_copy_warp(const EfArgs<T>& a, const EfConsts<T>& k,
                             T* ring, unsigned long long* full,
                             unsigned long long* empty) {
  using Tl = EfTile<T>;
  auto ok16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const EfCopy<T> cp{a, (int)threadIdx.x - kEfRows,
                     (int)blockIdx.x * kEfRows,
                     min(kEfRows, a.R - (int)blockIdx.x * kEfRows),
                     ok16(a.x) && ok16(a.u) && ok16(a.q) &&
                         ((size_t)a.N * sizeof(T)) % 16 == 0};
  const int ntiles = (a.N + Tl::kSteps - 1) / Tl::kSteps;
  auto steps_of = [&](int tile) {
    return min(Tl::kSteps, a.N - tile * Tl::kSteps);
  };
  for (int tile = 0; tile <= ntiles; ++tile) {
    if (tile < ntiles) {
      if (tile >= kEfStages) {  // the stage's last tile is done: q out
        const int old = tile - kEfStages;
        ef_bar_wait(&empty[tile % kEfStages], (tile / kEfStages - 1) & 1);
        cp.put(EfStage<T>(ring, old), (size_t)old * Tl::kSteps,
               steps_of(old));
        __syncwarp();
      }
      cp.get(EfStage<T>(ring, tile), (size_t)tile * Tl::kSteps,
             steps_of(tile));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (tile == 0) continue;
    // the previous tile's copies are complete: form xh and d in place
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    cp.template form<MODE>(EfStage<T>(ring, tile - 1), steps_of(tile - 1),
                           k);
    ef_bar_arrive(&full[(tile - 1) % kEfStages]);
  }
  // the last stages' q, once the chain has released them
  for (int tile = ntiles > kEfStages ? ntiles - kEfStages : 0; tile < ntiles;
       ++tile) {
    ef_bar_wait(&empty[tile % kEfStages], (tile / kEfStages) & 1);
    cp.put(EfStage<T>(ring, tile), (size_t)tile * Tl::kSteps,
           steps_of(tile));
  }
}

// ----------------------------------------------------------- chain warp

template <typename T, int MODE, int ORDER, bool FOLD>
__device__ void ef_chain_warp(const EfArgs<T>& a, const EfConsts<T>& k,
                              T* ring, unsigned long long* full,
                              unsigned long long* empty) {
  using Tl = EfTile<T>;
  const int lane = threadIdx.x;
  const int row = blockIdx.x * kEfRows + lane;
  const bool active = row < a.R;
  T s[ORDER];
#pragma unroll
  for (int i = 0; i < ORDER; ++i)
    s[i] = active ? a.state_in[(size_t)row * ORDER + i] : T(0);
  const int ntiles = (a.N + Tl::kSteps - 1) / Tl::kSteps;
  for (int tile = 0; tile < ntiles; ++tile) {
    const EfStage<T> st(ring, tile);
    const int steps = min(Tl::kSteps, a.N - tile * Tl::kSteps);
    ef_bar_wait(&full[tile % kEfStages], (tile / kEfStages) & 1);
    ef_run_tile<T, MODE, ORDER, FOLD>(st.xq + lane * Tl::kLd,
                                st.d + lane * Tl::kLd, steps, s, k);
    ef_bar_arrive(&empty[tile % kEfStages]);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) a.state_out[(size_t)row * ORDER + i] = s[i];
  }
}

constexpr int kEfBarBytes = 128;  // 2 kEfStages mbarriers, padded

// ROWS: the per-row form (lattice modes): row r's coefficients are
// rc[r * ORDER ..], loaded once into the chain lane's registers before its
// loop; the copy warp needs none of them.  The shared form (ROWS false)
// reads them from the constant bank and ignores rc.  FOLD: the rounding's
// form (ef_round), as ef_folds chose it on the host.
template <typename T, int MODE, int ORDER, bool ROWS, bool FOLD>
__global__ void __launch_bounds__(2 * kEfRows)
    ef_quantize_kernel(EfArgs<T> a, EfConsts<T> k, const T* rc) {
  extern __shared__ __align__(16) unsigned char ef_smem[];
  unsigned long long* const full =
      reinterpret_cast<unsigned long long*>(ef_smem);
  unsigned long long* const empty = full + kEfStages;
  T* const ring = reinterpret_cast<T*>(ef_smem + kEfBarBytes);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kEfStages; ++i) {
      ef_bar_init(&full[i], 32);   // the copy warp's lanes
      ef_bar_init(&empty[i], 32);  // the chain warp's lanes
    }
  }
  __syncthreads();  // the one block barrier: the mbarriers are set up
  if (threadIdx.x < kEfRows) {
    if constexpr (ROWS) {
      const int row = blockIdx.x * kEfRows + threadIdx.x;
      const EfConsts<T> kr = ef_row_consts<T, ORDER>(
          k, row < a.R ? rc + (size_t)row * ORDER : nullptr);
      ef_chain_warp<T, MODE, ORDER, FOLD>(a, kr, ring, full, empty);
    } else {
      ef_chain_warp<T, MODE, ORDER, FOLD>(a, k, ring, full, empty);
    }
  } else
    ef_copy_warp<T, MODE>(a, k, ring, full, empty);
}

// coeffs: `order` host doubles (the shared form, row_coeffs null), or
// row_coeffs: (R, order) values of T on the card (the per-row form, the
// lattice modes only; coeffs unused).
template <typename T>
int ef_launch(const void* x, const void* u, const void* state_in, void* q,
              void* state_out, int R, int N, int mode, const double* coeffs,
              const void* row_coeffs, int order, double scale,
              double headroom, void* stream) {
  if (R < 0 || N < 0 || order < 1 || order > kEfMaxOrder) return -1;
  const bool rows = row_coeffs != nullptr;
  if (rows && mode != EF_LATTICE && mode != EF_LATTICE_FIR) return -1;
  const EfConsts<T> k = rows ? ef_consts<T>(nullptr, 0, scale, headroom)
                             : ef_consts<T>(coeffs, order, scale, headroom);
  const EfArgs<T> a{(const T*)x, (const T*)u, (const T*)state_in, (T*)q,
                    (T*)state_out, R, N};
  const size_t smem =
      kEfBarBytes + (size_t)kEfStages * EfTile<T>::kStage * sizeof(T);
  const bool fold = ef_folds<T>(mode, scale);
  return ef_dispatch(mode, order, [&](auto m, auto o) -> int {
    constexpr int M = decltype(m)::value;
    constexpr int O = decltype(o)::value;
    if (R == 0) return 0;
    auto run = [&](auto kernel) -> int {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<(R + kEfRows - 1) / kEfRows, 2 * kEfRows, smem,
               (cudaStream_t)stream>>>(a, k, (const T*)row_coeffs);
      return (int)cudaGetLastError();
    };
    if constexpr (M == EF_LATTICE || M == EF_LATTICE_FIR)
      if (rows)
        return fold ? run(ef_quantize_kernel<T, M, O, true, true>)
                    : run(ef_quantize_kernel<T, M, O, true, false>);
    return fold ? run(ef_quantize_kernel<T, M, O, false, true>)
                : run(ef_quantize_kernel<T, M, O, false, false>);
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
                          nullptr, order, scale, headroom, stream);
}

int error_feedback_quantize_f64(const void* x, const void* u,
                                const void* state_in, void* q,
                                void* state_out, int R, int N, int mode,
                                const double* coeffs, int order, double scale,
                                double headroom, void* stream) {
  return ef_launch<double>(x, u, state_in, q, state_out, R, N, mode, coeffs,
                           nullptr, order, scale, headroom, stream);
}

// The per-row form: row_coeffs (R, order) of the library's type on the
// card, one coefficient row a signal row; mode lattice or lattice_fir
// (else -1).  Otherwise as above.
int error_feedback_quantize_rows_f32(const void* x, const void* u,
                                     const void* state_in, void* q,
                                     void* state_out, int R, int N, int mode,
                                     const void* row_coeffs, int order,
                                     double scale, double headroom,
                                     void* stream) {
  return ef_launch<float>(x, u, state_in, q, state_out, R, N, mode, nullptr,
                          row_coeffs, order, scale, headroom, stream);
}

int error_feedback_quantize_rows_f64(const void* x, const void* u,
                                     const void* state_in, void* q,
                                     void* state_out, int R, int N, int mode,
                                     const void* row_coeffs, int order,
                                     double scale, double headroom,
                                     void* stream) {
  return ef_launch<double>(x, u, state_in, q, state_out, R, N, mode, nullptr,
                           row_coeffs, order, scale, headroom, stream);
}

// 1 where a launch of this mode and scale in the type of `itemsize` bytes
// (4 or 8) rounds by the folded add pair, 0 where it takes rint.
int error_feedback_quantize_folds(int mode, double scale, int itemsize) {
  return itemsize == 4 ? ef_folds<float>(mode, scale)
                       : ef_folds<double>(mode, scale);
}

}  // extern "C"
#endif  // EF_QUANTIZE_HOST_EMULATION
