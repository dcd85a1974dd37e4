// The chain's linear recurrences (ops/iir_cascade.py `iir_cascade`): a
// cascade of up to three 2-state sections along each row of R rows x N
// samples, in one launch, for Hopper (sm_90a), f32 and f64 signals, the
// state and the arithmetic in f64 for both.
//
// It replaces no Pallas kernel: on the TPU, XLA ran the DC blocker's
// chunk-128 Toeplitz products (convopeq_tpu/ops/dc_blocker.py) and the
// biquad scans (convopeq_tpu/ops/scan_iir.py).  Under eager PyTorch the
// same recurrences were GEMMs against (R, N/128, 129) Toeplitz products,
// complex one-pole chunks and their carries' scans, many passes over the
// signal: ~12.7 ms for one DC blocker at R = 512 x N = 480,000 f32 and
// ~40 ms for the output filter's three biquads at 128 x 2,880,000 on an
// H100, 20-45x the time of one pass over the signal.
//
// Each section is linear in its two states s:  s' = A s + b x,
// y = c.s + d x; the cascade (section k's input the output of section
// k-1) is one system of D = 2K states, S' = M S + B x, whose M is block
// lower triangular (a section's state depends on its own and the earlier
// sections' states only).  Two forms of section, each sample run in the
// recurrence's own arithmetic:
//   DC (K = 1), state (s0, s1):  s0 += a0 (x - s0); u = x - s0;
//                                s1 += a1 (u - s1); y = u - s1
//   biquad (K <= 3), the TDF2 states (z1, z2) of scan_iir.py's
//   biquad_df2t_scan with the drive folded in (c1 = b1 - a1 b0 and
//   c2 = b2 - a2 b0, rounded once on the host):
//                 y = b0 x + z1;  z1 = c1 x - a1 z1 + z2;  z2 = c2 x - a2 z1
//   TDF2's own update, z1 = b1 x - a1 y + z2, cancels two terms of ~2|x|
//   at a 15-20 Hz high-pass, and its roundings then ride the poles: in
//   the 4x staged chain (192 kHz, f64) the output moved ~1.1e-12 under a
//   1-ulp change of the input that way, ~1e-14 with the drive folded
//   (the chain on the CPU with this source emulated).
//
// What bounds it on the card: the signal is read once and written once
// (8 B a sample in f32: 2.95 GB at 128 x 2,880,000, 0.88 ms at 3.35
// TB/s); the f64 arithmetic, ~2 x 5 operations a sample and section plus
// the scans' share, is of the same order at the card's f64 rate.  The
// poles near 1 (0.99996 for the 1 Hz DC blocker at 384 kHz, ~0.998 for
// the 18 Hz high-pass at 48 kHz) make an f32 state drift, so the state is
// f64 whatever the signal's type.  The design:
//
// - A warp takes one tile of one row: 32 lanes x 256 bytes (64 f32 or 32
//   f64 samples a lane, 8 KB), brought in with coalesced 16-byte loads
//   into the warp's part of shared memory, one 16-byte pad after each
//   lane's samples, so that the lanes reading their own samples 16 bytes
//   at a time fall on distinct bank groups.  The tile's fixed costs (the
//   counter, two fences, the look-back: ~15,000 cycles on an H100) are
//   spread over 2,048 f32 samples; at 512 the kernel ran 2x slower.
// - Each lane runs its samples from zero state: its end state e.  A warp
//   scan (five shuffle steps, Phi^(2^m) with Phi = M^L the transition
//   over a lane's L samples) gives every lane the zero-start state at its
//   start within the tile, and the tile's aggregate: its end state from a
//   zero start.
// - Across tiles, a decoupled look-back along the row: tiles are taken
//   in order from a counter, row-interleaved (tile k of row r is id
//   k R + r), so a tile's predecessors in its row were taken R ids
//   before.  A tile publishes its aggregate, then looks back: lane j
//   watches tile k - 1 - j, and the nearest with its inclusive state (the
//   state at its end), with aggregates on every tile between, gives the
//   start state as sum_j Phi_T^j (state of tile k - 1 - j), Phi_T =
//   M^(32 L): lane j forms its term, the warp sums them.  The tile then
//   publishes its own inclusive state.  The row's first tile starts from
//   the row's initial state (zero if none).  A tile waits only on tiles
//   taken before it, by warps that run, so the look-back cannot
//   deadlock.
// - The carries are double-doubles: Phi_T and Phi, and the tables
//   Phi_T^0..31 and Phi^0..31 made from them once a block in shared
//   memory, hi + lo with exact products and sums; the published
//   inclusive states hi + lo; M and its powers made on the host in pairs
//   of long doubles (make_params).  A pole pair near 1 makes M far from normal: its powers
//   grow ~k r^k before they decay (~190 at the 18 Hz high-pass), so a
//   rounding in a carry, or the cancellation in squaring M in double,
//   reaches the output ~10^3-10^4 times larger.  Carried in double, the
//   outputs at 48 kHz sat ~1e-9 from the sequential recurrence and moved
//   with the look-back's depth, which differs from run to run; in
//   double-double the start states do not depend on the depth to any
//   double's rounding, and the outputs sit ~1e-11 from the sequential
//   recurrence.  For an f64 signal the warp scan and the lanes' start
//   states are double-doubles too (an f32 output hides their roundings):
//   at 192 kHz the high-pass's powers reach ~700 within a tile; in double
//   they left that chain's 1-ulp movement at ~3e-13, not ~1e-14.
// - Each lane's start state is its zero-start prefix plus Phi^lane times
//   the tile's start; the lane runs its samples again from it, from
//   shared memory, writes y over x there, and the warp stores the tile
//   with 16-byte stores.  The lane that holds the row's last sample runs
//   it once more to its end for the final state.
// - Blocks of 8 warps stay on the card (as many as fit: 3 an SM for the
//   DC blocker, 2 for the biquads, by shared memory and registers), each
//   warp taking tiles until the counter passes R x tiles.  The kernel
//   argument holds the coefficients and the transitions; nothing is
//   copied to the device but the call's scratch (a status and 4 D
//   doubles a tile, the flags and the counter zeroed).
//
// The outputs are those of the sequential recurrence from the true start
// state of each lane, to the roundings of f64 (the lane's start state
// carries those of the scan's products); the f32 output is the f64 value
// rounded once.  On an H100 (700 W): the DC blocker at 128 x 2,880,000
// f32 ~1.5 ms, the three biquads ~2.4 ms, the DC blocker at 512 x
// 480,000 ~1.0 ms: 35-57% of the bytes' bound, 13-17x faster than the
// GEMMs and scans.
//
// With IIR_HOST_EMULATION defined, IIR_LAUNCH, IIR_DYNAMIC_SMEM, the warp
// collectives and the other CUDA names used here come from the host
// emulator tests/iir_cascade_host_emulation.cpp, which runs every thread
// of a block as a coroutine (tests/cuda_host_emulation.h);
// IIR_PUBLISH_INCLUSIVE(k) there lets a tile withhold its inclusive
// state, so that the look-back walks over aggregates.

#ifndef IIR_HOST_EMULATION
#include <cuda_runtime.h>
#define IIR_LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<(grid), (block), (smem), (stream)>>>
#define IIR_DYNAMIC_SMEM(type, name)                       \
  extern __shared__ __align__(16) unsigned char iir_smem_[]; \
  type& name = *reinterpret_cast<type*>(iir_smem_)
#define IIR_PUBLISH_INCLUSIVE(k) true
#endif

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneBytes = 256;                   // a lane's samples
constexpr int kLaneVecs = kLaneBytes / 16;        // 16-byte vectors a lane
constexpr int kTileVecs = 32 * kLaneVecs;         // a warp's tile
constexpr int kTileVecsPadded = kTileVecs + kTileVecs / kLaneVecs;
constexpr unsigned kFull = 0xffffffffu;
enum { kDc = 0, kBiquad = 1 };
enum { kNotReady = 0, kAggregate = 1, kInclusive = 2 };

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

template <class T>
struct Tile {
  static constexpr int kVec = Vec<T>::n;
  static constexpr int kL = kLaneBytes / sizeof(T);   // samples a lane
  static constexpr int kN = 32 * kL;                  // samples a tile
};

// The kernel argument: the sections' coefficients and the transitions
// over 2^m lanes (m < 5) and over a tile.
template <int K>
struct Params {
  static constexpr int D = 2 * K;
  double c[K][5];        // DC: a0, a1; biquad: b0, c1, c2, -a1, -a2
  double pl[5][D][D];    // Phi^(2^m), Phi = M^L
  double pl_lo[5][D][D]; // M^(2^m L) - pl[m]
  double pt[2][D][D];    // Phi^32 = M^(32 L): hi, lo
};

// One sample through the cascade; s the D states, in place.
template <int K, int KIND>
__device__ __forceinline__ double step(const Params<K>& p,
                                       double (&s)[2 * K], double x) {
  if constexpr (KIND == kDc) {
    s[0] = fma(p.c[0][0], x - s[0], s[0]);
    const double u = x - s[0];
    s[1] = fma(p.c[0][1], u - s[1], s[1]);
    return u - s[1];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const double z1 = s[2 * k];
      const double y = fma(p.c[k][0], x, z1);
      s[2 * k] = fma(p.c[k][3], z1, fma(p.c[k][1], x, s[2 * k + 1]));
      s[2 * k + 1] = fma(p.c[k][4], z1, p.c[k][2] * x);
      x = y;
    }
    return x;
  }
}


// The padded place of 16-byte vector q of a tile: one pad vector after
// each lane's kLaneVecs, so that the 8 lanes of a 16-byte access phase
// reading their own vectors fall on 8 different bank groups.
__device__ __forceinline__ int padded(int q) { return q + q / kLaneVecs; }

// The block's shared memory.
template <class T, int D>
struct Shared {
  double base[2][2][D * D];           // Phi, Phi_T: hi, lo, [r D + c]
  double lane_pow[2][D * D * 32];     // [.][(r D + c) 32 + l]: Phi^l
  double tile_pow[2][D * D * 32];     // [.][(r D + c) 32 + j]: Phi_T^j
  typename Vec<T>::type tile[kWarps][kTileVecsPadded];  // a warp's tile
};

__device__ __forceinline__ int load_flag(const int* f) {
  return *reinterpret_cast<const volatile int*>(f);
}

// Publishes n values at tile slot `v` with `status`; one lane calls it.
__device__ __forceinline__ void publish(double* v, const double* s, int n,
                                        int* flag, int status) {
  for (int j = 0; j < n; ++j) __stcg(v + j, s[j]);
  __threadfence();
  *reinterpret_cast<volatile int*>(flag) = status;
}

// The double-double arithmetic rounds each product and sum on its own:
// __dmul_rn and __dadd_rn are never contracted into an FMA, which would
// break the exact error terms (nvcc contracts a * b + c by default).

// hi + lo += a, the sum's rounding error into lo (TwoSum)
__device__ __forceinline__ void two_sum(double& hi, double& lo, double a) {
  const double s = __dadd_rn(hi, a);
  const double bb = __dsub_rn(s, hi);
  lo = __dadd_rn(lo, __dadd_rn(__dsub_rn(hi, __dsub_rn(s, bb)),
                               __dsub_rn(a, bb)));
  hi = s;
}

// (oh, ol) <- hi + lo renormalized (FastTwoSum)
__device__ __forceinline__ void renormalize(double hi, double lo, double& oh,
                                            double& ol) {
  oh = __dadd_rn(hi, lo);
  ol = __dsub_rn(lo, __dsub_rn(oh, hi));
}

// hi + lo += (ah + al)(bh + bl): the product of the his exact (TwoProd),
// the cross terms to double precision
__device__ __forceinline__ void dd_term(double ah, double al, double bh,
                                        double bl, double& hi, double& lo) {
  const double p = __dmul_rn(ah, bh);
  double e = fma(ah, bh, -p);
  e = fma(ah, bl, e);
  e = fma(al, bh, e);
  two_sum(hi, lo, p);
  lo = __dadd_rn(lo, e);
}

// (sh + sl) <- (Ph + Pl)(sh + sl) + (ah + al) in double-double: each
// lane forms row lane % D (Ph, Pl: the tile transition in shared memory,
// [r D + c]), the warp gathers the rows.
template <int D>
__device__ __forceinline__ void dd_carry(const double* Ph, const double* Pl,
                                         double (&sh)[D], double (&sl)[D],
                                         const double (&ah)[D],
                                         const double (&al)[D], int lane) {
  const int r = lane % D;
  double hi = 0.0, lo = 0.0, a = 0.0, b = 0.0;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dd_term(Ph[r * D + c], Pl[r * D + c], sh[c], sl[c], hi, lo);
    if (c == r) a = ah[c], b = al[c];
  }
  two_sum(hi, lo, a);
  lo = __dadd_rn(lo, b);
  double oh, ol;
  renormalize(hi, lo, oh, ol);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    sh[j] = __shfl_sync(kFull, oh, j);
    sl[j] = __shfl_sync(kFull, ol, j);
  }
}

// pw_h + pw_l at [(r D + c) 32 + j] <- (A^j)_rc, j < 32, as double-doubles
// from A = Ah + Al ([r D + c]): one warp, the entries over its lanes, each
// power the product of A and the one before.
template <int D>
__device__ __forceinline__ void dd_power_table(const double* Ah,
                                               const double* Al,
                                               double* pw_h, double* pw_l,
                                               int lane) {
  for (int e = lane; e < D * D; e += 32) {
    pw_h[e * 32] = e / D == e % D ? 1.0 : 0.0;
    pw_l[e * 32] = 0.0;
  }
  __syncwarp();
  for (int j = 1; j < 32; ++j) {
    for (int e = lane; e < D * D; e += 32) {
      const int r = e / D, c = e % D;
      double hi = 0.0, lo = 0.0;
      for (int m = 0; m < D; ++m)
        dd_term(Ah[r * D + m], Al[r * D + m],
                pw_h[(m * D + c) * 32 + j - 1],
                pw_l[(m * D + c) * 32 + j - 1], hi, lo);
      renormalize(hi, lo, pw_h[e * 32 + j], pw_l[e * 32 + j]);
    }
    __syncwarp();
  }
}

// One step of the warp scan: e += P t where `take` (P = Ph + Pl, block
// lower triangular in 2x2 blocks), in double (Pl, tl and el unused) or,
// kDd, in double-double.
template <bool kDd, int D>
__device__ __forceinline__ void scan_step(const double (&Ph)[D][D],
                                          const double (&Pl)[D][D],
                                          const double (&th)[D],
                                          const double (&tl)[D],
                                          double (&eh)[D], double (&el)[D],
                                          bool take) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    if constexpr (kDd) {
      double hi = 0.0, lo = 0.0;
#pragma unroll
      for (int c = 0; c < (r / 2 + 1) * 2; ++c)
        dd_term(Ph[r][c], Pl[r][c], th[c], tl[c], hi, lo);
      if (take) {
        two_sum(eh[r], el[r], hi);
        renormalize(eh[r], __dadd_rn(el[r], lo), eh[r], el[r]);
      }
    } else {
      double acc = 0.0;
#pragma unroll
      for (int c = 0; c < (r / 2 + 1) * 2; ++c)
        acc = fma(Ph[r][c], th[c], acc);
      if (take) eh[r] += acc;
    }
  }
}

// The start state of tile k of a row (the inclusive state of tile k - 1,
// or the row's initial state for k = 0) as a double-double, in every
// lane.  Qh, Ql: Phi_T^j in shared memory, [(r D + c) 32 + j]; frow: the
// row's flags; vrow: its values, 4 D a tile (aggregate hi, lo,
// inclusive hi, lo).  With f the nearest tile back that holds its inclusive
// state, the start is sum_{j < f} Phi_T^j agg_(k-1-j) + Phi_T^f incl:
// lane j forms its term, the warp sums them, all in double-double.
template <class T, int D>
__device__ __forceinline__ void look_back(const double* Qh, const double* Ql,
                                          const int* frow,
                                          const double* vrow,
                                          const T* s_init, int k, int lane,
                                          double (&sh)[D], double (&sl)[D]) {
  const int t = k - 1 - lane;  // the tile this lane watches; < 0: s_init
  int f = 0;
  for (;;) {
    const int status = t < 0 ? (int)kInclusive : load_flag(frow + t);
    const unsigned inclusive = __ballot_sync(kFull, status == kInclusive);
    const unsigned waiting = __ballot_sync(kFull, status == kNotReady);
    if (inclusive) {
      f = __ffs(inclusive) - 1;                  // the nearest
      if (!(waiting & ((1u << f) - 1u))) break;  // aggregates before it
    }
    __nanosleep(64);
  }
  __threadfence();
  double v[D], w[D];  // lane < f: its aggregate, lane f: its inclusive
#pragma unroll
  for (int j = 0; j < D; ++j) v[j] = w[j] = 0.0;
  if (lane <= f) {
    if (t < 0) {
      if (s_init != nullptr) {
#pragma unroll
        for (int j = 0; j < D; ++j) v[j] = (double)s_init[j];
      }
    } else {
      const double* src =
          vrow + (long long)t * 4 * D + (lane == f ? 2 * D : 0);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        v[j] = __ldcg(src + j);
        w[j] = __ldcg(src + D + j);
      }
    }
  }
  double hi[D], lo[D];
#pragma unroll
  for (int r = 0; r < D; ++r) {
    hi[r] = lo[r] = 0.0;
#pragma unroll
    for (int c = 0; c < D; ++c)
      dd_term(Qh[(r * D + c) * 32 + lane], Ql[(r * D + c) * 32 + lane],
              v[c], w[c], hi[r], lo[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const double oh = __shfl_xor_sync(kFull, hi[r], o);
      const double ol = __shfl_xor_sync(kFull, lo[r], o);
      two_sum(hi[r], lo[r], oh);
      lo[r] = __dadd_rn(lo[r], ol);
    }
  }
#pragma unroll
  for (int r = 0; r < D; ++r) renormalize(hi[r], lo[r], sh[r], sl[r]);
}

template <class T, int K, int KIND>
__global__ void __launch_bounds__(kThreads, K == 1 ? 3 : 2)
    iir_cascade_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                       int N, int tiles, int vec, const T* state0,
                       T* final_state, int* flags, double* vals,
                       const Params<K> p) {
  constexpr int D = 2 * K;
  constexpr bool kExact = sizeof(T) == 8;  // in-tile carries in dd
  typedef Tile<T> Tl;
  typedef Vec<T> Vt;
  typedef typename Vt::type V;
  typedef Shared<T, D> Sm;
  IIR_DYNAMIC_SMEM(Sm, shm);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x < D * D) {
    const int r = threadIdx.x / D, c = threadIdx.x % D;
    shm.base[0][0][threadIdx.x] = p.pl[0][r][c];
    shm.base[0][1][threadIdx.x] = p.pl_lo[0][r][c];
    shm.base[1][0][threadIdx.x] = p.pt[0][r][c];
    shm.base[1][1][threadIdx.x] = p.pt[1][r][c];
  }
  __syncthreads();
  if (warp < 2) {
    // warp 0: Phi^l, l < 32; warp 1: Phi_T^j, j < 32
    double(&pw)[2][D * D * 32] = warp == 0 ? shm.lane_pow : shm.tile_pow;
    dd_power_table<D>(shm.base[warp][0], shm.base[warp][1], pw[0], pw[1],
                      lane);
  }
  __syncthreads();

  V* sm = shm.tile[warp];
  const int total = R * tiles;
  int* counter = flags + total;
  for (;;) {
    __syncwarp();  // the last tile's stores have read sm
    int id = 0;
    if (lane == 0) id = atomicAdd(counter, 1);
    id = __shfl_sync(kFull, id, 0);
    if (id >= total) break;
    const int k = id / R;
    const int row = id - k * R;
    const long long m0 = (long long)k * Tl::kN;
    const T* xr = x + (long long)row * N;

    // the tile, zeros past the row's end
#pragma unroll
    for (int i = 0; i < kLaneVecs; ++i) {
      const int q = lane + 32 * i;
      const long long g = m0 + (long long)q * Tl::kVec;
      if (vec && g + Tl::kVec <= N) {
        sm[padded(q)] = *reinterpret_cast<const V*>(xr + g);
      } else {
        T w[Tl::kVec];
#pragma unroll
        for (int e = 0; e < Tl::kVec; ++e) w[e] = g + e < N ? xr[g + e] : T(0);
        sm[padded(q)] = Vt::pack(w);
      }
    }
    __syncwarp();
    V* own = sm + padded(kLaneVecs * lane);  // the lane's samples

    // the lane's end state from zero, then the warp's inclusive scan:
    // e_lane <- sum_{i <= lane} Phi^(lane - i) e_i
    double e[D];
#pragma unroll
    for (int j = 0; j < D; ++j) e[j] = 0.0;
#pragma unroll 4
    for (int i = 0; i < kLaneVecs; ++i) {
      T w[Tl::kVec];
      Vt::unpack(own[i], w);
#pragma unroll
      for (int u = 0; u < Tl::kVec; ++u) step<K, KIND>(p, e, (double)w[u]);
    }
    double el[D];  // the scan's lo parts (double-double for an f64 signal)
#pragma unroll
    for (int j = 0; j < D; ++j) el[j] = 0.0;
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      double th[D], tl[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        th[j] = __shfl_up_sync(kFull, e[j], 1 << m);
        tl[j] = __shfl_up_sync(kFull, el[j], 1 << m);
      }
      scan_step<kExact, D>(p.pl[m], p.pl_lo[m], th, tl, e, el,
                           lane >= (1 << m));
    }
    double agg[2 * D], excl[D], excl_l[D];  // agg: hi, lo
#pragma unroll
    for (int j = 0; j < D; ++j) {
      agg[j] = __shfl_sync(kFull, e[j], 31);
      agg[D + j] = __shfl_sync(kFull, el[j], 31);
      excl[j] = __shfl_up_sync(kFull, e[j], 1);
      excl_l[j] = __shfl_up_sync(kFull, el[j], 1);
      if (lane == 0) excl[j] = excl_l[j] = 0.0;
    }

    // the tile's start state, by the look-back; publish its states
    int* frow = flags + (long long)row * tiles;
    double* vrow = vals + (long long)row * tiles * 4 * D;
    double* slot = vrow + (long long)k * 4 * D;
    const bool last = k == tiles - 1;
    if (!last && lane == 0) publish(slot, agg, 2 * D, frow + k, kAggregate);
    double st[D], sl[D];
    look_back<T, D>(shm.tile_pow[0], shm.tile_pow[1], frow, vrow,
                    state0 != nullptr ? state0 + (long long)row * D : nullptr,
                    k, lane, st, sl);
    if (!last && IIR_PUBLISH_INCLUSIVE(k)) {
      double ih[D], il[D], ah[D], al[D], inc[2 * D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        ih[j] = st[j], il[j] = sl[j], ah[j] = agg[j], al[j] = agg[D + j];
      dd_carry<D>(shm.base[1][0], shm.base[1][1], ih, il, ah, al, lane);
#pragma unroll
      for (int j = 0; j < D; ++j) inc[j] = ih[j], inc[D + j] = il[j];
      if (lane == 0) publish(slot + 2 * D, inc, 2 * D, frow + k, kInclusive);
    }

    // the lane's start state: its zero-start prefix plus Phi^lane st
    double s[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const double* lh = shm.lane_pow[0] + r * D * 32 + lane;
      const double* ll = shm.lane_pow[1] + r * D * 32 + lane;
      if constexpr (kExact) {
        double hi = excl[r], lo = excl_l[r];
#pragma unroll
        for (int c = 0; c < (r / 2 + 1) * 2; ++c)
          dd_term(lh[c * 32], ll[c * 32], st[c], sl[c], hi, lo);
        s[r] = __dadd_rn(hi, lo);
      } else {
        double acc = excl[r];
#pragma unroll
        for (int c = 0; c < (r / 2 + 1) * 2; ++c)
          acc = fma(lh[c * 32], st[c], acc);
        s[r] = acc;
      }
    }
    // the row's final state: the lane that holds sample N - 1
    const long long at = (long long)N - 1 - m0 - (long long)lane * Tl::kL;
    if (final_state != nullptr && last && at >= 0 && at < Tl::kL) {
      double fs[D];
#pragma unroll
      for (int j = 0; j < D; ++j) fs[j] = s[j];
      for (int i = 0; i <= at; ++i)
        step<K, KIND>(p, fs, (double)reinterpret_cast<const T*>(own)[i]);
#pragma unroll
      for (int j = 0; j < D; ++j)
        final_state[(long long)row * D + j] = (T)fs[j];
    }
    // the lane's samples again from its start state, y over x
#pragma unroll 4
    for (int i = 0; i < kLaneVecs; ++i) {
      T w[Tl::kVec];
      Vt::unpack(own[i], w);
#pragma unroll
      for (int u = 0; u < Tl::kVec; ++u)
        w[u] = (T)step<K, KIND>(p, s, (double)w[u]);
      own[i] = Vt::pack(w);
    }
    __syncwarp();

    T* yr = y + (long long)row * N;
#pragma unroll
    for (int i = 0; i < kLaneVecs; ++i) {
      const int q = lane + 32 * i;
      const long long g = m0 + (long long)q * Tl::kVec;
      if (vec && g + Tl::kVec <= N) {
        *reinterpret_cast<V*>(yr + g) = sm[padded(q)];
      } else if (g < N) {
        T w[Tl::kVec];
        Vt::unpack(sm[padded(q)], w);
#pragma unroll
        for (int e = 0; e < Tl::kVec; ++e)
          if (g + e < N) yr[g + e] = w[e];
      }
    }
  }
}

// ---------------------------------------------------------------- host

typedef long double ld;

// The host's powers of M are made in pairs hi + lo of long doubles (~128
// bits).  A pole pair near 1 makes M far from normal, and squaring it
// cancels: made in long double alone, M^(32 L) carried a relative error
// of ~1e-18, which the tile carries spread along the row; the f64 output
// of the 18 Hz high-pass at 192 kHz then sat ~7e-13 from the recurrence
// run in long double, ~1e-14 with the powers made in pairs (the source
// emulated on the CPU).
struct ld2 {
  ld hi, lo;
};

// a b exactly, as hi + lo (Dekker's product: long double's 64-bit
// significand splits at 2^32 + 1)
ld2 two_prod(ld a, ld b) {
  const ld split = 4294967297.0L;
  ld t = split * a;
  const ld ah = t - (t - a), al = a - ah;
  t = split * b;
  const ld bh = t - (t - b), bl = b - bh;
  const ld p = a * b;
  return {p, ((ah * bh - p) + ah * bl + al * bh) + al * bl};
}

// a + b exactly, as hi + lo (TwoSum)
ld2 two_sum(ld a, ld b) {
  const ld s = a + b, bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

ld2 renormalized(ld hi, ld lo) {
  const ld s = hi + lo;
  return {s, lo - (s - hi)};
}

ld2 operator+(ld2 a, ld2 b) {
  const ld2 s = two_sum(a.hi, b.hi);
  return renormalized(s.hi, s.lo + a.lo + b.lo);
}

ld2 operator-(ld2 a) { return {-a.hi, -a.lo}; }

ld2 operator*(ld2 a, ld2 b) {
  const ld2 p = two_prod(a.hi, b.hi);
  return renormalized(p.hi, p.lo + (a.hi * b.lo + a.lo * b.hi));
}

ld2 pair(ld v) { return {v, 0.0L}; }

template <int D>
void matmul(const ld2 (&a)[D][D], const ld2 (&b)[D][D], ld2 (&out)[D][D]) {
  ld2 t[D][D];
  for (int r = 0; r < D; ++r)
    for (int c = 0; c < D; ++c) {
      ld2 acc = pair(0.0L);
      for (int j = 0; j < D; ++j) acc = acc + a[r][j] * b[j][c];
      t[r][c] = acc;
    }
  for (int r = 0; r < D; ++r)
    for (int c = 0; c < D; ++c) out[r][c] = t[r][c];
}

// The kernel argument from the sections' coefficients (5 a section:
// DC a0, a1; biquad b0, b1, b2, a1, a2), for L samples a lane: the
// cascade's M, exactly the linear map of the step's arithmetic, and its
// powers in pairs of long doubles, each rounded once to a double-double.
template <int K, int KIND>
Params<K> make_params(const double* coef, int L) {
  constexpr int D = 2 * K;
  Params<K> p;
  ld2 M[D][D];
  ld2 G[D];  // section k's input: G.S + H x
  for (int r = 0; r < D; ++r) {
    G[r] = pair(0.0L);
    for (int c = 0; c < D; ++c) M[r][c] = pair(0.0L);
  }
  ld2 H = pair(1.0L);
  for (int k = 0; k < K; ++k) {
    const double* q = coef + 5 * k;
    ld2 A[2][2], b[2], c[2], d;
    if (KIND == kDc) {
      const ld2 a0 = pair(q[0]), a1 = pair(q[1]);
      const ld2 b0 = two_sum(1.0L, -(ld)q[0]), b1 = two_sum(1.0L, -(ld)q[1]);
      A[0][0] = b0, A[0][1] = pair(0.0L), A[1][0] = -(a1 * b0), A[1][1] = b1;
      b[0] = a0, b[1] = a1 * b0;
      c[0] = -(b1 * b0), c[1] = -b1;
      d = b1 * b0;
      p.c[k][0] = q[0], p.c[k][1] = q[1];
      p.c[k][2] = p.c[k][3] = p.c[k][4] = 0.0;
    } else {
      const ld b0 = q[0], b1 = q[1], b2 = q[2], a1 = q[3], a2 = q[4];
      // the drive rounded once, and M built from the rounded values, so
      // that the step and M are the same linear map
      const double c1 = (double)(b1 - a1 * b0), c2 = (double)(b2 - a2 * b0);
      A[0][0] = pair(-a1), A[0][1] = pair(1.0L);
      A[1][0] = pair(-a2), A[1][1] = pair(0.0L);
      b[0] = pair(c1), b[1] = pair(c2);
      c[0] = pair(1.0L), c[1] = pair(0.0L);
      d = pair(b0);
      p.c[k][0] = q[0], p.c[k][1] = c1, p.c[k][2] = c2;
      p.c[k][3] = -q[3], p.c[k][4] = -q[4];
    }
    for (int i = 0; i < 2; ++i) {
      for (int j = 0; j < D; ++j) M[2 * k + i][j] = b[i] * G[j];
      for (int j = 0; j < 2; ++j)
        M[2 * k + i][2 * k + j] = M[2 * k + i][2 * k + j] + A[i][j];
    }
    for (int j = 0; j < D; ++j) G[j] = G[j] * d;
    G[2 * k] = G[2 * k] + c[0];
    G[2 * k + 1] = G[2 * k + 1] + c[1];
    H = H * d;
  }
  ld2 P[D][D];
  for (int r = 0; r < D; ++r)
    for (int c = 0; c < D; ++c) P[r][c] = M[r][c];
  for (int n = 1; n < L; n *= 2) matmul<D>(P, P, P);  // M^L
  for (int m = 0; m < 6; ++m) {
    if (m > 0) matmul<D>(P, P, P);                     // M^(2^m L)
    for (int r = 0; r < D; ++r)
      for (int c = 0; c < D; ++c) {
        const double hi = (double)P[r][c].hi;
        const double lo = (double)((P[r][c].hi - (ld)hi) + P[r][c].lo);
        if (m < 5) {
          p.pl[m][r][c] = hi;
          p.pl_lo[m][r][c] = lo;
        } else {
          p.pt[0][r][c] = hi;
          p.pt[1][r][c] = lo;
        }
      }
  }
  return p;
}

template <class T, int K, int KIND>
int launch(const void* x, void* y, int R, int N, int tiles,
           const double* coef, const void* state0, void* final_state,
           void* flags, void* vals, void* stream) {
  typedef Tile<T> Tl;
  const Params<K> p = make_params<K, KIND>(coef, Tl::kL);
  const int vec = N % Tl::kVec == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  auto kernel = iir_cascade_kernel<T, K, KIND>;
  const int smem = (int)sizeof(Shared<T, 2 * K>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)R * tiles;
  long long blocks = (total + kWarps - 1) / kWarps;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) *
                             (sms > 0 ? sms : 1);
  if (blocks > resident) blocks = resident;
  IIR_LAUNCH(kernel, dim3((unsigned)blocks), dim3(kThreads), smem,
             (cudaStream_t)stream)
  ((const T*)x, (T*)y, R, N, tiles, vec, (const T*)state0, (T*)final_state,
   (int*)flags, (double*)vals, p);
  return (int)cudaGetLastError();
}

template <class T>
int iir_cascade_impl(const void* x, void* y, int R, int N, int tiles, int K,
                     int kind, const double* coef, const void* state0,
                     void* final_state, void* flags, void* vals,
                     void* stream) {
  if (R < 1 || N < 1 || tiles != (N + Tile<T>::kN - 1) / Tile<T>::kN ||
      (long long)R * tiles >= 2147483647LL)
    return -1;
  if (kind == kDc && K == 1)
    return launch<T, 1, kDc>(x, y, R, N, tiles, coef, state0, final_state,
                             flags, vals, stream);
  if (kind == kBiquad) {
    switch (K) {
      case 1:
        return launch<T, 1, kBiquad>(x, y, R, N, tiles, coef, state0,
                                     final_state, flags, vals, stream);
      case 2:
        return launch<T, 2, kBiquad>(x, y, R, N, tiles, coef, state0,
                                     final_state, flags, vals, stream);
      case 3:
        return launch<T, 3, kBiquad>(x, y, R, N, tiles, coef, state0,
                                     final_state, flags, vals, stream);
      default:
        break;
    }
  }
  return -1;
}

}  // namespace

extern "C" {

// x, y: R contiguous rows of N values (y may not alias x); tiles:
// ceil(N / (8192 / sizeof(value))), the row's tiles; K sections of `kind`
// (0: one DC blocker, 1: K <= 3 biquads), coef 5 doubles a section (DC:
// a0, a1, then unused; biquad: b0, b1, b2, a1, a2); state0: R x K x 2
// initial states in the signal's type, or null for zero; final_state:
// R x K x 2 final states, or null; flags: R x tiles + 1 ints, zero;
// vals: R x tiles x 8 K doubles.  Returns 0 on success, -1 for an
// unsupported shape or cascade, else the CUDA error.
int iir_cascade_f32(const void* x, void* y, int R, int N, int tiles, int K,
                    int kind, const double* coef, const void* state0,
                    void* final_state, void* flags, void* vals,
                    void* stream) {
  return iir_cascade_impl<float>(x, y, R, N, tiles, K, kind, coef, state0,
                                 final_state, flags, vals, stream);
}

int iir_cascade_f64(const void* x, void* y, int R, int N, int tiles, int K,
                    int kind, const double* coef, const void* state0,
                    void* final_state, void* flags, void* vals,
                    void* stream) {
  return iir_cascade_impl<double>(x, y, R, N, tiles, K, kind, coef, state0,
                                  final_state, flags, vals, stream);
}

}  // extern "C"
