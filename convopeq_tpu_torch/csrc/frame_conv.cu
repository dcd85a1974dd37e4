// Overlap-save frame kernels of the partitioned convolution, for Hopper
// (sm_90a), on the CUDA cores: f32 (float2 spectra) and native f64
// (double2 spectra).  One kernel family per TPU Pallas kernel:
//
//   frames_rfft   replaces _fwd_frames_kernel (rfft_frames_two_stage_pallas,
//                 pallas_gemm_fft.py) in f32 and _fwd_dd_kernel
//                 (pallas_dd_fft.py) in f64
//   causal_mac    replaces _mac_kernel (causal_mac_grid_pallas) in c64 and
//                 _dd_mac_kernel in c128
//   irfft_valid   replaces _inv_kernel (irfft_valid_two_stage_pallas) in
//                 f32 and _inv_dd_kernel in f64
//   osa_rfft      replaces _fwd_kernel (rfft_two_stage_pallas): the
//                 forward transform read from a materialized (…, 2p)
//                 overlap-save frame, f32
//   fused_conv    replaces _fused_conv_kernel (fused_conv_frames_pallas):
//                 the three above in one launch sequence for P <= 8
//                 partitions, with X and Y kept out of device memory
//                 (design at fused_rows, below), f32
//
// The TPU computed its f64 tier in double-f32 arithmetic (Ozaki-sliced
// bf16 GEMMs, two_sum/two_prod, power-of-two normalization) because it
// has no f64.  The card has: the f64 kernels are the f32 ones templated
// on the complex type, with twiddles from the double sincospi.  Each f64
// kernel moves twice the f32 bytes and reads 16 B of shared memory per
// value; the row budget of an f64 FFT block (FC_F64_ROW_ELEMS) is its
// own, so that a block's shared memory does not double.
//
// Layout: spectra in natural bin order, (C, K, p+1) interleaved complex.
// Frame f = c*K + k of channel-stream c.  The overlap-save frame of frame
// k is [frames[k-1] | frames[k]] (zero prev for k == 0), N = 2p points.
//
// Transforms: the four-step FFT of M = M1*M2 points (M1 = 2^floor(lg M /
// 2)).  A 65536-point complex frame is 512 KB, more than a block's 227 KB
// of shared memory, so each transform runs as two passes through a
// global complex scratch of M points per frame: pass 1 does the M1- (or
// M2-) point FFTs of a group of R rows in shared memory and applies the
// twiddle, pass 2 does the other factor's FFTs and writes only what the
// caller keeps.  Row FFTs are radix-4 Stockham autosort in shared memory
// with a per-block twiddle table from sincospif / sincospi (exact
// arguments: every angle is a dyadic multiple of pi).
//
// The forward (frames_rfft, osa_rfft) packs the real 2p-point frame into
// a p-point complex one, z[n] = x[2n] + i x[2n+1], transforms that (M =
// p) and splits the result into the real frame's bins in its second
// pass: half the butterflies and half the scratch of a full-length
// complex FFT.  The inverse and the fused kernel's forward (whose row
// pass needs all 2p bins of a row) still transform the full M = N = 2p
// points.
//
// Every kernel but fused_rows loops over its work with a stride of
// blockDim.x, so its result does not depend on the block size it is
// launched with; fused_rows keeps kMidElems values a thread in registers
// and needs its block of kMidThreads.  With FRAME_CONV_HOST_EMULATION
// defined, FC_LAUNCH, FC_DYNAMIC_SMEM and the CUDA names used here come
// from the host emulator tests/frame_conv_host_emulation.cpp, which runs
// every thread of a block as a coroutine that yields at each barrier.

#ifndef FRAME_CONV_HOST_EMULATION
#include <cuda_runtime.h>
#define FC_LAUNCH(kernel, grid, block, smem, stream) \
    kernel<<<(grid), (block), (smem), (stream)>>>
#define FC_DYNAMIC_SMEM(type, name)                              \
  extern __shared__ __align__(16) unsigned char fc_smem_raw[]; \
  type* name = reinterpret_cast<type*>(fc_smem_raw)
#define FC_BOUNDS(threads, blocks) __launch_bounds__(threads, blocks)
#else
#define FC_BOUNDS(threads, blocks)
#endif

// complex values per f64 FFT block (R rows of M points); a power of two
#ifndef FC_F64_ROW_ELEMS
#define FC_F64_ROW_ELEMS 2048
#endif

#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMacSmemMax = 232448;

// The complex type T of a kernel: its real type, its row budget (complex
// values per FFT block) and the twiddle e^{sign * 2 pi i idx / N} for
// 0 <= idx < N, N a power of two.
template <class T>
struct Cx;

template <>
struct Cx<float2> {
  typedef float R;
  static constexpr int kRowElems = 4096;
  static __device__ __forceinline__ float2 make(float x, float y) {
    return make_float2(x, y);
  }
  static __device__ __forceinline__ float2 twiddle(int idx, int N,
                                                   float sign) {
    float s, c;
    sincospif(sign * 2.0f * (float)idx / (float)N, &s, &c);
    return make_float2(c, s);
  }
};

template <>
struct Cx<double2> {
  typedef double R;
  static constexpr int kRowElems = FC_F64_ROW_ELEMS;
  static __device__ __forceinline__ double2 make(double x, double y) {
    return make_double2(x, y);
  }
  static __device__ __forceinline__ double2 twiddle(int idx, int N,
                                                    double sign) {
    double s, c;
    sincospi(sign * 2.0 * (double)idx / (double)N, &s, &c);
    return make_double2(c, s);
  }
};

template <class T>
__device__ __forceinline__ T cadd(T a, T b) {
  return Cx<T>::make(a.x + b.x, a.y + b.y);
}
template <class T>
__device__ __forceinline__ T csub(T a, T b) {
  return Cx<T>::make(a.x - b.x, a.y - b.y);
}
template <class T>
__device__ __forceinline__ T cmul(T a, T b) {
  return Cx<T>::make(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// tw[j] = e^{sign * 2 pi i j / M}, j < M.
template <class T>
__device__ void fill_twiddles(T* tw, int lM, typename Cx<T>::R sign) {
  const int M = 1 << lM;
  for (int j = threadIdx.x; j < M; j += blockDim.x)
    tw[j] = Cx<T>::twiddle(j, M, sign);
}

// Row stride of an FFT block holding R = 2^lR rows: M plus a pad, so that
// the load and store loops, where neighbouring threads take neighbouring
// rows of one column, touch 16 distinct 8-byte banks per half-warp.
__host__ __device__ __forceinline__ int row_stride(int M, int lR) {
  return M + (lR >= 4 ? 1 : (16 >> lR));
}

// FFT of R = 2^lR rows of M = 2^lM points held at a (row r at a + r*ld),
// by ping-pong between a and b: Stockham autosort, decimation in
// frequency, radix-4 stages (and one radix-2 stage when lM is odd).
// Stage with stride s and quarter-length m (s*m = M/4), for p < m, q < s:
//   a_l = x[q + s*(p + l*m)],  W4 = tw[M/4] (-i forward, +i inverse)
//   y[q + s*(4p + 0)] = (a0 + a2) + (a1 + a3)
//   y[q + s*(4p + 1)] = ((a0 - a2) + W4 (a1 - a3)) * W^{p*s}
//   y[q + s*(4p + 2)] = ((a0 + a2) - (a1 + a3)) * W^{2p*s}
//   y[q + s*(4p + 3)] = ((a0 - a2) - W4 (a1 - a3)) * W^{3p*s}
// with W = tw[1].  Returns the buffer that holds the natural-order
// result.  Starts and ends with a barrier, so callers may fill `a` and
// `tw` right before and read the result right after.
template <class T>
__device__ T* fft_rows(T* a, T* b, const T* tw, int lM, int lR, int ld) {
  const int M = 1 << lM;
  const int quarter = M >> 2;
  int ls = 0;
  for (; ls + 2 <= lM; ls += 2) {
    const int s = 1 << ls;
    const int lq = lM - 2;                     // butterflies per row: M/4
    __syncthreads();
    const T w4 = tw[quarter];
    for (int t = threadIdx.x; t < (1 << (lR + lq)); t += blockDim.x) {
      const int r = t >> lq;
      const int u = t & (quarter - 1);
      const int pp = u >> ls;
      const int q = u & (s - 1);
      const T* x = a + r * ld + q + s * pp;
      T* y = b + r * ld + q + 4 * s * pp;
      const T a0 = x[0], a1 = x[quarter];
      const T a2 = x[2 * quarter], a3 = x[3 * quarter];
      const T b0 = cadd(a0, a2), b1 = csub(a0, a2);
      const T b2 = cadd(a1, a3), b3 = cmul(csub(a1, a3), w4);
      const int w = pp * s;
      y[0] = cadd(b0, b2);
      y[s] = cmul(cadd(b1, b3), tw[w]);
      y[2 * s] = cmul(csub(b0, b2), tw[2 * w]);
      y[3 * s] = cmul(csub(b1, b3), tw[3 * w]);
    }
    T* tmp = a;
    a = b;
    b = tmp;
  }
  if (ls < lM) {                               // radix-2: s = M/2, p = 0
    const int half = M >> 1;
    __syncthreads();
    for (int t = threadIdx.x; t < (1 << (lR + lM - 1)); t += blockDim.x) {
      const int r = t >> (lM - 1);
      const int q = t & (half - 1);
      const T A = a[r * ld + q];
      const T B = a[r * ld + q + half];
      b[r * ld + q] = cadd(A, B);
      b[r * ld + q + half] = csub(A, B);
    }
    T* tmp = a;
    a = b;
    b = tmp;
  }
  __syncthreads();
  return a;
}

// ---- forward: frames (C, K, p) real -> X (C, K, p+1) complex ----------
// The packed half-length transform (replaces the forward of
// _fwd_frames_kernel, _fwd_kernel and _fwd_dd_kernel).  With x the
// 2p-point overlap-save frame and z[n] = x[2n] + i x[2n+1], n < p, Z the
// p-point FFT of z and W = e^{-i pi k / p}, the real frame's bins are
//   E = (Z[k] + conj Z[p-k]) / 2,  O = (Z[k] - conj Z[p-k]) / (2i),
//   X[k] = E + W O,  X[p-k] = conj(E - W O)   (Z[p] = Z[0]),
// so X[0] = Re Z[0] + Im Z[0], X[p] = Re Z[0] - Im Z[0], X[p/2] =
// conj Z[p/2].  Four-step grid M = p = M1*M2: z index n = n1*M2 + n2,
// bin k = k1 + M1*k2.  Per f32 frame: 8p B of samples (the first half
// read again as the next frame's prev), 8p B of scratch out and back in,
// 8p B of spectrum out, 32p B in all against 48p B for the full-length
// complex transform.  Each pass moves half of that at a little over half
// the card's memory rate (PERF.md, the packed forward's findings); the
// scratch round trip is what a one-pass kernel would drop, where a frame
// fits a block.

// Pass 1: block (f, group of R columns n2): M1-point FFT over n1 of
// z[n1*M2 + n2], times W_p^{n2*k1}, to scratch[f][k1][n2] (p values a
// frame).  Each z value is one aligned float2 / double2 load of a sample
// pair, from [frames[k-1] | frames[k]] (a pair never straddles the two)
// or, kOsa, from the materialized (…, 2p) frame f of `in`.
template <class T, bool kOsa>
__global__ void fwd_packed_pass1(const typename Cx<T>::R* __restrict__ in,
                                 T* __restrict__ scratch, int K, int lM1,
                                 int M2, int lR) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const int M1 = 1 << lM1, R = 1 << lR, ld = row_stride(M1, lR);
  const int p = M1 * M2;
  T* a = fc_smem;
  T* b = a + R * ld;
  T* tw = b + R * ld;
  const int f = blockIdx.x;
  const int k = f % K;
  const int n20 = blockIdx.y * R;
  const Real* cur = in + (size_t)f * (kOsa ? 2 * p : p);
  fill_twiddles(tw, lM1, Real(-1));
  for (int e = threadIdx.x; e < R * M1; e += blockDim.x) {
    const int n1 = e >> lR;
    const int r = e & (R - 1);
    const int j = 2 * (n1 * M2 + n20 + r);    // x index of the pair
    // j < p reads frame k-1 (cur - p), zero before the first frame
    T v = Cx<T>::make(Real(0), Real(0));
    if (kOsa) {
      v = *reinterpret_cast<const T*>(cur + j);
    } else if (j >= p || k > 0) {
      v = *reinterpret_cast<const T*>(cur + (j - p));
    }
    a[r * ld + n1] = v;
  }
  const T* res = fft_rows(a, b, tw, lM1, lR, ld);
  for (int e = threadIdx.x; e < R * M1; e += blockDim.x) {
    const int k1 = e >> lR;
    const int r = e & (R - 1);
    const int n2 = n20 + r;
    scratch[((size_t)f * M1 + k1) * M2 + n2] =
        cmul(res[r * ld + k1], Cx<T>::twiddle(n2 * k1, p, Real(-1)));
  }
}

// Pass 2: block (f, group of R rows): M2-point FFTs over n2 of R rows,
// then the split into X[k] and X[p-k].  Bin k = k1 + M1*k2 has its
// partner p - k in row M1 - k1, column M2-1-k2 (k1 != 0); rows 0 and
// M1/2 each pair with themselves (row 0: column (M2 - k2) mod M2).  So
// block j holds rows k1 = j*R/2 + s in slots s < R/2 and their partners
// in slots R/2 + s, with row M1/2 in the partner slot of row 0; each
// pair of slots writes both rows' bins, and every bin 0..p is written
// once.  A frame's blocks are launched side by side (block index f *
// M1/R + j): the runs of R/2 bins that neighbouring blocks store then
// fill whole 32-byte sectors while they are still in L2.  Launched frame
// by frame instead (the grid of pass 1), the pass took twice as long on
// an H100 (PERF.md, the packed forward's findings).
__device__ __forceinline__ int packed_partner(int k1, int M1) {
  return k1 == 0 ? (M1 >> 1) : M1 - k1;
}

template <class T>
__global__ void fwd_packed_pass2(const T* __restrict__ scratch,
                                 T* __restrict__ X, int lM1, int lM2,
                                 int lR) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const int M1 = 1 << lM1, M2 = 1 << lM2, R = 1 << lR;
  const int ld = row_stride(M2, lR);
  const int p = M1 * M2;
  const int hR = R >> 1;
  const int lnb = lM1 - lR;                    // log2 of blocks a frame
  T* a = fc_smem;
  T* b = a + R * ld;
  T* tw = b + R * ld;
  const int f = blockIdx.x >> lnb;
  const int k10 = (blockIdx.x & ((1 << lnb) - 1)) * hR;
  const T* src = scratch + (size_t)f * p;
  fill_twiddles(tw, lM2, Real(-1));
  for (int e = threadIdx.x; e < R * M2; e += blockDim.x) {
    const int s = e >> lM2;
    const int n2 = e & (M2 - 1);
    const int k1 = s < hR ? k10 + s : packed_partner(k10 + s - hR, M1);
    a[s * ld + n2] = src[(size_t)k1 * M2 + n2];
  }
  const T* Z = fft_rows(a, b, tw, lM2, lR, ld);
  T* Xf = X + (size_t)f * (p + 1);
  const Real half = Real(0.5);
  // neighbouring threads take neighbouring rows: runs of R/2 bins
  for (int e = threadIdx.x; e < hR * M2; e += blockDim.x) {
    const int s = e & (hR - 1);
    const int k2 = e >> (lR - 1);
    const int k1 = k10 + s;
    const T* row = Z + s * ld;
    const T* prow = Z + (hR + s) * ld;
    int k;
    T zk, zq;                                  // Z[k], Z[p - k]
    if (k1 != 0) {
      k = k1 + M1 * k2;
      zk = row[k2];
      zq = prow[M2 - 1 - k2];
    } else if (k2 < (M2 >> 1)) {               // row 0 with itself
      k = M1 * k2;
      zk = row[k2];
      zq = row[(M2 - k2) & (M2 - 1)];
    } else {                                   // row M1/2 with itself
      const int c = k2 - (M2 >> 1);
      k = (M1 >> 1) + M1 * c;
      zk = prow[c];
      zq = prow[M2 - 1 - c];
    }
    if (k == 0) {
      Xf[0] = Cx<T>::make(zk.x + zk.y, Real(0));
      Xf[p] = Cx<T>::make(zk.x - zk.y, Real(0));
      continue;
    }
    const T E = Cx<T>::make(half * (zk.x + zq.x), half * (zk.y - zq.y));
    const T O = Cx<T>::make(half * (zk.y + zq.y), half * (zq.x - zk.x));
    const T WO = cmul(Cx<T>::twiddle(k, 2 * p, Real(-1)), O);
    Xf[k] = cadd(E, WO);
    Xf[p - k] = Cx<T>::make(E.x - WO.x, WO.y - E.y);
  }
  if (k10 == 0 && threadIdx.x == 0) {          // k = p/2: row 0, M2/2
    const T z = Z[M2 >> 1];
    Xf[p >> 1] = Cx<T>::make(z.x, -z.y);
  }
}

// The full-length forward pass 1 of fused_conv_f32: block (f, group of R
// columns n2): N1-point FFT over n1 of osa[n1*N2 + n2], N = 2p, times
// W_N^{n2*k1}, to scratch[f][k1][n2]; the osa frame is [frames[k-1] |
// frames[k]] read from the frames.
template <class T>
__global__ void fwd_pass1(const typename Cx<T>::R* __restrict__ in,
                          T* __restrict__ scratch, int K, int p, int lN1,
                          int N2, int lR) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const int N1 = 1 << lN1, R = 1 << lR, ld = row_stride(N1, lR);
  T* a = fc_smem;
  T* b = a + R * ld;
  T* tw = b + R * ld;
  const int f = blockIdx.x;
  const int k = f % K;
  const int n20 = blockIdx.y * R;
  const Real* cur = in + (size_t)f * p;
  fill_twiddles(tw, lN1, Real(-1));
  for (int e = threadIdx.x; e < R * N1; e += blockDim.x) {
    const int n1 = e >> lR;
    const int r = e & (R - 1);
    const int j = n1 * N2 + n20 + r;          // index in the osa frame
    // j < p reads frame k-1 (cur - p), zero before the first frame
    const Real v = (j >= p || k > 0) ? cur[j - p] : Real(0);
    a[r * ld + n1] = Cx<T>::make(v, Real(0));
  }
  const T* res = fft_rows(a, b, tw, lN1, lR, ld);
  const int N = N1 * N2;
  for (int e = threadIdx.x; e < R * N1; e += blockDim.x) {
    const int k1 = e >> lR;
    const int r = e & (R - 1);
    const int n2 = n20 + r;
    scratch[((size_t)f * N1 + k1) * N2 + n2] =
        cmul(res[r * ld + k1], Cx<T>::twiddle(n2 * k1, N, Real(-1)));
  }
}

// ---- inverse: Y (C, K, p+1) complex -> y (C, K, p) real, valid half ----
// Hermitian spectrum Z[k] (Z[N-k] = conj Z[k]; DC and Nyquist imaginary
// parts ignored), y[n] = (1/N) sum_k Z[k] e^{+2 pi i k n / N} for
// n in [p, 2p).  k = ka + N1*kb, n = nb + N2*na: the valid half is
// exactly na >= N1/2.

// Pass 1: block (f, group of R values ka): N2-point inverse FFT over kb,
// times e^{+2 pi i ka*nb / N}, to scratch[f][nb][ka].
template <class T>
__global__ void inv_pass1(const T* __restrict__ Y, T* __restrict__ scratch,
                          int p, int N1, int lN2, int lR) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const int N2 = 1 << lN2, R = 1 << lR, ld = row_stride(N2, lR);
  T* a = fc_smem;
  T* b = a + R * ld;
  T* tw = b + R * ld;
  const int f = blockIdx.x;
  const int ka0 = blockIdx.y * R;
  const int N = N1 * N2;
  const T* Yf = Y + (size_t)f * (p + 1);
  fill_twiddles(tw, lN2, Real(1));
  for (int e = threadIdx.x; e < R * N2; e += blockDim.x) {
    const int kb = e >> lR;
    const int r = e & (R - 1);
    const int kk = ka0 + r + N1 * kb;
    T v;
    if (kk == 0 || kk == p) {
      v = Cx<T>::make(Yf[kk].x, Real(0));
    } else if (kk < p) {
      v = Yf[kk];
    } else {
      const T t = Yf[N - kk];
      v = Cx<T>::make(t.x, -t.y);
    }
    a[r * ld + kb] = v;
  }
  const T* res = fft_rows(a, b, tw, lN2, lR, ld);
  for (int e = threadIdx.x; e < R * N2; e += blockDim.x) {
    const int nb = e >> lR;
    const int r = e & (R - 1);
    const int ka = ka0 + r;
    scratch[((size_t)f * N2 + nb) * N1 + ka] =
        cmul(res[r * ld + nb], Cx<T>::twiddle(ka * nb, N, Real(1)));
  }
}

// Pass 2: block (f, group of R values nb): N1-point inverse FFT over ka,
// real part of the outputs na >= N1/2 only, scaled by 1/N.  The scratch
// holds frame f as [nb][ka] (from inv_pass1) or, kByRows, as [ka][nb]
// (from fused_rows, which writes in place of the forward's [k1][n2]).
template <class T, bool kByRows>
__global__ void inv_pass2(const T* __restrict__ scratch,
                          typename Cx<T>::R* __restrict__ y, int p, int lN1,
                          int N2, int lR) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const int N1 = 1 << lN1, R = 1 << lR, ld = row_stride(N1, lR);
  T* a = fc_smem;
  T* b = a + R * ld;
  T* tw = b + R * ld;
  const int f = blockIdx.x;
  const int nb0 = blockIdx.y * R;
  fill_twiddles(tw, lN1, Real(1));
  if (kByRows) {
    // neighbouring threads take neighbouring nb: contiguous reads
    const T* src = scratch + (size_t)f * N1 * N2 + nb0;
    for (int e = threadIdx.x; e < R * N1; e += blockDim.x) {
      const int ka = e >> lR;
      const int r = e & (R - 1);
      a[r * ld + ka] = src[(size_t)ka * N2 + r];
    }
  } else {
    const T* src = scratch + ((size_t)f * N2 + nb0) * N1;
    for (int e = threadIdx.x; e < R * N1; e += blockDim.x)
      a[(e >> lN1) * ld + (e & (N1 - 1))] = src[e];
  }
  const T* res = fft_rows(a, b, tw, lN1, lR, ld);
  const Real scale = Real(1) / (Real)(N1 * N2);
  const int hA = N1 >> 1;
  Real* yf = y + (size_t)f * p;
  for (int e = threadIdx.x; e < R * hA; e += blockDim.x) {
    const int i = e >> lR;
    const int r = e & (R - 1);
    yf[nb0 + r + N2 * i] = res[r * ld + hA + i].x * scale;
  }
}

// ---- causal frame MAC: Y[c,f,b] = sum_{j<P, j<=f} X[c,f-j,b] H[j,b] ---
// Block (c, tile of bt bins); each bin walks the frames in order, keeping
// the last P frame values of its own bin in a shared-memory ring and its
// P partition values beside them.  No bin reads another bin's slots, so
// no barrier is needed.  j ascends from 0, as in the TPU kernels.
template <class T>
__global__ void causal_mac_kernel(const T* __restrict__ X,
                                  const T* __restrict__ H,
                                  T* __restrict__ Yout, int K, int B, int P,
                                  int bt) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  T* ring = fc_smem;               // [slot][lb]
  T* hs = fc_smem + P * bt;        // [j][lb]
  const int c = blockIdx.x;
  const int b0 = blockIdx.y * bt;
  const int nb = (B - b0 < bt) ? (B - b0) : bt;
  for (int lb = threadIdx.x; lb < nb; lb += blockDim.x) {
    const int b = b0 + lb;
    for (int j = 0; j < P; ++j) hs[j * bt + lb] = H[(size_t)j * B + b];
    const T* Xc = X + (size_t)c * K * B + b;
    T* Yc = Yout + (size_t)c * K * B + b;
    int slot = 0;                  // ring slot of frame f: f % P
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
}

// ---- fused convolution, P <= 8: frames (C, K, p) -> y (C, K, p), f32 --
// y[c,k,:] = valid half of irfft(sum_{j<P, j<=k} X[c,k-j,:] H[j,:]).
//
// On the TPU the whole pipeline ran per frame tile in VMEM, with a ring
// of the last 16 frames' spectra.  Here one frame's spectrum at
// p = 8192 is 128 KB, and P of them per channel-stream exceed a block's
// shared memory, so the work is cut by bin group instead of by frame:
//
//   1. fwd_pass1, the full-length forward pass 1 (frames_rfft's packed
//      transform has no row of all 2p bins to hand on): the N1-point
//      column FFTs of every 2p-point frame, times the twiddle, to
//      scratch[f][k1][n2].
//   2. fused_rows: block (c, group of R rows k1) walks the K frames of c
//      in order.  A row k1 of the forward's second stage yields the bins
//      k = k1 + N1*k2 for all N2 values k2, over the full 2p-point
//      spectrum: exactly the bins that the inverse's first stage reads
//      for its row ka = k1 (k = ka + N1*kb), the Hermitian half k > p
//      included.  So the forward's second stage, the MAC and the
//      inverse's first stage run on the same rows with no exchange
//      between blocks, and X and Y never leave the block.  The price is
//      that the MAC runs on all 2p bins, not p+1.  Each thread keeps the
//      last P spectra of its kMidElems bins and their P partition values
//      in registers (a ring shifted by one a frame, P a template
//      parameter): no shared-memory traffic for the MAC, no barrier.
//      A shared-memory ring with H beside it would take 128 B a bin at
//      P = 8, 64 KB for a block's 512 bins; in registers the block fits
//      twice on an SM (128 registers a thread at P = 8, no spills).
//      The result, times the inverse twiddle, goes back in place of the
//      rows it was read from, as scratch[f][ka][nb].
//   3. inv_pass2<float2, true>: the N1-point inverse FFTs, valid half.
//
// Device-memory traffic a frame: 4p B of samples in, 2 x 32p B of
// scratch round trips, 4p B out (72p B), against 104p B for the three
// kernels (which also write and read X and Y).  The scratch round trips
// remain; keeping them out needs a whole frame's FFT in one block.
//
// Bins 0 and p take real Y, as the plain inverse does; the MAC on the
// Hermitian half uses H[N-k] conjugated.  The sum runs over j ascending,
// as in _mac_kernel.

constexpr int kMidTile = 512;                        // row values a block
constexpr int kMidElems = 2;                         // of them a thread
constexpr int kMidThreads = kMidTile / kMidElems;
// Frames a step: the row FFTs of two frames run together (2R rows), so a
// radix-4 stage has a butterfly for every thread and a frame costs half
// the barriers; the MAC still takes the frames one after the other.
constexpr int kLogMidFrames = 1;
constexpr int kMidFrames = 1 << kLogMidFrames;

template <int P>
__global__ void FC_BOUNDS(kMidThreads, 2)
fused_rows(float2* __restrict__ scratch, const float2* __restrict__ H,
           int K, int p, int N1, int lN2, int lR) {
  FC_DYNAMIC_SMEM(float2, fc_smem);
  const int lRs = lR + kLogMidFrames;                // rows of a step
  const int N2 = 1 << lN2, R = 1 << lR, ld = row_stride(N2, lRs);
  const int N = N1 * N2;
  const int step = R * ld;                           // frame s at s * step
  float2* a = fc_smem;
  float2* b = a + kMidFrames * step;
  float2* twf = b + kMidFrames * step;
  float2* twi = twf + N2;
  const int c = blockIdx.x;
  const int k10 = blockIdx.y * R;
  fill_twiddles(twf, lN2, -1.0f);
  fill_twiddles(twi, lN2, 1.0f);

  // this thread's values: row r = e / N2, column q = e % N2 of the block
  int sm[kMidElems], gm[kMidElems];   // shared / global offsets
  bool real_bin[kMidElems];
  float2 h[kMidElems][P], ring[kMidElems][P], tw[kMidElems];
#pragma unroll
  for (int i = 0; i < kMidElems; ++i) {
    const int e = threadIdx.x + i * kMidThreads;
    const int r = e >> lN2;
    const int q = e & (N2 - 1);
    sm[i] = r * ld + q;
    gm[i] = r * N2 + q;
    const int kk = k10 + r + N1 * q;                   // the bin
    real_bin[i] = (kk == 0 || kk == p);
    const int src = (kk <= p) ? kk : N - kk;
    const float conj = (kk <= p) ? 1.0f : -1.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float2 v = H[(size_t)j * (p + 1) + src];
      h[i][j] = make_float2(v.x, conj * v.y);
      ring[i][j] = make_float2(0.0f, 0.0f);
    }
    tw[i] = Cx<float2>::twiddle((k10 + r) * q, N, 1.0f);
  }

  // frame f of this block's rows at rows + f * N; frames past K are
  // transformed as whatever the buffer holds and then left out
  float2* rows = scratch + (size_t)c * K * N + (size_t)k10 * N2;
  float2 next[kMidFrames][kMidElems];
#pragma unroll
  for (int s = 0; s < kMidFrames; ++s) {
#pragma unroll
    for (int i = 0; i < kMidElems; ++i)
      next[s][i] = (s < K) ? rows[(size_t)s * N + gm[i]]
                           : make_float2(0.0f, 0.0f);
  }
  for (int f = 0; f < K; f += kMidFrames) {
    __syncthreads();                 // the last step's reads of a, b done
#pragma unroll
    for (int s = 0; s < kMidFrames; ++s) {
#pragma unroll
      for (int i = 0; i < kMidElems; ++i) a[s * step + sm[i]] = next[s][i];
      const int fn = f + kMidFrames + s;             // prefetch
      if (fn < K) {
#pragma unroll
        for (int i = 0; i < kMidElems; ++i)
          next[s][i] = rows[(size_t)fn * N + gm[i]];
      }
    }
    float2* X = fft_rows(a, b, twf, lN2, lRs, ld);
#pragma unroll
    for (int s = 0; s < kMidFrames; ++s) {
      if (f + s >= K) break;
#pragma unroll
      for (int i = 0; i < kMidElems; ++i) {
#pragma unroll
        for (int j = P - 1; j > 0; --j) ring[i][j] = ring[i][j - 1];
        ring[i][0] = X[s * step + sm[i]];
        float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float2 xv = ring[i][j];
          const float2 hv = h[i][j];
          acc.x += xv.x * hv.x - xv.y * hv.y;
          acc.y += xv.x * hv.y + xv.y * hv.x;
        }
        if (real_bin[i]) acc.y = 0.0f;
        X[s * step + sm[i]] = acc;   // only this thread reads this slot
      }
    }
    const float2* Y = fft_rows(X, X == a ? b : a, twi, lN2, lRs, ld);
#pragma unroll
    for (int s = 0; s < kMidFrames; ++s) {
      if (f + s >= K) break;
      float2* out = rows + (size_t)(f + s) * N;
#pragma unroll
      for (int i = 0; i < kMidElems; ++i)
        out[gm[i]] = cmul(Y[s * step + sm[i]], tw[i]);
    }
  }
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool pow2_partition(int p) {
  return p >= 512 && p <= 65536 && (p & (p - 1)) == 0;
}

// log2 of the rows per FFT block of complex type T for row length
// M = 2^lM, limited by the number of rows 2^lrows
template <class T>
int fft_rows_log2(int lM, int lrows) {
  int lR = ilog2(Cx<T>::kRowElems) - lM;
  if (lR < 0) lR = 0;
  if (lR > lrows) lR = lrows;
  return lR;
}

// Launches `kernel` with `smem` bytes of dynamic shared memory (allowed
// explicitly, since it may exceed the default 48 KB).
template <class Kernel, class... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t st, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  FC_LAUNCH(kernel, grid, dim3(threads), smem, st)(args...);
  return (int)cudaGetLastError();
}

// Launches one transform pass of complex type T: 2^lR rows of 2^lM
// points a block, two row buffers and the twiddle table in dynamic
// shared memory.
template <class T, class Kernel, class... Args>
int launch_fft(Kernel kernel, dim3 grid, int lR, int lM, cudaStream_t st,
               Args... args) {
  const size_t smem =
      (size_t)(2 * (1 << lR) * row_stride(1 << lM, lR) + (1 << lM)) *
      sizeof(T);
  return launch_kernel(kernel, grid, kThreads, smem, st, args...);
}

template <int P>
int launch_fused_rows(int C, int N1, int lN2, cudaStream_t st,
                      float2* scratch, const float2* H, int K, int p) {
  const int lR = ilog2(kMidTile) - lN2;
  const int lRs = lR + kLogMidFrames;
  const size_t smem =
      (size_t)(2 * (1 << lRs) * row_stride(1 << lN2, lRs) + 2 * (1 << lN2)) *
      sizeof(float2);
  return launch_kernel(fused_rows<P>, dim3(C, N1 >> lR), kMidThreads, smem,
                       st, scratch, H, K, p, N1, lN2, lR);
}

// The forward transform in T, packed: frames (C, K, p) or, kOsa,
// materialized overlap-save frames (C, K, 2p) -> X (C, K, p+1); scratch
// C*K*p values.  Pass 2 holds R >= 2 rows (a row and its partner) at
// every supported p: at most 256-point rows against a row budget of at
// least 1024 values.
template <class T, bool kOsa>
int frames_rfft_impl(const void* in, void* scratch, void* X, int C, int K,
                     int p, void* stream) {
  typedef typename Cx<T>::R Real;
  if (!pow2_partition(p) || C < 1 || K < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int lM = ilog2(p);
  const int lM1 = lM / 2, lM2 = lM - lM1;
  const int M2 = 1 << lM2;
  const int rows = C * K;
  const int lR1 = fft_rows_log2<T>(lM1, lM2);
  const int rc = launch_fft<T>(fwd_packed_pass1<T, kOsa>,
                               dim3(rows, M2 >> lR1), lR1, lM1, st,
                               (const Real*)in, (T*)scratch, K, lM1, M2, lR1);
  if (rc != 0) return rc;
  const int lR2 = fft_rows_log2<T>(lM2, lM1);
  return launch_fft<T>(fwd_packed_pass2<T>, dim3(rows << (lM1 - lR2)), lR2,
                       lM2, st, (const T*)scratch, (T*)X, lM1, lM2, lR2);
}

// The inverse in T: Y (C, K, p+1) -> y (C, K, p); scratch C*K*2p values.
template <class T>
int irfft_valid_impl(const void* Y, void* scratch, void* y, int C, int K,
                     int p, void* stream) {
  typedef typename Cx<T>::R Real;
  if (!pow2_partition(p) || C < 1 || K < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int lN = ilog2(2 * p);
  const int lN1 = lN / 2, lN2 = lN - lN1;
  const int N1 = 1 << lN1, N2 = 1 << lN2;
  const int rows = C * K;
  const int lR1 = fft_rows_log2<T>(lN2, lN1);
  const int rc = launch_fft<T>(inv_pass1<T>, dim3(rows, N1 >> lR1), lR1,
                               lN2, st, (const T*)Y, (T*)scratch, p, N1, lN2,
                               lR1);
  if (rc != 0) return rc;
  const int lR2 = fft_rows_log2<T>(lN1, lN2);
  return launch_fft<T>(inv_pass2<T, false>, dim3(rows, N2 >> lR2), lR2, lN1,
                       st, (const T*)scratch, (Real*)y, p, lN1, N2, lR2);
}

// Bins per MAC block of complex type T for P partitions (the ring and H
// in shared memory), or 0 when P does not fit.
template <class T>
int mac_tile(int P) {
  for (int bt = 128; bt >= 32; bt >>= 1)
    if ((size_t)2 * P * bt * sizeof(T) <= (size_t)kMacSmemMax) return bt;
  return 0;
}

template <class T>
int causal_mac_impl(const void* X, const void* H, void* Y, int C, int K,
                    int B, int P, void* stream) {
  const int bt = mac_tile<T>(P);
  if (bt == 0 || C < 1 || K < 1 || B < 1) return -1;
  return launch_kernel(causal_mac_kernel<T>, dim3(C, (B + bt - 1) / bt), bt,
                       (size_t)2 * P * bt * sizeof(T), (cudaStream_t)stream,
                       (const T*)X, (const T*)H, (T*)Y, K, B, P, bt);
}

}  // namespace

extern "C" {

// Bins per MAC block for P partitions, or 0 when P does not fit: complex64
// and complex128.
int frame_conv_mac_tile(int P) { return mac_tile<float2>(P); }
int frame_conv_mac_tile_c128(int P) { return mac_tile<double2>(P); }

// Each entry returns 0 on success, -1 for an unsupported shape, else the
// CUDA error.  The transforms take a complex scratch of their complex
// type: C*K*p values for the forward (frames_rfft, osa_rfft), C*K*2p for
// the inverse; a larger one is fine.
int frames_rfft_f32(const void* frames, void* scratch, void* X, int C,
                    int K, int p, void* stream) {
  return frames_rfft_impl<float2, false>(frames, scratch, X, C, K, p,
                                         stream);
}

int frames_rfft_f64(const void* frames, void* scratch, void* X, int C,
                    int K, int p, void* stream) {
  return frames_rfft_impl<double2, false>(frames, scratch, X, C, K, p,
                                          stream);
}

// osa (C, K, 2p) f32 -> X (C, K, p+1) c64: rfft of each materialized frame
int osa_rfft_f32(const void* osa, void* scratch, void* X, int C, int K,
                 int p, void* stream) {
  return frames_rfft_impl<float2, true>(osa, scratch, X, C, K, p, stream);
}

int irfft_valid_f32(const void* Y, void* scratch, void* y, int C, int K,
                    int p, void* stream) {
  return irfft_valid_impl<float2>(Y, scratch, y, C, K, p, stream);
}

int irfft_valid_f64(const void* Y, void* scratch, void* y, int C, int K,
                    int p, void* stream) {
  return irfft_valid_impl<double2>(Y, scratch, y, C, K, p, stream);
}

int causal_mac_c64(const void* X, const void* H, void* Y, int C, int K,
                   int B, int P, void* stream) {
  return causal_mac_impl<float2>(X, H, Y, C, K, B, P, stream);
}

int causal_mac_c128(const void* X, const void* H, void* Y, int C, int K,
                    int B, int P, void* stream) {
  return causal_mac_impl<double2>(X, H, Y, C, K, B, P, stream);
}

// frames (C, K, p) f32, H (P, p+1) c64 -> y (C, K, p) f32, for
// 1 <= P <= 8; scratch: C*K*2p complex64 values.
int fused_conv_f32(const void* frames, const void* H, void* scratch,
                   void* y, int C, int K, int p, int P, void* stream) {
  if (!pow2_partition(p) || C < 1 || K < 1 || P < 1 || P > 8) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int lN = ilog2(2 * p);
  const int lN1 = lN / 2, lN2 = lN - lN1;
  const int N1 = 1 << lN1, N2 = 1 << lN2;
  const int rows = C * K;
  float2* s = (float2*)scratch;
  const float2* h = (const float2*)H;
  const int lR1 = fft_rows_log2<float2>(lN1, lN2);
  int rc = launch_fft<float2>(fwd_pass1<float2>,
                              dim3(rows, N2 >> lR1), lR1, lN1, st,
                              (const float*)frames, s, K, p, lN1, N2, lR1);
  if (rc != 0) return rc;
  switch (P) {
    case 1: rc = launch_fused_rows<1>(C, N1, lN2, st, s, h, K, p); break;
    case 2: rc = launch_fused_rows<2>(C, N1, lN2, st, s, h, K, p); break;
    case 3: rc = launch_fused_rows<3>(C, N1, lN2, st, s, h, K, p); break;
    case 4: rc = launch_fused_rows<4>(C, N1, lN2, st, s, h, K, p); break;
    case 5: rc = launch_fused_rows<5>(C, N1, lN2, st, s, h, K, p); break;
    case 6: rc = launch_fused_rows<6>(C, N1, lN2, st, s, h, K, p); break;
    case 7: rc = launch_fused_rows<7>(C, N1, lN2, st, s, h, K, p); break;
    default: rc = launch_fused_rows<8>(C, N1, lN2, st, s, h, K, p); break;
  }
  if (rc != 0) return rc;
  const int lR3 = fft_rows_log2<float2>(lN1, lN2);
  return launch_fft<float2>(inv_pass2<float2, true>, dim3(rows, N2 >> lR3),
                            lR3, lN1, st, (const float2*)s, (float*)y, p,
                            lN1, N2, lR3);
}

}  // extern "C"
