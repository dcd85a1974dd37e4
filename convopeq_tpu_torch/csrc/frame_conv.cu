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
//                 (design at fused_packed_rows, below), f32
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
// Every transform runs on the packed half-length grid.  The forward
// (frames_rfft, osa_rfft) packs the real 2p-point frame into a p-point
// complex one, z[n] = x[2n] + i x[2n+1], transforms that (M = p) and
// splits the result into the real frame's bins in its second pass; the
// inverse (irfft_valid) combines bins k and p-k into the p-point
// spectrum of z in its first pass, transforms that, and writes the valid
// half as sample pairs in its second; fused_conv runs the forward's pass
// 1, one row pass (split, MAC, combine) and the inverse's pass 2.  Half
// the butterflies and half the scratch of a full-length complex FFT.
//
// Every kernel but fused_packed_rows and causal_mac_kernel loops over its
// work with a stride of blockDim.x, so its result does not depend on the
// block size it is launched with; fused_packed_rows keeps a bin pair a
// thread in registers and needs its block of M2 threads, causal_mac_kernel
// a warp a channel (32 G threads, mac_block).  With FRAME_CONV_HOST_EMULATION
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

// Block blockIdx.x of a pass in which each frame takes 2^lnb blocks:
// (frame f, block j of the frame), a frame's blocks side by side.  Frame
// by frame (the frame index varying fastest) was measured on an H100: the
// inverse's pass 1 then took 14-20% longer, likely because the partner
// bins it reads again were no longer in L2, and its f64 pass 2 28-29%
// longer (PERF.md, the packed inverse's findings).
__device__ __forceinline__ void frame_block(int lnb, int* f, int* j) {
  const int b = blockIdx.x;
  *f = b >> lnb;
  *j = b & ((1 << lnb) - 1);
}

// ---- inverse: Y (C, K, p+1) complex -> y (C, K, p) real, valid half ----
// The packed half-length inverse (replaces the inverse of _inv_kernel and
// _inv_dd_kernel), the forward's split run backwards.  With Y the real
// frame's bins (DC's and Nyquist's imaginary parts ignored) and
// T = e^{+i pi k / p}, the p-point spectrum of z[n] = x[2n] + i x[2n+1],
// times two, is
//   W[k] = A + i T B,  A = Y[k] + conj Y[p-k],  B = Y[k] - conj Y[p-k],
// (k = 0: A = Re Y[0] + Re Y[p], B = Re Y[0] - Re Y[p]), and
//   z[n] = (1 / 2p) sum_k W[k] e^{+2 pi i k n / p}.
// Four-step grid M = p = M1*M2: bin k = ka + M1*kb, z index n = nb +
// M2*na.  The valid half x[p..2p) is z[n] for n >= p/2, exactly the rows
// na >= M1/2 of pass 2, one aligned float2 / double2 store a sample pair.
// Per f32 frame: 8p B of spectrum read twice (as bin k and as partner
// p-k, in L2 when a frame's blocks run together), 8p B of scratch out and
// back in, 4p B out.

// Pass 1: block (f, group of R columns ka): W[k] from Y[k] and its
// partner Y[p-k] (another column, read straight from Y), the M2-point
// inverse FFT over kb, times e^{+2 pi i ka*nb / p}, to scratch[f][nb][ka]
// (p values a frame).
template <class T>
__global__ void inv_packed_pass1(const T* __restrict__ Y,
                                 T* __restrict__ scratch, int lM1, int lM2,
                                 int lR) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const int M1 = 1 << lM1, M2 = 1 << lM2, R = 1 << lR;
  const int ld = row_stride(M2, lR);
  const int p = M1 * M2;
  T* a = fc_smem;
  T* b = a + R * ld;
  T* tw = b + R * ld;
  int f, j;
  frame_block(lM1 - lR, &f, &j);
  const int ka0 = j * R;
  const T* Yf = Y + (size_t)f * (p + 1);
  fill_twiddles(tw, lM2, Real(1));
  for (int e = threadIdx.x; e < R * M2; e += blockDim.x) {
    const int kb = e >> lR;
    const int r = e & (R - 1);
    const int k = ka0 + r + M1 * kb;
    const T yk = Yf[k], yq = Yf[p - k];
    T w;
    if (k == 0) {
      w = Cx<T>::make(yk.x + yq.x, yk.x - yq.x);
    } else {
      const T A = Cx<T>::make(yk.x + yq.x, yk.y - yq.y);
      const T tB = cmul(Cx<T>::twiddle(k, 2 * p, Real(1)),
                        Cx<T>::make(yk.x - yq.x, yk.y + yq.y));
      w = Cx<T>::make(A.x - tB.y, A.y + tB.x);
    }
    a[r * ld + kb] = w;
  }
  const T* res = fft_rows(a, b, tw, lM2, lR, ld);
  for (int e = threadIdx.x; e < R * M2; e += blockDim.x) {
    const int nb = e >> lR;
    const int r = e & (R - 1);
    const int ka = ka0 + r;
    scratch[((size_t)f * M2 + nb) * M1 + ka] =
        cmul(res[r * ld + nb], Cx<T>::twiddle(ka * nb, p, Real(1)));
  }
}

// Pass 2: block (f, group of R values nb): M1-point inverse FFT over ka,
// the outputs na >= M1/2 only, scaled by 1/(2p), each as the sample pair
// (x[2n], x[2n+1]).  The scratch holds frame f as [nb][ka] (from
// inv_packed_pass1) or, kByRows, as [ka][nb] (from fused_packed_rows,
// which writes in place of the forward's [k1][n2]).
template <class T, bool kByRows>
__global__ void inv_packed_pass2(const T* __restrict__ scratch,
                                 typename Cx<T>::R* __restrict__ y,
                                 int lM1, int lM2, int lR) {
  typedef typename Cx<T>::R Real;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const int M1 = 1 << lM1, M2 = 1 << lM2, R = 1 << lR;
  const int ld = row_stride(M1, lR);
  const int p = M1 * M2;
  T* a = fc_smem;
  T* b = a + R * ld;
  T* tw = b + R * ld;
  int f, j;
  frame_block(lM2 - lR, &f, &j);
  const int nb0 = j * R;
  fill_twiddles(tw, lM1, Real(1));
  if (kByRows) {
    // neighbouring threads take neighbouring nb: contiguous reads
    const T* src = scratch + (size_t)f * p + nb0;
    for (int e = threadIdx.x; e < R * M1; e += blockDim.x) {
      const int ka = e >> lR;
      const int r = e & (R - 1);
      a[r * ld + ka] = src[(size_t)ka * M2 + r];
    }
  } else {
    const T* src = scratch + ((size_t)f * M2 + nb0) * M1;
    for (int e = threadIdx.x; e < R * M1; e += blockDim.x)
      a[(e >> lM1) * ld + (e & (M1 - 1))] = src[e];
  }
  const T* res = fft_rows(a, b, tw, lM1, lR, ld);
  const Real scale = Real(1) / (Real)(2 * p);
  const int hA = M1 >> 1;
  // sample pair n - p/2 = nb + M2*(na - M1/2) of the valid half
  T* yf = reinterpret_cast<T*>(y + (size_t)f * p);
  for (int e = threadIdx.x; e < R * hA; e += blockDim.x) {
    const int i = e >> lR;
    const int r = e & (R - 1);
    const T z = res[r * ld + hA + i];
    yf[nb0 + r + M2 * i] = Cx<T>::make(z.x * scale, z.y * scale);
  }
}

// ---- causal frame MAC: Y[c,f,b] = sum_{j<P, j<=f} X[c,f-j,b] H[j,b] ---
// Replaces _mac_kernel (causal_mac_grid_pallas) in c64 and _dd_mac_kernel
// in c128.  A thread owns bin b of channel c and walks the K frames of c
// in tiles of kMacFrames (TF) output frames, with TF accumulators in
// registers and the window X[f0-j .. f0-j+TF-1] of its bin in TF
// registers: going from j to j+1 the window slides down one frame, so
// one shared load of X (the ring) and one of H serve TF complex
// multiply-adds, and TF independent sums keep the FP pipe fed.  The j
// loop is unrolled by TF: frame f0-j enters window slot (-j) mod TF and
// output t reads slot (t-j) mod TF (f0 a multiple of TF), each a fixed
// register.
//
// Block: G warps (mac_block), one channel each, lanes on 32 consecutive
// bins (coalesced 256 B / 512 B rows).  H[:, bins] is staged once in
// shared memory for all G channels; each thread keeps the last P-1
// frames of its bin in a shared-memory ring column of its own (slot f mod
// (P-1), zeroed first, so frames before 0 read as zero), written with a
// tile's frames after the tile's j loop has read the older ones.  No
// thread reads another's ring slots: one barrier, after H.  The next
// tile's X is loaded into registers while a tile runs.
//
// Shared memory: (P + G (P-1)) x 32 values; at G = 1 it takes P <= 454
// (c64) and P <= 227 (c128), as one block of 2P x 32 values did.  The sum
// of each output runs over j ascending with the expression of the TPU
// kernels, rounded as the ring MAC it replaced rounded it (mac_step);
// terms of frames before 0 add exact zeros (j > f, early tiles).
constexpr int kMacFrames = 8;                  // TF: output frames a tile
constexpr int kMacMaxWarps = 8;                // channels a block, at most
constexpr int kSmemPerSM = 233472;             // 228 KB an SM
constexpr int kSmemPerBlockReserved = 1024;

// acc += x h, rounded as nvcc contracted `acc.x += x.x*h.x - x.y*h.y;
// acc.y += x.x*h.y + x.y*h.x` in the ring MAC this kernel replaced (kept
// in csrc/mac_probe.cu; its SASS: FMUL, FFMA, FADD a part), written out
// so that no schedule changes it.
__device__ __forceinline__ void mac_step(float2& acc, float2 x, float2 h) {
  acc.x = __fadd_rn(acc.x, __fmaf_rn(x.x, h.x, -__fmul_rn(x.y, h.y)));
  acc.y = __fadd_rn(acc.y, __fmaf_rn(x.x, h.y, __fmul_rn(x.y, h.x)));
}
__device__ __forceinline__ void mac_step(double2& acc, double2 x,
                                         double2 h) {
  acc.x = __dadd_rn(acc.x, __fma_rn(x.x, h.x, -__dmul_rn(x.y, h.y)));
  acc.y = __dadd_rn(acc.y, __fma_rn(x.x, h.y, __dmul_rn(x.y, h.x)));
}

// the multiply-add of causal_mac_kernel (a type, so that
// csrc/mac_probe.cu can time the kernel with another rounding)
struct MacRounded {
  template <class T>
  static __device__ __forceinline__ void step(T& acc, T x, T h) {
    mac_step(acc, x, h);
  }
};

template <class T, class Step = MacRounded>
__global__ void FC_BOUNDS(kMacMaxWarps * 32, sizeof(T) == 8 ? 2 : 1)
causal_mac_kernel(const T* __restrict__ X, const T* __restrict__ H,
                  T* __restrict__ Yout, int C, int K, int B, int P) {
  typedef typename Cx<T>::R Real;
  constexpr int TF = kMacFrames;
  FC_DYNAMIC_SMEM(T, fc_smem);
  const T zero = Cx<T>::make(Real(0), Real(0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int R = P > 1 ? P - 1 : 1;             // ring slots
  const int b0 = blockIdx.x * 32;
  for (int e = threadIdx.x; e < P * 32; e += blockDim.x) {
    const int b = b0 + (e & 31);
    fc_smem[e] = b < B ? H[(size_t)(e >> 5) * B + b] : zero;
  }
  __syncthreads();
  const int c = blockIdx.y * (blockDim.x >> 5) + warp;
  if (c >= C) return;
  const T* hs = fc_smem + lane;                // H[j] at hs[j * 32]
  T* ring = fc_smem + (P + warp * R) * 32 + lane;  // slot s at ring[s * 32]
  for (int s = 0; s < R; ++s) ring[s * 32] = zero;
  const bool live = b0 + lane < B;
  const T* Xc = X + (size_t)c * K * B + b0 + lane;
  T* Yc = Yout + (size_t)c * K * B + b0 + lane;
  T xn[TF];
#pragma unroll
  for (int t = 0; t < TF; ++t)
    xn[t] = (live && t < K) ? Xc[(size_t)t * B] : zero;
  int top = 0;                                 // ring slot of frame f0
  for (int f0 = 0; f0 < K; f0 += TF) {
    T cur[TF], v[TF], acc[TF];
#pragma unroll
    for (int t = 0; t < TF; ++t) {
      cur[t] = xn[t];
      v[t] = xn[t];
      const int fn = f0 + TF + t;
      xn[t] = (live && fn < K) ? Xc[(size_t)fn * B] : zero;
    }
    const T h0 = hs[0];
#pragma unroll
    for (int t = 0; t < TF; ++t) {
      acc[t] = zero;
      Step::step(acc[t], v[t], h0);
    }
    // steps j = jb + u, u = 1..TF; slot of frame f0 - jb - 1 in sb
    const int jmax = (f0 + TF - 1 < P - 1) ? f0 + TF - 1 : P - 1;
    int jb = 0;
    int sb = top - 1 < 0 ? top - 1 + R : top - 1;
    for (; jb + TF <= jmax; jb += TF) {
      const T* hj = hs + jb * 32;
#pragma unroll
      for (int u = 1; u <= TF; ++u) {
        const int s = sb - (u - 1) < 0 ? sb - (u - 1) + R : sb - (u - 1);
        v[(TF - u) % TF] = ring[s * 32];
        const T h = hj[u * 32];
#pragma unroll
        for (int t = 0; t < TF; ++t)
          Step::step(acc[t], v[(t - u + TF) % TF], h);
      }
      sb = sb - TF < 0 ? sb - TF + R : sb - TF;
    }
    const T* hj = hs + jb * 32;                // the last jmax - jb < TF
#pragma unroll
    for (int u = 1; u < TF; ++u) {
      if (jb + u <= jmax) {
        const int s = sb - (u - 1) < 0 ? sb - (u - 1) + R : sb - (u - 1);
        v[(TF - u) % TF] = ring[s * 32];
        const T h = hj[u * 32];
#pragma unroll
        for (int t = 0; t < TF; ++t)
          Step::step(acc[t], v[(t - u + TF) % TF], h);
      }
    }
#pragma unroll
    for (int t = 0; t < TF; ++t) {
      if (live && f0 + t < K) Yc[(size_t)(f0 + t) * B] = acc[t];
      ring[top * 32] = cur[t];                 // frame f0 + t
      top = top + 1 == R ? 0 : top + 1;
    }
  }
}

// ---- fused convolution, P <= 8: frames (C, K, p) -> y (C, K, p), f32 --
// y[c,k,:] = valid half of irfft(sum_{j<P, j<=k} X[c,k-j,:] H[j,:]).
//
// On the TPU the whole pipeline ran per frame tile in VMEM, with a ring
// of the last 16 frames' spectra.  Here one frame's spectrum at
// p = 8192 is 64 KB, and P of them per channel-stream exceed a block's
// shared memory, so the work is cut by bin group instead of by frame,
// on the packed grid (M = p = M1*M2, bin k = k1 + M1*k2):
//
//   1. fwd_packed_pass1, as frames_rfft runs it: the M1-point column
//      FFTs of every packed frame, times the twiddle, to
//      scratch[f][k1][n2] (p values a frame).
//   2. fused_packed_rows: block (c, row pair) walks the K frames of c in
//      order.  It holds row k1 and its partner row packed_partner(k1),
//      as fwd_packed_pass2 does, so that the row FFTs give Z[k] and
//      Z[p-k] of every bin pair in one block; the split gives X[k] and
//      X[p-k]; the MAC runs on the p+1 bins of the real frame, each
//      against its own H[k]; and the inverse's pre-combine gives W[k]
//      and W[p-k] in the slots they came from.  A row k1 of the
//      forward's second stage holds the bins k = k1 + M1*k2 for all M2
//      values k2: exactly the row ka = k1 of the inverse's first stage
//      (k = ka + M1*kb), so the inverse row FFTs run on the same rows,
//      with no exchange between blocks, and X and Y never leave the
//      block.  Each thread owns one bin and its partner (in row 0, the
//      self-paired bins 0 / p and p/2 together): the split, a register
//      ring of their last P spectra beside their P partition values (a
//      ring shifted by one a frame, P a template parameter), the MAC
//      and the pre-combine stay inside the thread, and each
//      shared-memory slot between the two row FFTs is read and written
//      by its own thread only: no barrier.  Two frames a step: the row
//      FFTs of two frames run together (4 rows), so a radix-4 stage has
//      one butterfly a thread and a frame costs half the barriers.  The
//      result, times the inverse twiddle, goes back in place of the rows
//      it was read from, as scratch[f][ka][nb].
//   3. inv_packed_pass2<float2, true>: the M1-point inverse FFTs, the
//      valid half as sample pairs.
//
// One row pair a block (M2 threads, 32 at p = 512 to 256 at p = 65536)
// gives C * M1/2 blocks: 256 at C = 8, p = 8192.  Device-memory traffic
// a frame: 4p B of samples in, 2 x 16p B of scratch round trips, 4p B
// out (40p B), against 72p B for the full-length design and 56p B for
// the three packed frame kernels (which also write and read X and Y).
// The scratch round trips remain; keeping them out needs a whole
// frame's FFT in one block.
//
// Bins 0 and p take real X and Y, as the plain inverse does.  The sum
// runs over j ascending, as in _mac_kernel.

constexpr int kLogMidFrames = 1;                     // frames a step: 2
constexpr int kMidFrames = 1 << kLogMidFrames;
constexpr int kMidMaxThreads = 256;                  // M2 at p = 65536

template <int P>
__global__ void FC_BOUNDS(kMidMaxThreads, 2)
fused_packed_rows(float2* __restrict__ scratch, const float2* __restrict__ H,
                  int K, int lM1, int lM2) {
  FC_DYNAMIC_SMEM(float2, fc_smem);
  const int lRs = 1 + kLogMidFrames;                 // rows of a step
  const int M1 = 1 << lM1, M2 = 1 << lM2, ld = row_stride(M2, lRs);
  const int p = M1 * M2;
  const int step = 2 * ld;                           // frame s at s * step
  float2* a = fc_smem;
  float2* b = a + kMidFrames * step;
  float2* twf = b + kMidFrames * step;
  float2* twi = twf + M2;
  // this thread's own twiddles, out of its registers (which hold P = 8
  // without spills only so): the inverse's for its two stores at
  // own[t], own[M2 + t], the split's e^{-i pi k/p} at own[2 M2 + t]
  float2* own = twi + M2;
  const int c = blockIdx.x;
  const int k1 = blockIdx.y;                         // slot 0: row k1,
  const int k1p = packed_partner(k1, M1);            // slot 1: its partner
  const int t = threadIdx.x;
  fill_twiddles(twf, lM2, -1.0f);
  fill_twiddles(twi, lM2, 1.0f);

  // loads and stores: column t of both rows
  const int gm0 = k1 * M2 + t, gm1 = k1p * M2 + t;
  own[t] = Cx<float2>::twiddle(k1 * t, p, 1.0f);
  own[M2 + t] = Cx<float2>::twiddle(k1p * t, p, 1.0f);
  // the bin pair of this thread: bin k in slot sa, bin p - k in slot sb
  // (pairing as in fwd_packed_pass2); `dc`: the thread of bins 0 / p
  // (slot sa) and p/2 (slot sb)
  int sa, sb, k;
  if (k1 != 0) {
    sa = t;
    sb = ld + M2 - 1 - t;
    k = k1 + M1 * t;
  } else if (t < (M2 >> 1)) {                        // row 0 with itself
    sa = t;
    sb = t == 0 ? (M2 >> 1) : M2 - t;
    k = M1 * t;
  } else {                                           // row M1/2 with itself
    const int cc = t - (M2 >> 1);
    sa = ld + cc;
    sb = ld + M2 - 1 - cc;
    k = (M1 >> 1) + M1 * cc;
  }
  const bool dc = k == 0;
  own[2 * M2 + t] = Cx<float2>::twiddle(k, 2 * p, -1.0f);
  float2 ha[P], hb[P], ra[P], rb[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float2* Hj = H + (size_t)j * (p + 1);
    // bin 0 / p: the real parts of H[0] and H[p]; else H[k], H[p-k]
    ha[j] = dc ? make_float2(Hj[0].x, Hj[p].x) : Hj[k];
    hb[j] = Hj[dc ? (p >> 1) : p - k];
    ra[j] = make_float2(0.0f, 0.0f);
    rb[j] = make_float2(0.0f, 0.0f);
  }

  // frame f of channel-stream c at rows + f * p; frames past K are
  // transformed as whatever the buffer holds and then left out
  float2* rows = scratch + (size_t)c * K * p;
  float2 next[kMidFrames][2];
#pragma unroll
  for (int s = 0; s < kMidFrames; ++s) {
    next[s][0] = s < K ? rows[(size_t)s * p + gm0] : make_float2(0.f, 0.f);
    next[s][1] = s < K ? rows[(size_t)s * p + gm1] : make_float2(0.f, 0.f);
  }
  for (int f = 0; f < K; f += kMidFrames) {
    __syncthreads();                 // the last step's reads of a, b done
#pragma unroll
    for (int s = 0; s < kMidFrames; ++s) {
      a[s * step + t] = next[s][0];
      a[s * step + ld + t] = next[s][1];
      const int fn = f + kMidFrames + s;             // prefetch
      if (fn < K) {
        next[s][0] = rows[(size_t)fn * p + gm0];
        next[s][1] = rows[(size_t)fn * p + gm1];
      }
    }
    float2* Z = fft_rows(a, b, twf, lM2, lRs, ld);
#pragma unroll
    for (int s = 0; s < kMidFrames; ++s) {
      if (f + s >= K) break;
      float2* Zs = Z + s * step;
      const float2 zk = Zs[sa], zq = Zs[sb];
      // the split: X[k] = E + w O, X[p-k] = conj(E - w O); bins 0 / p:
      // (X[0], X[p]) = (Re + Im, Re - Im) of Z[0]; p/2: conj Z[p/2]
      float2 xk, xq;
      if (dc) {
        xk = make_float2(zk.x + zk.y, zk.x - zk.y);
        xq = make_float2(zq.x, -zq.y);
      } else {
        const float2 E = make_float2(0.5f * (zk.x + zq.x),
                                     0.5f * (zk.y - zq.y));
        const float2 wk = own[2 * M2 + t];
        const float2 wO = cmul(wk, make_float2(0.5f * (zk.y + zq.y),
                                               0.5f * (zq.x - zk.x)));
        xk = cadd(E, wO);
        xq = make_float2(E.x - wO.x, wO.y - E.y);
      }
#pragma unroll
      for (int j = P - 1; j > 0; --j) {
        ra[j] = ra[j - 1];
        rb[j] = rb[j - 1];
      }
      ra[0] = xk;
      rb[0] = xq;
      float2 yk = make_float2(0.0f, 0.0f), yq = yk;
      if (dc) {                      // real bins 0 and p, side by side
#pragma unroll
        for (int j = 0; j < P; ++j) {
          yk.x += ra[j].x * ha[j].x;
          yk.y += ra[j].y * ha[j].y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          yk.x += ra[j].x * ha[j].x - ra[j].y * ha[j].y;
          yk.y += ra[j].x * ha[j].y + ra[j].y * ha[j].x;
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        yq.x += rb[j].x * hb[j].x - rb[j].y * hb[j].y;
        yq.y += rb[j].x * hb[j].y + rb[j].y * hb[j].x;
      }
      // the pre-combine: W[k] = A + i T B, W[p-k] = conj(A - i T B),
      // T = conj w; bins 0 / p: (Y0 + Yp, Y0 - Yp); p/2: 2 conj Y[p/2]
      if (dc) {
        Zs[sa] = make_float2(yk.x + yk.y, yk.x - yk.y);
        Zs[sb] = make_float2(2.0f * yq.x, -2.0f * yq.y);
      } else {
        const float2 A = make_float2(yk.x + yq.x, yk.y - yq.y);
        const float2 wk = own[2 * M2 + t];
        const float2 tB = cmul(make_float2(wk.x, -wk.y),
                               make_float2(yk.x - yq.x, yk.y + yq.y));
        Zs[sa] = make_float2(A.x - tB.y, A.y + tB.x);
        Zs[sb] = make_float2(A.x + tB.y, tB.x - A.y);
      }
    }
    const float2* Yr = fft_rows(Z, Z == a ? b : a, twi, lM2, lRs, ld);
#pragma unroll
    for (int s = 0; s < kMidFrames; ++s) {
      if (f + s >= K) break;
      float2* out = rows + (size_t)(f + s) * p;
      out[gm0] = cmul(Yr[s * step + t], own[t]);
      out[gm1] = cmul(Yr[s * step + ld + t], own[M2 + t]);
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

// Launches the fused row pass: one row pair a block, M2 threads; in
// shared memory two row buffers, two twiddle tables and three twiddles a
// thread.
template <int P>
int launch_fused_rows(int C, int lM1, int lM2, cudaStream_t st,
                      float2* scratch, const float2* H, int K) {
  const int lRs = 1 + kLogMidFrames;
  const size_t smem =
      (size_t)(2 * (1 << lRs) * row_stride(1 << lM2, lRs) + 5 * (1 << lM2)) *
      sizeof(float2);
  return launch_kernel(fused_packed_rows<P>, dim3(C, 1 << (lM1 - 1)),
                       1 << lM2, smem, st, scratch, H, K, lM1, lM2);
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

// The inverse in T, packed: Y (C, K, p+1) -> y (C, K, p); scratch C*K*p
// values.  Grids of one dimension, a frame's blocks side by side.
template <class T>
int irfft_valid_impl(const void* Y, void* scratch, void* y, int C, int K,
                     int p, void* stream) {
  typedef typename Cx<T>::R Real;
  if (!pow2_partition(p) || C < 1 || K < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int lM = ilog2(p);
  const int lM1 = lM / 2, lM2 = lM - lM1;
  const int rows = C * K;
  const int lR1 = fft_rows_log2<T>(lM2, lM1);
  const int rc = launch_fft<T>(inv_packed_pass1<T>, dim3(rows << (lM1 - lR1)),
                               lR1, lM2, st, (const T*)Y, (T*)scratch, lM1,
                               lM2, lR1);
  if (rc != 0) return rc;
  const int lR2 = fft_rows_log2<T>(lM1, lM2);
  return launch_fft<T>(inv_packed_pass2<T, false>, dim3(rows << (lM2 - lR2)),
                       lR2, lM1, st, (const T*)scratch, (Real*)y, lM1, lM2,
                       lR2);
}

// Shared bytes of a MAC block of G channels: H and G ring columns a bin.
template <class T>
size_t mac_smem(int P, int G) {
  return (size_t)(P + G * (P > 1 ? P - 1 : 1)) * 32 * sizeof(T);
}

// Channels (warps) a MAC block for C channels of P partitions: the power
// of two up to kMacMaxWarps (and not past the one that covers C) giving
// the most warps an SM by shared memory, the larger on a tie (H shared
// by more channels); 0 when P does not fit a block of one.
template <class T>
int mac_block(int C, int P) {
  if (P < 1 || mac_smem<T>(P, 1) > (size_t)kMacSmemMax) return 0;
  int best = 1, best_warps = 0;
  for (int g = 1; g <= kMacMaxWarps && (g == 1 || (g >> 1) < C); g <<= 1) {
    const size_t smem = mac_smem<T>(P, g);
    if (smem > (size_t)kMacSmemMax) break;
    int warps = g * (int)(kSmemPerSM / (smem + kSmemPerBlockReserved));
    if (warps > 64) warps = 64;                // 2048 threads an SM
    if (warps >= best_warps) {
      best = g;
      best_warps = warps;
    }
  }
  return best;
}

template <class T, class Step = MacRounded>
int causal_mac_impl(const void* X, const void* H, void* Y, int C, int K,
                    int B, int P, void* stream) {
  const int G = mac_block<T>(C, P);
  if (G == 0 || C < 1 || K < 1 || B < 1) return -1;
  return launch_kernel(causal_mac_kernel<T, Step>,
                       dim3((B + 31) / 32, (C + G - 1) / G), 32 * G,
                       mac_smem<T>(P, G), (cudaStream_t)stream, (const T*)X,
                       (const T*)H, (T*)Y, C, K, B, P);
}

}  // namespace

extern "C" {

// Channels (warps) a MAC block for C channels of P partitions, or 0 when
// P does not fit: complex64 and complex128.
int frame_conv_mac_block(int C, int P) { return mac_block<float2>(C, P); }
int frame_conv_mac_block_c128(int C, int P) {
  return mac_block<double2>(C, P);
}

// Each entry returns 0 on success, -1 for an unsupported shape, else the
// CUDA error.  The transforms take a complex scratch of C*K*p values of
// their complex type; a larger one is fine.
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
// 1 <= P <= 8; scratch: C*K*p complex64 values.
int fused_conv_f32(const void* frames, const void* H, void* scratch,
                   void* y, int C, int K, int p, int P, void* stream) {
  if (!pow2_partition(p) || C < 1 || K < 1 || P < 1 || P > 8) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int lM = ilog2(p);
  const int lM1 = lM / 2, lM2 = lM - lM1;
  const int rows = C * K;
  float2* s = (float2*)scratch;
  const float2* h = (const float2*)H;
  const int lR1 = fft_rows_log2<float2>(lM1, lM2);
  int rc = launch_fft<float2>(fwd_packed_pass1<float2, false>,
                              dim3(rows, (1 << lM2) >> lR1), lR1, lM1, st,
                              (const float*)frames, s, K, lM1, 1 << lM2, lR1);
  if (rc != 0) return rc;
  switch (P) {
    case 1: rc = launch_fused_rows<1>(C, lM1, lM2, st, s, h, K); break;
    case 2: rc = launch_fused_rows<2>(C, lM1, lM2, st, s, h, K); break;
    case 3: rc = launch_fused_rows<3>(C, lM1, lM2, st, s, h, K); break;
    case 4: rc = launch_fused_rows<4>(C, lM1, lM2, st, s, h, K); break;
    case 5: rc = launch_fused_rows<5>(C, lM1, lM2, st, s, h, K); break;
    case 6: rc = launch_fused_rows<6>(C, lM1, lM2, st, s, h, K); break;
    case 7: rc = launch_fused_rows<7>(C, lM1, lM2, st, s, h, K); break;
    default: rc = launch_fused_rows<8>(C, lM1, lM2, st, s, h, K); break;
  }
  if (rc != 0) return rc;
  const int lR3 = fft_rows_log2<float2>(lM1, lM2);
  return launch_fft<float2>(inv_packed_pass2<float2, true>,
                            dim3(rows << (lM2 - lR3)), lR3, lM1, st,
                            (const float2*)s, (float*)y, lM1, lM2, lR3);
}

}  // extern "C"
