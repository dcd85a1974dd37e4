// Overlap-save frame kernels of the folded convolution chain, for Hopper
// (sm_90a), f32 on the FP32 CUDA cores.  Three kernels, one per TPU
// Pallas kernel on the path (convopeq_tpu/ops/pallas_gemm_fft.py):
//
//   frames_rfft   replaces _fwd_frames_kernel (rfft_frames_two_stage_pallas)
//   causal_mac    replaces _mac_kernel        (causal_mac_grid_pallas)
//   irfft_valid   replaces _inv_kernel        (irfft_valid_two_stage_pallas)
//
// Layout: spectra in natural bin order, (C, K, p+1) interleaved complex64.
// Frame f = c*K + k of channel-stream c.  The overlap-save frame of frame
// k is [frames[k-1] | frames[k]] (zero prev for k == 0), N = 2p points.
//
// Transforms: the four-step FFT with N = N1*N2 (N1 = 2^floor(lg N / 2)).
// A 2p = 65536-point complex frame is 512 KB, more than a block's 227 KB
// of shared memory, so each transform runs as two passes through a
// global complex scratch of N points per frame: pass 1 does the N1- (or
// N2-) point FFTs of a group of R rows in shared memory and applies the
// twiddle, pass 2 does the other factor's FFTs and writes only what the
// caller keeps.  Row FFTs are radix-4 Stockham autosort in shared memory
// with a per-block twiddle table from sincospif (exact arguments: every
// angle is a dyadic multiple of pi).
//
// Every kernel loops over its work with a stride of blockDim.x, so its
// result does not depend on the block size it is launched with.  With
// FRAME_CONV_HOST_EMULATION defined, FC_LAUNCH, FC_DYNAMIC_SMEM and the
// CUDA names used here come from a host emulator that runs each block as
// one thread (tests/frame_conv_host_emulation.cpp).

#ifndef FRAME_CONV_HOST_EMULATION
#include <cuda_runtime.h>
#define FC_LAUNCH(kernel, grid, block, smem, stream) \
    kernel<<<(grid), (block), (smem), (stream)>>>
#define FC_DYNAMIC_SMEM(name) extern __shared__ float2 name[]
#endif

#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowElems = 4096;   // R * M complex values per FFT block
constexpr int kMacSmemMax = 232448;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{sign * 2 pi i idx / N} for 0 <= idx < N, N a power of two.
__device__ __forceinline__ float2 twiddle(int idx, int N, float sign) {
  float s, c;
  sincospif(sign * 2.0f * (float)idx / (float)N, &s, &c);
  return make_float2(c, s);
}

// tw[j] = e^{sign * 2 pi i j / M}, j < M.
__device__ void fill_twiddles(float2* tw, int lM, float sign) {
  const int M = 1 << lM;
  for (int j = threadIdx.x; j < M; j += blockDim.x)
    tw[j] = twiddle(j, M, sign);
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
__device__ float2* fft_rows(float2* a, float2* b, const float2* tw, int lM,
                            int lR, int ld) {
  const int M = 1 << lM;
  const int quarter = M >> 2;
  int ls = 0;
  for (; ls + 2 <= lM; ls += 2) {
    const int s = 1 << ls;
    const int lq = lM - 2;                     // butterflies per row: M/4
    __syncthreads();
    const float2 w4 = tw[quarter];
    for (int t = threadIdx.x; t < (1 << (lR + lq)); t += blockDim.x) {
      const int r = t >> lq;
      const int u = t & (quarter - 1);
      const int pp = u >> ls;
      const int q = u & (s - 1);
      const float2* x = a + r * ld + q + s * pp;
      float2* y = b + r * ld + q + 4 * s * pp;
      const float2 a0 = x[0], a1 = x[quarter];
      const float2 a2 = x[2 * quarter], a3 = x[3 * quarter];
      const float2 b0 = cadd(a0, a2), b1 = csub(a0, a2);
      const float2 b2 = cadd(a1, a3), b3 = cmul(csub(a1, a3), w4);
      const int w = pp * s;
      y[0] = cadd(b0, b2);
      y[s] = cmul(cadd(b1, b3), tw[w]);
      y[2 * s] = cmul(csub(b0, b2), tw[2 * w]);
      y[3 * s] = cmul(csub(b1, b3), tw[3 * w]);
    }
    float2* tmp = a;
    a = b;
    b = tmp;
  }
  if (ls < lM) {                               // radix-2: s = M/2, p = 0
    const int half = M >> 1;
    __syncthreads();
    for (int t = threadIdx.x; t < (1 << (lR + lM - 1)); t += blockDim.x) {
      const int r = t >> (lM - 1);
      const int q = t & (half - 1);
      const float2 A = a[r * ld + q];
      const float2 B = a[r * ld + q + half];
      b[r * ld + q] = cadd(A, B);
      b[r * ld + q + half] = csub(A, B);
    }
    float2* tmp = a;
    a = b;
    b = tmp;
  }
  __syncthreads();
  return a;
}

// ---- forward: frames (C, K, p) f32 -> X (C, K, p+1) c64 -------------
// osa index n = n1*N2 + n2;  bin k = k1 + N1*k2.

// Pass 1: block (f, group of R columns n2): N1-point FFT over n1 of
// osa[n1*N2 + n2], times W_N^{n2*k1}, to scratch[f][k1][n2].
__global__ void fwd_pass1(const float* __restrict__ frames,
                          float2* __restrict__ scratch, int K, int p,
                          int lN1, int N2, int lR) {
  FC_DYNAMIC_SMEM(fc_smem);
  const int N1 = 1 << lN1, R = 1 << lR, ld = row_stride(N1, lR);
  float2* a = fc_smem;
  float2* b = a + R * ld;
  float2* tw = b + R * ld;
  const int f = blockIdx.x;
  const int k = f % K;
  const int n20 = blockIdx.y * R;
  const float* cur = frames + (size_t)f * p;
  fill_twiddles(tw, lN1, -1.0f);
  for (int e = threadIdx.x; e < R * N1; e += blockDim.x) {
    const int n1 = e >> lR;
    const int r = e & (R - 1);
    const int j = n1 * N2 + n20 + r;          // index in the osa frame
    // j < p reads frame k-1 (cur - p), zero before the first frame
    const float v = (j >= p || k > 0) ? cur[j - p] : 0.0f;
    a[r * ld + n1] = make_float2(v, 0.0f);
  }
  const float2* res = fft_rows(a, b, tw, lN1, lR, ld);
  const int N = N1 * N2;
  for (int e = threadIdx.x; e < R * N1; e += blockDim.x) {
    const int k1 = e >> lR;
    const int r = e & (R - 1);
    const int n2 = n20 + r;
    scratch[((size_t)f * N1 + k1) * N2 + n2] =
        cmul(res[r * ld + k1], twiddle(n2 * k1, N, -1.0f));
  }
}

// Pass 2: block (f, group of R rows k1): N2-point FFT over n2, keeping
// bins k = k1 + N1*k2 <= p.
__global__ void fwd_pass2(const float2* __restrict__ scratch,
                          float2* __restrict__ X, int p, int N1, int lN2,
                          int lR) {
  FC_DYNAMIC_SMEM(fc_smem);
  const int N2 = 1 << lN2, R = 1 << lR, ld = row_stride(N2, lR);
  float2* a = fc_smem;
  float2* b = a + R * ld;
  float2* tw = b + R * ld;
  const int f = blockIdx.x;
  const int k10 = blockIdx.y * R;
  const float2* src = scratch + ((size_t)f * N1 + k10) * N2;
  fill_twiddles(tw, lN2, -1.0f);
  for (int e = threadIdx.x; e < R * N2; e += blockDim.x)
    a[(e >> lN2) * ld + (e & (N2 - 1))] = src[e];
  const float2* res = fft_rows(a, b, tw, lN2, lR, ld);
  float2* Xf = X + (size_t)f * (p + 1);
  const int nk2 = (N2 >> 1) + 1;
  for (int e = threadIdx.x; e < R * nk2; e += blockDim.x) {
    const int k2 = e >> lR;
    const int r = e & (R - 1);
    const int kk = k10 + r + N1 * k2;
    if (kk <= p) Xf[kk] = res[r * ld + k2];
  }
}

// ---- inverse: Y (C, K, p+1) c64 -> y (C, K, p) f32, valid half -------
// Hermitian spectrum Z[k] (Z[N-k] = conj Z[k]; DC and Nyquist imaginary
// parts ignored), y[n] = (1/N) sum_k Z[k] e^{+2 pi i k n / N} for
// n in [p, 2p).  k = ka + N1*kb, n = nb + N2*na: the valid half is
// exactly na >= N1/2.

// Pass 1: block (f, group of R values ka): N2-point inverse FFT over kb,
// times e^{+2 pi i ka*nb / N}, to scratch[f][nb][ka].
__global__ void inv_pass1(const float2* __restrict__ Y,
                          float2* __restrict__ scratch, int p, int N1,
                          int lN2, int lR) {
  FC_DYNAMIC_SMEM(fc_smem);
  const int N2 = 1 << lN2, R = 1 << lR, ld = row_stride(N2, lR);
  float2* a = fc_smem;
  float2* b = a + R * ld;
  float2* tw = b + R * ld;
  const int f = blockIdx.x;
  const int ka0 = blockIdx.y * R;
  const int N = N1 * N2;
  const float2* Yf = Y + (size_t)f * (p + 1);
  fill_twiddles(tw, lN2, 1.0f);
  for (int e = threadIdx.x; e < R * N2; e += blockDim.x) {
    const int kb = e >> lR;
    const int r = e & (R - 1);
    const int kk = ka0 + r + N1 * kb;
    float2 v;
    if (kk == 0 || kk == p) {
      v = make_float2(Yf[kk].x, 0.0f);
    } else if (kk < p) {
      v = Yf[kk];
    } else {
      const float2 t = Yf[N - kk];
      v = make_float2(t.x, -t.y);
    }
    a[r * ld + kb] = v;
  }
  const float2* res = fft_rows(a, b, tw, lN2, lR, ld);
  for (int e = threadIdx.x; e < R * N2; e += blockDim.x) {
    const int nb = e >> lR;
    const int r = e & (R - 1);
    const int ka = ka0 + r;
    scratch[((size_t)f * N2 + nb) * N1 + ka] =
        cmul(res[r * ld + nb], twiddle(ka * nb, N, 1.0f));
  }
}

// Pass 2: block (f, group of R values nb): N1-point inverse FFT over ka,
// real part of the outputs na >= N1/2 only, scaled by 1/N.
__global__ void inv_pass2(const float2* __restrict__ scratch,
                          float* __restrict__ y, int p, int lN1, int N2,
                          int lR) {
  FC_DYNAMIC_SMEM(fc_smem);
  const int N1 = 1 << lN1, R = 1 << lR, ld = row_stride(N1, lR);
  float2* a = fc_smem;
  float2* b = a + R * ld;
  float2* tw = b + R * ld;
  const int f = blockIdx.x;
  const int nb0 = blockIdx.y * R;
  const float2* src = scratch + ((size_t)f * N2 + nb0) * N1;
  fill_twiddles(tw, lN1, 1.0f);
  for (int e = threadIdx.x; e < R * N1; e += blockDim.x)
    a[(e >> lN1) * ld + (e & (N1 - 1))] = src[e];
  const float2* res = fft_rows(a, b, tw, lN1, lR, ld);
  const float scale = 1.0f / (float)(N1 * N2);
  const int hA = N1 >> 1;
  float* yf = y + (size_t)f * p;
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
// no barrier is needed.  j ascends from 0, as in the TPU kernel.
__global__ void causal_mac_kernel(const float2* __restrict__ X,
                                  const float2* __restrict__ H,
                                  float2* __restrict__ Yout, int K, int B,
                                  int P, int bt) {
  FC_DYNAMIC_SMEM(fc_smem);
  float2* ring = fc_smem;          // [slot][lb]
  float2* hs = fc_smem + P * bt;   // [j][lb]
  const int c = blockIdx.x;
  const int b0 = blockIdx.y * bt;
  const int nb = (B - b0 < bt) ? (B - b0) : bt;
  for (int lb = threadIdx.x; lb < nb; lb += blockDim.x) {
    const int b = b0 + lb;
    for (int j = 0; j < P; ++j) hs[j * bt + lb] = H[(size_t)j * B + b];
    const float2* Xc = X + (size_t)c * K * B + b;
    float2* Yc = Yout + (size_t)c * K * B + b;
    int slot = 0;                  // ring slot of frame f: f % P
    float2 xn = Xc[0];
    for (int f = 0; f < K; ++f) {
      const float2 xf = xn;
      if (f + 1 < K) xn = Xc[(size_t)(f + 1) * B];
      ring[slot * bt + lb] = xf;
      const int jmax = (f < P - 1) ? f : (P - 1);
      float2 acc = make_float2(0.0f, 0.0f);
      int s = slot;
      for (int j = 0; j <= jmax; ++j) {
        const float2 xv = ring[s * bt + lb];
        const float2 hv = hs[j * bt + lb];
        acc.x += xv.x * hv.x - xv.y * hv.y;
        acc.y += xv.x * hv.y + xv.y * hv.x;
        s = (s == 0) ? (P - 1) : (s - 1);
      }
      Yc[(size_t)f * B] = acc;
      slot = (slot + 1 == P) ? 0 : (slot + 1);
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

// log2 of the rows per FFT block for row length M = 2^lM, limited by
// the number of rows 2^lrows
int fft_rows_log2(int lM, int lrows) {
  int lR = ilog2(kRowElems) - lM;
  if (lR < 0) lR = 0;
  if (lR > lrows) lR = lrows;
  return lR;
}

// Launches one transform pass: 2^lR rows of 2^lM points a block, two
// row buffers and the twiddle table in dynamic shared memory (allowed
// explicitly, since it may exceed the default 48 KB).
template <class Kernel, class... Args>
int launch_fft(Kernel kernel, dim3 grid, int lR, int lM, cudaStream_t st,
               Args... args) {
  const size_t smem =
      (size_t)(2 * (1 << lR) * row_stride(1 << lM, lR) + (1 << lM)) *
      sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  FC_LAUNCH(kernel, grid, dim3(kThreads), smem, st)(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bins per MAC block for P partitions, or 0 when P does not fit.
int frame_conv_mac_tile(int P) {
  for (int bt = 128; bt >= 32; bt >>= 1)
    if ((size_t)2 * P * bt * sizeof(float2) <= (size_t)kMacSmemMax)
      return bt;
  return 0;
}

// Complex scratch the transforms need: C*K*2p complex64 values.
// Returns 0 on success, -1 for an unsupported shape, else the CUDA error.
int frames_rfft_f32(const void* frames, void* scratch, void* X, int C,
                    int K, int p, void* stream) {
  if (!pow2_partition(p) || C < 1 || K < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int lN = ilog2(2 * p);
  const int lN1 = lN / 2, lN2 = lN - lN1;
  const int N1 = 1 << lN1, N2 = 1 << lN2;
  const int rows = C * K;
  const int lR1 = fft_rows_log2(lN1, lN2);
  const int rc = launch_fft(fwd_pass1, dim3(rows, N2 >> lR1), lR1, lN1, st,
                            (const float*)frames, (float2*)scratch, K, p,
                            lN1, N2, lR1);
  if (rc != 0) return rc;
  const int lR2 = fft_rows_log2(lN2, lN1);
  return launch_fft(fwd_pass2, dim3(rows, N1 >> lR2), lR2, lN2, st,
                    (const float2*)scratch, (float2*)X, p, N1, lN2, lR2);
}

int irfft_valid_f32(const void* Y, void* scratch, void* y, int C, int K,
                    int p, void* stream) {
  if (!pow2_partition(p) || C < 1 || K < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int lN = ilog2(2 * p);
  const int lN1 = lN / 2, lN2 = lN - lN1;
  const int N1 = 1 << lN1, N2 = 1 << lN2;
  const int rows = C * K;
  const int lR1 = fft_rows_log2(lN2, lN1);
  const int rc = launch_fft(inv_pass1, dim3(rows, N1 >> lR1), lR1, lN2, st,
                            (const float2*)Y, (float2*)scratch, p, N1, lN2,
                            lR1);
  if (rc != 0) return rc;
  const int lR2 = fft_rows_log2(lN1, lN2);
  return launch_fft(inv_pass2, dim3(rows, N2 >> lR2), lR2, lN1, st,
                    (const float2*)scratch, (float*)y, p, lN1, N2, lR2);
}

int causal_mac_c64(const void* X, const void* H, void* Y, int C, int K,
                   int B, int P, void* stream) {
  const int bt = frame_conv_mac_tile(P);
  if (bt == 0 || C < 1 || K < 1 || B < 1) return -1;
  const size_t smem = (size_t)2 * P * bt * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      causal_mac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  FC_LAUNCH(causal_mac_kernel, dim3(C, (B + bt - 1) / bt), dim3(bt), smem,
            (cudaStream_t)stream)((const float2*)X, (const float2*)H,
                                  (float2*)Y, K, B, P, bt);
  return (int)cudaGetLastError();
}

}  // extern "C"
