// Host emulation of convopeq_tpu_torch/csrc/error_feedback_quantize.cu,
// for checking the quantizer's arithmetic on a machine without a GPU.
//
// It compiles the source's per-sample step, the copy warp's terms (xh and
// the dither term d), the chain warp's batched loop over one row of a
// stage, the tiling constants and the mode dispatch
// (EF_QUANTIZE_HOST_EMULATION), and drives them as the kernel does: each
// row walks the signal in tiles of EfTile<T>::kSteps samples; for each
// tile the copy warp's terms fill a stage row of kLd values (x becomes xh
// in place, d beside it), the chain's loop runs whole batches of kEfBatch
// steps and then the ragged rest, and q is read back from where xh was,
// with the state carried in registers from tile to tile.  The per-row
// form (the lattice modes) takes each row's coefficients through the
// source's ef_row_consts, as the chain lane loads them.  It does not
// check the kernel's copies, mbarriers or warp roles, which run only on
// the card.  The rounding's form is the one the kernel's host code picks
// (ef_folds), or, with `form` 0 or 1, rint or the folded add pair.  Build with contraction off, as the kernel is built with
// -fmad=false (one command):
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libquantize_emu.so tests/quantize_host_emulation.cpp
#include <algorithm>
#include <vector>

#define EF_QUANTIZE_HOST_EMULATION 1
#include "../convopeq_tpu_torch/csrc/error_feedback_quantize.cu"

namespace {

// row_coeffs: null (the shared form, coeffs) or (R, order) values of T
// (the per-row form, lattice modes only); form: -1 the host's choice, 0
// rint, 1 the folded add pair
template <typename T>
int emu_run(const T* x, const T* u, const T* state_in, T* q, T* state_out,
            int R, int N, int mode, const double* coeffs,
            const T* row_coeffs, int order, double scale, double headroom,
            int form) {
  using Tl = EfTile<T>;
  if (row_coeffs && mode != EF_LATTICE && mode != EF_LATTICE_FIR) return -1;
  const EfConsts<T> k0 = row_coeffs
                             ? ef_consts<T>(nullptr, 0, scale, headroom)
                             : ef_consts<T>(coeffs, order, scale, headroom);
  const bool fold = form < 0 ? ef_folds<T>(mode, scale) : form == 1;
  return ef_dispatch(mode, order, [&](auto m, auto o) -> int {
    constexpr int M = decltype(m)::value;
    constexpr int O = decltype(o)::value;
    std::vector<T> xq(Tl::kLd), d(Tl::kLd);
    for (int r = 0; r < R; ++r) {
      const EfConsts<T> k =
          row_coeffs ? ef_row_consts<T, O>(k0, row_coeffs + (size_t)r * O)
                     : k0;
      T s[O];
      for (int i = 0; i < O; ++i) s[i] = state_in[(size_t)r * O + i];
      for (int t0 = 0; t0 < N; t0 += Tl::kSteps) {
        const int steps = std::min(Tl::kSteps, N - t0);
        const size_t off = (size_t)r * N + t0;
        for (int j = 0; j < steps; ++j) {
          xq[j] = ef_xh(x[off + j], k);
          d[j] = ef_dither<T, M>(u[2 * (off + j)], u[2 * (off + j) + 1], k);
        }
        if (fold)
          ef_run_tile<T, M, O, true>(xq.data(), d.data(), steps, s, k);
        else
          ef_run_tile<T, M, O, false>(xq.data(), d.data(), steps, s, k);
        std::copy(xq.begin(), xq.begin() + steps, q + off);
      }
      for (int i = 0; i < O; ++i) state_out[(size_t)r * O + i] = s[i];
    }
    return 0;
  });
}

}  // namespace

extern "C" {

// samples a tile for values of `itemsize` bytes (4 or 8)
int emu_tile(int itemsize) {
  return itemsize == 4 ? EfTile<float>::kSteps : EfTile<double>::kSteps;
}

int emu_batch() { return kEfBatch; }

int emu_supported(int mode, int order) {
  return ef_dispatch(mode, order, [](auto, auto) { return 1; }) == 1;
}

// the kernel's choice of the rounding's form (1 folded, 0 rint)
int emu_folds(int mode, double scale, int itemsize) {
  return itemsize == 4 ? ef_folds<float>(mode, scale)
                       : ef_folds<double>(mode, scale);
}

int emu_quantize_f32(const float* x, const float* u, const float* state_in,
                     float* q, float* state_out, int R, int N, int mode,
                     const double* coeffs, int order, double scale,
                     double headroom, int form) {
  return emu_run<float>(x, u, state_in, q, state_out, R, N, mode, coeffs,
                        nullptr, order, scale, headroom, form);
}

int emu_quantize_f64(const double* x, const double* u,
                     const double* state_in, double* q, double* state_out,
                     int R, int N, int mode, const double* coeffs, int order,
                     double scale, double headroom, int form) {
  return emu_run<double>(x, u, state_in, q, state_out, R, N, mode, coeffs,
                         nullptr, order, scale, headroom, form);
}

int emu_quantize_rows_f32(const float* x, const float* u,
                          const float* state_in, float* q, float* state_out,
                          int R, int N, int mode, const float* row_coeffs,
                          int order, double scale, double headroom) {
  return emu_run<float>(x, u, state_in, q, state_out, R, N, mode, nullptr,
                        row_coeffs, order, scale, headroom, -1);
}

int emu_quantize_rows_f64(const double* x, const double* u,
                          const double* state_in, double* q,
                          double* state_out, int R, int N, int mode,
                          const double* row_coeffs, int order, double scale,
                          double headroom) {
  return emu_run<double>(x, u, state_in, q, state_out, R, N, mode, nullptr,
                         row_coeffs, order, scale, headroom, -1);
}

}  // extern "C"
