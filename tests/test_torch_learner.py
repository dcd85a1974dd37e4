"""The learner of convopeq_tpu_torch (`models/learner.py`) and the
quantizer's per-row form on the CPU, against convopeq_tpu.

- The evaluator's tables and every SpectralEvaluator method equal the
  JAX package's (host NumPy copies) within 1e-12 relative.
- The quantizer with one coefficient row a signal row (lattice modes)
  equals the shared form row by row, bit for bit, in f32 and f64, and
  raises in the other modes; the CUDA source's per-row step, compiled for
  the host by tests/quantize_host_emulation.cpp, equals the plain
  version bit for bit.
- `simulate_shaper_error` against JAX `lattice_dither(ladder="fir")` in
  f64: q bit for bit, as tests/test_torch_dither.py holds the fir ladder
  (at 2^-53 no contracted product moves a rounding decision here).
- One generation's population costs at seed 0 against JAX
  `_population_costs` (1e-9 relative), the population simulated in one
  call of 144 rows; two `feed`s give the same generations, scores and best
  coefficients.
- `compute_phase`, `ntf_l2_gain` (with LATTICE_COEFF_LIMIT) and the
  `store_state` round trip.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from convopeq_tpu.models import learner as jl
from convopeq_tpu_torch.models import dither as td
from convopeq_tpu_torch.models import learner as tl
from convopeq_tpu_torch.ops import quantize_kernels as qk

ROOT = Path(__file__).resolve().parent.parent
SR = 48000.0
H = td.K_OUTPUT_HEADROOM


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _program(sr=SR, n=4096, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return np.stack([0.3 * np.sin(2 * np.pi * 440 * t)
                     + 0.01 * rng.normal(size=n),
                     0.2 * np.sin(2 * np.pi * 660 * t + 1.0)
                     + 0.01 * rng.normal(size=n)])


@pytest.mark.parametrize("sr", [44100.0, 48000.0, 384000.0])
def test_evaluator_equals_jax(sr):
    je, te = jl.SpectralEvaluator(sr), tl.SpectralEvaluator(sr)
    for name in ("freq", "weights", "ath_db", "jnd_w", "bark", "ath_power",
                 "bin_to_band", "neighbor_range", "bin_width_arr"):
        np.testing.assert_array_equal(getattr(te, name), getattr(je, name))
    for name in ("flat_lo", "flat_hi", "high_bin", "uh_bin",
                 "expected_uh_share", "hf_penalty_weight"):
        assert getattr(te, name) == getattr(je, name)
    f = np.linspace(0.0, sr / 2, 777)
    for fn in ("a_weight_power", "ath_spl_db", "jnd_weight",
               "freq_to_bark"):
        args = (f, sr / 2) if fn == "a_weight_power" else (f,)
        assert _rel(getattr(tl, fn)(*args), getattr(jl, fn)(*args)) <= 1e-12
    d = np.linspace(-9.0, 9.0, 301)
    tonal = d > 0.3
    np.testing.assert_array_equal(tl._spread_db(d, tonal),
                                  jl._spread_db(d, tonal))
    rng = np.random.default_rng(4)
    block = _program(sr)
    err = rng.normal(size=(2, 4096)) * 3e-5 + 1e-4 * np.sin(
        2 * np.pi * 3000.0 * np.arange(4096) / sr)
    thr_t = te.signal_masking_thresholds(block[0], block[1])
    thr_j = je.signal_masking_thresholds(block[0], block[1])
    assert _rel(thr_t, thr_j) <= 1e-12
    p = np.maximum(tl.K_MIN_POWER, np.abs(np.fft.rfft(err[0])) ** 2)
    mt, ct = te._detect_tonal_maskers(p)
    mj, cj = je._detect_tonal_maskers(p)
    np.testing.assert_array_equal(ct, cj)
    assert len(mt) == len(mj)
    nt, nj = te._build_noise_maskers(p, ct), je._build_noise_maskers(p, cj)
    assert len(nt) == len(nj)
    for a, b in zip(mt + nt, mj + nj):
        assert a[2:] == b[2:] and _rel(a[:2], b[:2]) <= 1e-12
    assert _rel(te._masking_energy(mt + nt), je._masking_energy(mj + nj)) \
        <= 1e-12
    for thr in (None, thr_t):
        rt, rj = te.evaluate(err[0], err[1], thr), je.evaluate(
            err[0], err[1], thr)
        for k in ("noise_power", "spectral_flatness_penalty", "hf_penalty",
                  "time_domain_rms", "composite_score"):
            assert _rel(getattr(rt, k), getattr(rj, k)) <= 1e-12, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["lattice", "lattice_fir"])
def test_per_row_equals_shared(mode, dtype):
    """Rows with their own coefficients equal the shared form run with
    each row's coefficients alone, bit for bit, q and state."""
    rng = np.random.default_rng(5)
    R, N = 6, 300
    K = td.lattice_coeffs(rng.normal(size=(R, 9)) * 0.3)
    x = torch.from_numpy(rng.normal(size=(R, N)) * 0.4).to(dtype)
    u = torch.from_numpy(rng.random(size=(R, N, 2))).to(dtype)
    s0 = torch.from_numpy(rng.normal(size=(R, 9)) * 1e-4).to(dtype)
    scale = 2.0 ** -15
    q, s = qk.error_feedback_quantize(x, u, K, scale, H, mode, s0)
    for r in range(R):
        qr, sr_ = qk.error_feedback_quantize(
            x[r:r + 1], u[r:r + 1], K[r], scale, H, mode, s0[r:r + 1])
        assert torch.equal(q[r:r + 1], qr) and torch.equal(s[r:r + 1], sr_)
    # equal rows: the per-row form equals the shared form on all rows
    qs, ss = qk.error_feedback_quantize(x, u, K[0], scale, H, mode, s0)
    qe, se = qk.error_feedback_quantize(x, u, np.tile(K[0], (R, 1)), scale,
                                        H, mode, s0)
    assert torch.equal(qs, qe) and torch.equal(ss, se)
    # through lattice_dither: (..., 9) coefficients with x's batch shape
    ladder = "fir" if mode == "lattice_fir" else "reference"
    y = td.lattice_dither(x.reshape(2, 3, N), u.reshape(2, 3, N, 2),
                          K.reshape(2, 3, 9), 16, ladder=ladder)
    y0 = td.lattice_dither(x, u, K, 16, ladder=ladder)
    assert torch.equal(y.reshape(R, N), y0)


def test_per_row_rejected_outside_lattice():
    x = torch.zeros((2, 8), dtype=torch.float64)
    u = torch.zeros((2, 8, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        qk.error_feedback_quantize(x, u, np.zeros((2, 4)), 2.0 ** -15, H,
                                   "fixed")
    with pytest.raises(ValueError):
        qk.error_feedback_quantize(x, u, np.zeros((3, 9)), 2.0 ** -15, H,
                                   "lattice_fir")


def test_per_row_emulated_equals_plain(tmp_path):
    """The CUDA source's per-row form (ef_row_consts feeding the step),
    built for the host, against the plain version, f32 and f64, over
    ragged tiles and batches."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    out = tmp_path / "libquantize_emu.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out),
                    str(ROOT / "tests" / "quantize_host_emulation.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P_, I_, D_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.emu_quantize_rows_f32, lib.emu_quantize_rows_f64):
        fn.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, P_, I_, D_, D_]
    rng = np.random.default_rng(9)
    for dtype, fn in ((torch.float32, lib.emu_quantize_rows_f32),
                      (torch.float64, lib.emu_quantize_rows_f64)):
        for mode in ("lattice", "lattice_fir"):
            R, N = 5, 203                       # ragged tile and batch
            K = torch.from_numpy(td.lattice_coeffs(
                rng.normal(size=(R, 9)) * 0.3)).to(dtype)
            x = torch.from_numpy(rng.normal(size=(R, N)) * 0.4).to(dtype)
            u = torch.from_numpy(rng.random(size=(R, N, 2))).to(dtype)
            s0 = torch.zeros((R, 9), dtype=dtype)
            for bits in (16, 24):
                scale = 2.0 ** -(bits - 1)
                want_q, want_s = qk.error_feedback_quantize_plain(
                    x, u, K, scale, H, mode, s0)
                q, s = torch.empty_like(x), torch.empty_like(s0)
                assert fn(x.data_ptr(), u.data_ptr(), s0.data_ptr(),
                          q.data_ptr(), s.data_ptr(), R, N, qk.MODES[mode],
                          K.data_ptr(), 9, scale, H) == 0
                assert torch.equal(q, want_q) and torch.equal(s, want_s)
            # the per-row entry refuses the other modes
            assert fn(x.data_ptr(), u.data_ptr(), s0.data_ptr(),
                      q.data_ptr(), s.data_ptr(), R, N, qk.MODES["fixed"],
                      K.data_ptr(), 9, 2.0 ** -15, H) != 0


def test_simulate_shaper_error_equals_jax():
    rng = np.random.default_rng(8)
    audio = _program() * 0.8
    u = rng.uniform(size=audio.shape + (2,))
    k = rng.normal(size=9) * 0.2
    et = tl.simulate_shaper_error(audio, k, SR, 16, uniforms=u,
                                  device="cpu")
    ej = jl.simulate_shaper_error(audio, k, SR, 16, uniforms=u)
    np.testing.assert_array_equal(et, ej)


@pytest.fixture(scope="module")
def generations():
    """Two generations of the JAX learner and the port's on the same
    captured block, seed 0, and the first generation's candidates and
    costs (one population call each)."""
    audio = _program()
    J = jl.NoiseShaperLearner(SR, 16, 0, seed=0, workers=2)
    T = tl.NoiseShaperLearner(SR, 16, 0, seed=0, workers=2, device="cpu")
    cj, ct = J.opt.sample(), T.opt.sample()
    fj, ft = J._population_costs(cj, audio), T._population_costs(ct, audio)
    J.opt.update(cj, fj)
    T.opt.update(ct, ft)
    sj, st = J.feed(audio), T.feed(audio)
    return cj, ct, fj, ft, sj, st, T


def test_population_costs_equal_jax(generations):
    cj, ct, fj, ft, _, _, T = generations
    np.testing.assert_array_equal(ct, cj)
    assert ft.shape == (18,) and np.isfinite(ft).all()
    assert _rel(ft, fj) <= 1e-9
    assert T.sim_seconds > 0 and T.eval_seconds > 0


def test_feed_equals_jax(generations):
    _, _, _, _, sj, st, T = generations
    assert st.generations == sj.generations == 1
    assert _rel(st.best_score, sj.best_score) <= 1e-9
    np.testing.assert_array_equal(st.best_coefficients, sj.best_coefficients)
    assert st.bank_index == sj.bank_index
    assert T.phase == 1 and T.accumulated_seconds == pytest.approx(4096 / SR)


def test_phase_ntf_and_store_state():
    for mode in range(7):
        for secs in (0.0, 4.9, 5.0, 29.9, 30.0, 59.0, 61.0, 130.0, 250.0):
            assert tl.compute_phase(mode, secs) == jl.compute_phase(mode,
                                                                    secs)
    assert tl.PHASE_PARAMS == jl.PHASE_PARAMS
    assert tl.TARGET_LEVELS == jl.TARGET_LEVELS
    for ph, w in jl.LEVEL_WEIGHTS_BY_PHASE.items():
        np.testing.assert_array_equal(tl.LEVEL_WEIGHTS_BY_PHASE[ph], w)
    rng = np.random.default_rng(10)
    for _ in range(5):
        k = rng.normal(size=9) * 0.6
        assert tl.ntf_l2_gain(k) == jl.ntf_l2_gain(k)
    assert tl.ntf_l2_gain([np.nan] + [2.0] * 8) == \
        jl.ntf_l2_gain([np.nan] + [2.0] * 8)
    st = tl.LearnedState(best_coefficients=rng.normal(size=9) * 0.1,
                         best_score=1.5, generations=3)
    banks = tl.AdaptiveCoefficientBanks().store_state(st, 96000.0, 24, 2)
    back = tl.AdaptiveCoefficientBanks.from_dict(banks.to_dict())
    np.testing.assert_array_equal(back.get(96000.0, 24, 2),
                                  st.best_coefficients)
    jb = jl.AdaptiveCoefficientBanks().store_state(
        jl.LearnedState(st.best_coefficients, 1.5, 3), 96000.0, 24, 2)
    assert banks.to_dict() == jb.to_dict()
