"""IR phase conversion: minimum phase (cepstral) and mixed phase
(counterpart of convopeq_tpu/ir/phase.py; the port's own host NumPy
copy, f64).

Minimum phase — exact transcription of convertToMinimumPhase
(src/convolver/ConvolverProcessor.ResampleAndFallback.cpp:333-469):
  fftSize = nextPow2(4*N), cap 8,388,608;
  X = FFT(x); logmag = ln(max(|X|, 1e-300));
  c = IFFT(logmag) (complex cepstrum of the magnitude);
  fold: c[0] kept, c[1..N/2-1] *= 2, c[N/2] kept, upper half zeroed
  (imag parts zeroed);
  C = FFT(c); clamp Re/Im to +-50; H = exp(C); h = Re(IFFT(H))[:N],
  |h| < 1e-18 flushed to zero.

Mixed phase:
- primary path (convertToMixedPhaseAllpass, MixedPhase.cpp:140-640):
  target phase = crossfade between linear phase (-w*peakDelay) and the
  unwrapped minimum phase across [transitionLo, transitionHi] (raised
  cosine); slope-limited (max group delay 120 samples); target group
  delay = -dphi/dw - peakDelay, smoothed (moving average +-5 bins, offset
  to nonnegative + 5, one-pole alpha=0.45, clamped [0, 120]); a 2nd-order
  allpass cascade is CMA-ES-designed on a log-spaced grid (20 Hz..fs/2,
  256 points offline / 20 sections) to match it, applied to the linear
  spectrum, then RMS-renormalized to the linear IR.
- fallback (convertToMixedPhaseFallback, MixedPhase.cpp:700-870): direct
  spectral blend — rotate the linear spectrum by the unwrapped
  delta phase = target phase - linear phase.

Host NumPy (loader-thread work in the reference).  The per-bin loops of
the JAX package run here on Python floats, or as forward fills where a
bin's test reads only its own input value: the same IEEE operations in
the same order, so the same numbers, in a fraction of the time over the
~2M bins of a 1M-tap IR.
"""
from __future__ import annotations

import numpy as np

from .allpass import (DesignerConfig, compute_response, design_cmaes,
                      design_greedy_adagrad, sections_group_delay)
from ..utils.dsputil import next_pow2

MAX_PHASE_FFT_SIZE = 8_388_608
MAX_ALLOWED_GD = 120.0


def minimum_phase(ir: np.ndarray) -> np.ndarray:
    """Cepstral minimum-phase conversion.  ir: (..., N) -> same shape."""
    ir = np.asarray(ir, np.float64)
    n = ir.shape[-1]
    if n <= 0:
        return ir
    fft_size = next_pow2(n * 4)
    if fft_size > MAX_PHASE_FFT_SIZE:
        raise ValueError(f"minimum_phase: fftSize {fft_size} exceeds limit")

    x = np.zeros(ir.shape[:-1] + (fft_size,), np.complex128)
    x[..., :n] = ir
    spec = np.fft.fft(x, axis=-1)
    logmag = np.log(np.maximum(np.abs(spec), 1e-300))
    ceps = np.fft.ifft(logmag.astype(np.complex128), axis=-1)

    half = fft_size // 2
    folded = np.zeros_like(ceps)
    folded[..., 0] = ceps[..., 0].real
    folded[..., 1:half] = 2.0 * ceps[..., 1:half].real
    folded[..., half] = ceps[..., half].real

    spec2 = np.fft.fft(folded, axis=-1)
    spec2 = (np.clip(spec2.real, -50.0, 50.0)
             + 1j * np.clip(spec2.imag, -50.0, 50.0))
    h = np.fft.ifft(np.exp(spec2), axis=-1).real[..., :n]
    if not np.all(np.isfinite(h)):
        raise FloatingPointError("minimum_phase produced non-finite output")
    return np.where(np.abs(h) < 1e-18, 0.0, h)


def unwrap_phase(phase: np.ndarray, tol: float = np.pi) -> np.ndarray:
    """unwrapPhaseRadians (ConvolverProcessor.Internal.h:33-47).

    Faithful to the reference, including its quirk: delta is computed
    against the ALREADY-CORRECTED previous element, so a monotone ramp
    spanning several wraps compounds corrections.  Its call site (the
    fallback's deltaPhi, which has the linear ramp removed) stays within
    one wrap where the variant behaves like a standard unwrap."""
    ph = np.asarray(phase, np.float64).tolist()
    tol = float(tol)
    two_pi = 2.0 * np.pi
    correction = 0.0
    for i in range(1, len(ph)):
        delta = ph[i] - ph[i - 1]
        if delta > tol:
            correction -= two_pi
        elif delta < -tol:
            correction += two_pi
        ph[i] += correction
    return np.asarray(ph, np.float64)


def unwrap_phase_delta(phase: np.ndarray) -> np.ndarray:
    """The allpass path's correct delta-based unwrap
    (MixedPhase.cpp:280-291) — equivalent to np.unwrap."""
    return np.unwrap(np.asarray(phase, np.float64))


def _blend_weight(freq, lo, hi):
    """Raised-cosine minimum-phase weight (1 below lo, 0 above hi)."""
    inv_span = 1.0 / (hi - lo)
    w = np.ones_like(freq)
    x = (freq - lo) * inv_span
    w = np.where(freq >= hi, 0.0,
                 np.where(freq > lo, 0.5 * (1.0 + np.cos(np.pi * x)), w))
    return w


def mixed_phase_fallback(linear_ir, minimum_ir, sample_rate,
                         transition_lo_hz=200.0, transition_hi_hz=700.0):
    """Direct spectral blend (convertToMixedPhaseFallback).  1-D inputs.

    Note the reference's fallback uses fftSize = nextPow2(N) — NOT the
    4N padding of the min-phase converter and the allpass primary path
    (MixedPhase.cpp:749) — accepting the circular wrap of the rotated
    IR into the analysis window.  Pinned against the reference binary
    (tests/test_ref_vectors.py::test_mixed_phase_fallback_matches_
    reference_binary)."""
    x = np.asarray(linear_ir, np.float64)
    m = np.asarray(minimum_ir, np.float64)
    n = x.shape[-1]
    fft_size = next_pow2(n)
    if fft_size > MAX_PHASE_FFT_SIZE:
        raise ValueError("mixed_phase: fftSize exceeds limit")
    half = fft_size // 2
    csize = half + 1

    peak_delay = int(np.argmax(np.abs(x)))
    ls = np.fft.fft(np.concatenate([x, np.zeros(fft_size - n)]))
    ms = np.fft.fft(np.concatenate([m, np.zeros(fft_size - n)]))

    k = np.arange(csize)
    freq = k * sample_rate / fft_size
    w_min = _blend_weight(freq, transition_lo_hz, transition_hi_hz)
    w_lin = 1.0 - w_min
    omega = 2.0 * np.pi * k / fft_size
    phi_lin = -omega * peak_delay
    phi_min = np.arctan2(ms[:csize].imag, ms[:csize].real)
    phi_target = w_lin * phi_lin + w_min * phi_min
    delta_phi = unwrap_phase(phi_target - phi_lin)

    full_dphi = np.empty(fft_size)
    full_dphi[:csize] = delta_phi
    full_dphi[csize:] = -delta_phi[1:half][::-1]
    rot = np.exp(1j * full_dphi)
    y = np.fft.ifft(ls * rot).real[:n]
    return np.where(np.abs(y) < 1e-18, 0.0, y)


def _forward_fill(v, keep, first=None):
    """v with every element where `keep` is False replaced by the last
    kept element before it (by `first` where none is, else left)."""
    idx = np.where(keep, np.arange(len(v)), -1)
    np.maximum.accumulate(idx, out=idx)
    out = v[np.maximum(idx, 0)]
    if first is not None:
        out = np.where(idx >= 0, out, first)
    return out


def _slope_limit(phi, max_slope):
    """phi[k] = phi[k - 1] wherever phi[k] is non-finite or jumps more than
    max_slope from the (already limited) phi[k - 1], k >= 1: the JAX
    package's loop (MixedPhase.cpp:326-340).  A run of accepted bins
    compares original neighbours and a held run one value, so each run is
    found by one vectorized search."""
    phi = np.asarray(phi, np.float64).copy()
    n = len(phi)
    with np.errstate(invalid="ignore"):
        k = 1
        while k < n:
            # accepted bins from k on: finite, within max_slope of the
            # original neighbour (equal to the held value while accepted)
            ok = np.isfinite(phi[k:]) & ~(np.abs(phi[k:] - phi[k - 1:-1])
                                          > max_slope)
            first_bad = int(np.argmin(ok)) if not ok.all() else n - k
            k += first_bad
            if k >= n:
                break
            held = phi[k - 1]
            rest = phi[k:]
            acc = np.isfinite(rest) & ~(np.abs(rest - held) > max_slope)
            run = int(np.argmax(acc)) if acc.any() else n - k
            phi[k:k + run] = held
            k += run + 1       # bin k + run is accepted: compare onwards
    return phi


def _target_group_delay(phi_target, peak_delay, fft_size, csize):
    """Target-GD derivation chain (MixedPhase.cpp:326-445)."""
    d_omega = 2.0 * np.pi / fft_size
    max_slope = MAX_ALLOWED_GD * d_omega

    phi = _slope_limit(phi_target, max_slope)

    gd = np.empty(csize)
    gd[0] = -(phi[1] - phi[0]) / d_omega
    gd[-1] = -(phi[-1] - phi[-2]) / d_omega
    gd[1:-1] = -(phi[2:] - phi[:-2]) / (2.0 * d_omega)
    gd -= peak_delay

    # moving average +-5 bins
    sw = 5
    csum = np.concatenate([[0.0], np.cumsum(gd)])
    k = np.arange(csize)
    lo = np.maximum(0, k - sw)
    hi = np.minimum(csize - 1, k + sw)
    gd = (csum[hi + 1] - csum[lo]) / (hi - lo + 1)

    mn = gd.min()
    if mn < 0.0:
        gd = gd + (-mn + 5.0)

    # one-pole smoothing alpha=0.45
    g = gd.tolist()
    o = g[0]
    for i in range(1, len(g)):
        o = 0.45 * g[i] + 0.55 * o
        g[i] = o
    gd = np.asarray(g, np.float64)

    # a bin past 2 x MAX_ALLOWED_GD (or non-finite) takes the last good one
    bad = ~np.isfinite(gd) | (np.abs(gd) > MAX_ALLOWED_GD * 2.0)
    bad[0] = False
    gd = _forward_fill(gd, ~bad)
    return np.clip(gd, 0.0, MAX_ALLOWED_GD)


def mixed_phase_allpass(linear_ir, minimum_ir, sample_rate,
                        transition_lo_hz=200.0, transition_hi_hz=700.0,
                        num_sections=20, freq_points=256, generations=160,
                        population=64, seed=0x434F4E564F4251,
                        max_mag_err_db=1.5):
    """Primary mixed-phase path (convertToMixedPhaseAllpass).  1-D inputs.

    Returns the mixed IR, or None when the design fails OR the result
    misses the magnitude-fidelity gate (90th-percentile |error| vs the
    linear IR over significant bins > max_mag_err_db) — callers fall back
    to `mixed_phase_fallback` (MixedPhase.cpp:37-62).  The gate catches
    the truncation case: the allpass adds up to MAX_ALLOWED_GD samples of
    group delay, and when the IR's tail still carries energy at its end,
    the delayed energy falls off the IR and distorts the magnitude.
    """
    x = np.asarray(linear_ir, np.float64)
    m = np.asarray(minimum_ir, np.float64)
    n = x.shape[-1]
    fft_size = next_pow2(n * 4)
    if fft_size > MAX_PHASE_FFT_SIZE:
        return None
    half = fft_size // 2
    csize = half + 1

    peak_delay = int(np.argmax(np.abs(x)))
    ls = np.fft.fft(np.concatenate([x, np.zeros(fft_size - n)]))
    ms = np.fft.fft(np.concatenate([m, np.zeros(fft_size - n)]))

    phi_min = unwrap_phase_delta(np.arctan2(ms[:csize].imag, ms[:csize].real))
    k = np.arange(csize)
    freq = k * sample_rate / fft_size
    w_min = _blend_weight(freq, transition_lo_hz, transition_hi_hz)
    w_lin = 1.0 - w_min
    omega = 2.0 * np.pi * k / fft_size
    phi_lin = -omega * peak_delay
    phi_target = w_lin * phi_lin + w_min * phi_min
    mag = np.abs(ls[:csize])
    # low-magnitude bins inherit the previous target (MixedPhase.cpp:315-323)
    phi_target = _forward_fill(phi_target, ~(mag < 1e-10), first=0.0)

    gd = _target_group_delay(phi_target, peak_delay, fft_size, csize)

    # log-spaced optimization grid (MixedPhase.cpp:460-475)
    log_min, log_max = np.log(20.0), np.log(sample_rate / 2.0)
    fi = np.exp(log_min + (log_max - log_min)
                * np.arange(freq_points) / (freq_points - 1))
    k_real = fi * fft_size / sample_rate
    k0 = np.clip(k_real.astype(int), 0, csize - 1)
    k1 = np.minimum(k0 + 1, csize - 1)
    t = k_real - np.floor(k_real)
    target = (1.0 - t) * gd[k0] + t * gd[k1]

    cfg = DesignerConfig(num_sections=num_sections, freq_points=freq_points,
                         min_freq_hz=20.0, max_freq_hz=sample_rate / 2.0,
                         cmaes_max_generations=generations,
                         cmaes_population=population,
                         cmaes_initial_sigma=1.0, cmaes_seed=seed)
    cfg.cmaes_params.sigma_min = 0.002
    cfg.cmaes_params.sigma_max = 2.0
    sections, cost = design_cmaes(sample_rate, fi, target, cfg)
    # The reference exposes both designers (AllpassDesigner.h:52
    # OptimizationMethod{GreedyAdaGrad,CMAES}); the deterministic greedy
    # path frequently beats CMA-ES on steep GD targets (measured 3.6x
    # lower squared GD error on the ref-harness cmaes fixture), so run
    # it too and keep the better design.
    g_sections, g_cost = design_greedy_adagrad(sample_rate, fi, target, cfg)
    if g_sections is not None:
        om = 2.0 * np.pi * fi / sample_rate
        def _sq(secs):
            tau = sections_group_delay([s.rho for s in secs],
                                       [s.theta for s in secs], om)
            return float(np.sum((tau - target) ** 2))
        if sections is None or _sq(g_sections) < _sq(sections):
            sections = g_sections
    if sections is None:
        return None

    ap = compute_response(sections, sample_rate, freq)
    full = np.empty(fft_size, complex)
    full[:csize] = ap
    full[csize:] = np.conj(ap[1:half][::-1])
    y = np.fft.ifft(ls * full).real[:n]
    y = np.where(np.abs(y) < 1e-18, 0.0, y)

    # RMS renormalization to the linear IR (MixedPhase.cpp:585-605)
    rms_lin = np.sqrt(np.mean(x * x))
    rms_mix = np.sqrt(np.mean(y * y))
    if rms_mix > 1e-12 and rms_lin > 1e-12:
        y = y * (rms_lin / rms_mix)
    if not np.all(np.isfinite(y)):
        return None

    # Fidelity gate: an allpass is magnitude-transparent in theory, but
    # truncating the delayed IR back to n samples is not.  Reject designs
    # whose 90th-percentile magnitude error (over bins carrying signal)
    # exceeds max_mag_err_db so the caller routes to the exact spectral
    # blend instead of shipping a magnitude-distorted IR.
    Hl = np.abs(np.fft.rfft(x, fft_size))
    Hx = np.abs(np.fft.rfft(y, fft_size))
    sig = Hl > np.max(Hl) * 1e-4          # ignore deep-null bins (-80 dB)
    if np.any(sig):
        err_db = 20.0 * np.log10(np.maximum(Hx[sig], 1e-300)
                                 / np.maximum(Hl[sig], 1e-300))
        if np.percentile(np.abs(err_db), 90) > max_mag_err_db:
            return None
    return y
