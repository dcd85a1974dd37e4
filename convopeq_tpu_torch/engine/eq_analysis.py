"""EQ response analysis, which feeds the AutoGainPlanner's eqMaxGainDb
and eqMaxQ (counterpart of convopeq_tpu/engine/eq_analysis.py;
src/eqprocessor/{EQResponseSampler,PeakEstimator,UpperBoundEstimator}.cpp,
EQProcessor.Coefficients.cpp:330-400).  Host NumPy f64.

The composite magnitude response of the active bands (the product in
serial mode, 1 + the sum of (H - 1) in parallel) is sampled on a dense
log grid and its maximum refined by 3-point parabolic (log-domain)
interpolation, the estimate the reference's coarse + adaptive sampler
converges to.  svf_to_biquad: exact transcription of svfToDisplayBiquad
(EQProcessor.Coefficients.cpp:404-425).
"""
from __future__ import annotations

import numpy as np

from ..models.eq import SERIAL, EQParams, band_active_mask
from ..ops.svf import HIGH_PASS, LOW_PASS, svf_coeffs


def svf_to_biquad(a1, a2, a3, m0, m1, m2):
    """(b0,b1,b2,a0,a1,a2) in RBJ ordering, unnormalized."""
    if a1 < 1e-15:
        return (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    g2 = a3 / a1
    g = a2 / a1
    gk = (1.0 - a1 - a3) / a1
    A0 = 1.0 + gk + g2
    A1 = -2.0 + 2.0 * g2
    A2 = 1.0 - gk + g2
    b0 = m0 * (1.0 + gk + g2) + m1 * g + m2 * g2
    b1 = -2.0 * m0 + 2.0 * (m0 + m2) * g2
    b2 = m0 * (1.0 - gk + g2) - m1 * g + m2 * g2
    return (b0, b1, b2, A0, A1, A2)


def biquad_response(coeffs, freqs, sample_rate):
    """Complex response of an (unnormalized) biquad at freqs (Hz)."""
    b0, b1, b2, a0, a1, a2 = coeffs
    z = np.exp(1j * 2.0 * np.pi * np.asarray(freqs) / sample_rate)
    z2 = z * z
    num = b0 * z2 + b1 * z + b2
    den = a0 * z2 + a1 * z + a2
    return np.where(np.abs(den) > 1e-18,
                    num / np.where(np.abs(den) > 1e-18, den, 1.0), 0.0)


def eq_response(params: EQParams, sample_rate: float, freqs) -> np.ndarray:
    """Composite complex response of the active bands at `freqs`."""
    active = band_active_mask(params)
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    freqs = np.asarray(freqs, np.float64)
    if params.structure == SERIAL:
        h = np.ones(len(freqs), complex)
        for b in range(len(active)):
            if not active[b]:
                continue
            bq = svf_to_biquad(*(float(c[b]) for c in coeffs))
            h = h * biquad_response(bq, freqs, sample_rate)
    else:
        h = np.ones(len(freqs), complex)
        acc = np.zeros(len(freqs), complex)
        for b in range(len(active)):
            if not active[b]:
                continue
            bq = svf_to_biquad(*(float(c[b]) for c in coeffs))
            acc = acc + (biquad_response(bq, freqs, sample_rate) - 1.0)
        h = h + acc
    return h


def estimate_max_gain_db(params: EQParams, processing_rate: float,
                         grid_points: int = 2048) -> float:
    """Max composite gain in dB (measured estimate with parabolic refine)."""
    active = band_active_mask(params)
    if not np.any(active):
        return 0.0
    fmax = min(20000.0 * 2.0, processing_rate * 0.5 * 0.999)
    freqs = np.exp(np.linspace(np.log(10.0), np.log(fmax), grid_points))
    mag_db = 20.0 * np.log10(np.maximum(np.abs(
        eq_response(params, processing_rate, freqs)), 1e-12))
    i = int(np.argmax(mag_db))
    best = mag_db[i]
    if 0 < i < len(mag_db) - 1:
        ym1, y0, yp1 = mag_db[i - 1], mag_db[i], mag_db[i + 1]
        denom = ym1 - 2.0 * y0 + yp1
        if abs(denom) > 1e-12:
            delta = 0.5 * (ym1 - yp1) / denom
            best = y0 - 0.25 * (ym1 - yp1) * delta
    return float(max(best, 0.0))


def estimate_upper_bound_db(params: EQParams, processing_rate: float,
                            grid_points: int = 2048):
    """Safe-side upper bound of the composite gain
    (EQAnalysisMath::computeSampleResponse, h:42-80 + UpperBoundEstimator):
    at each frequency, (20/ln10) * sum_i log1p(|H_i - 1|) over bands with
    |H-1| > 1e-6 — an upper bound on |prod H_i| (serial) and |1 + sum
    (H_i - 1)| (parallel) alike; the estimator takes the grid max with no
    interpolation.  Returns (max_db, freq_hz)."""
    active = band_active_mask(params)
    if not np.any(active):
        return 0.0, 0.0
    fmax = min(20000.0 * 2.0, processing_rate * 0.5 * 0.999)
    freqs = np.exp(np.linspace(np.log(10.0), np.log(fmax), grid_points))
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, processing_rate)
    log_bound = np.zeros(len(freqs))
    for b in range(len(active)):
        if not active[b]:
            continue
        bq = svf_to_biquad(*(float(c[b]) for c in coeffs))
        delta = np.abs(biquad_response(bq, freqs, processing_rate) - 1.0)
        use = np.isfinite(delta) & (delta > 1e-6)
        log_bound += np.where(use, np.log1p(np.where(use, delta, 0.0)), 0.0)
    ub_db = (20.0 / np.log(10.0)) * log_bound
    i = int(np.argmax(ub_db))
    return float(ub_db[i]), float(freqs[i])


def estimate_planner_gain_db(params: EQParams, processing_rate: float) -> float:
    """eqMaxGainDb as the planner receives it: max(measured, upperBound)
    (AudioEngine.RebuildDispatch.cpp:694 'Builder collapse')."""
    measured = estimate_max_gain_db(params, processing_rate)
    upper, _ = estimate_upper_bound_db(params, processing_rate)
    return max(measured, upper)


def max_active_q(params: EQParams) -> float:
    """maxActiveQ over boosted active bands (BandHelper::collectActiveBands)."""
    active = band_active_mask(params)
    q = 0.0
    for b in range(len(active)):
        if active[b] and (params.gains_db[b] > 0.0
                          or params.band_types[b] in (LOW_PASS, HIGH_PASS)):
            q = max(q, float(params.qs[b]))
    return q
