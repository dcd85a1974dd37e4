"""IR analysis (counterpart of convopeq_tpu/ir/analyzer.py;
src/IRAnalyzer.{h,cpp}).  Host NumPy f64.

estimateMaxFrequencyResponseGain (IRAnalyzer.cpp:62-155): a Tukey
(alpha = 0.5) window over the first <= 65,536 samples, a power-of-two
FFT, the largest magnitude over the bins with 3-point log-Gaussian peak
interpolation, divided by the window's coherent gain (its mean over the
analyzed span).  Feeds the AutoGainPlanner's irFreqPeakGainDb.
`analyze_ir` gives the IRFinalAnalysis metrics (IRAnalyzer.h:19-50).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.dsputil import next_pow2

K_MAX_ANALYSIS_WINDOW = 65536   # IRAnalyzer.h (kMaxAnalysisWindow)
K_TUKEY_ALPHA = 0.5


def tukey_window(n: int, alpha: float = K_TUKEY_ALPHA) -> np.ndarray:
    """Tukey window as built in IRAnalyzer.cpp:76-95 (length = fftSize)."""
    taper = alpha * (n - 1) * 0.5
    t = np.arange(n, dtype=np.float64)
    w = np.ones(n)
    head = t < taper
    w[head] = 0.5 * (1.0 + np.cos(2.0 * np.pi * t[head] / (alpha * (n - 1))
                                  - np.pi))
    tail = t > (n - 1) - taper
    w[tail] = 0.5 * (1.0 + np.cos(2.0 * np.pi
                                  * (t[tail] - ((n - 1) - taper))
                                  / (alpha * (n - 1))))
    return w


def estimate_max_frequency_gain(ir: np.ndarray) -> float:
    """estimateMaxFrequencyResponseGain — linear peak |H| (>= channels max)."""
    ir = np.asarray(ir, np.float64)
    if ir.ndim == 1:
        ir = ir[None, :]
    n = ir.shape[-1]
    if n <= 0:
        return 1.0
    copy_len = min(n, K_MAX_ANALYSIS_WINDOW)
    fft_size = next_pow2(copy_len)
    if fft_size < 2:
        return 1.0
    w = tukey_window(fft_size)
    window_mean = w[:copy_len].sum() / copy_len
    if window_mean < 1e-18:
        return 1.0

    max_mag = 0.0
    for ch in range(ir.shape[0]):
        x = np.zeros(fft_size)
        x[:copy_len] = ir[ch, :copy_len] * w[:copy_len]
        spec = np.fft.rfft(x)
        mags = np.abs(spec)
        max_mag = max(max_mag, float(mags.max()))
        # 3-point log-Gaussian interpolation (IRAnalyzer.cpp:126-149)
        for b in range(1, len(mags) - 1):
            ym1, y0, yp1 = mags[b - 1], mags[b], mags[b + 1]
            if y0 > ym1 and y0 > yp1 and min(y0, ym1, yp1) > 1e-18:
                lm1, l0, lp1 = np.log(ym1), np.log(y0), np.log(yp1)
                denom = lm1 - 2.0 * l0 + lp1
                if abs(denom) > 1e-18:
                    delta = 0.5 * (lm1 - lp1) / denom
                    max_mag = max(max_mag,
                                  float(y0 * np.exp(-delta * (l0 - lm1))))
    max_mag /= window_mean
    return max_mag if max_mag > 1e-18 else 1.0


def ir_peak_gain_db(ir: np.ndarray) -> float:
    """irFreqPeakGainDb for the AutoGainPlanner input."""
    return float(20.0 * np.log10(max(estimate_max_frequency_gain(ir), 1e-18)))


@dataclass
class IRFinalAnalysis:
    """IRFinalAnalysis metrics (IRAnalyzer.h:19-50)."""
    peak: float
    peak_db: float
    rms: float
    rms_db: float
    l1_norm: float
    l1_db: float
    freq_peak_gain: float
    freq_peak_gain_db: float


def analyze_ir(ir: np.ndarray) -> IRFinalAnalysis:
    """Peak, RMS, the largest channel's L1 norm and the frequency-response
    peak of `ir` ((N,) or (C, N)), each also in dB (floor 1e-18)."""
    ir = np.asarray(ir, np.float64)

    def db(v):
        return float(20.0 * np.log10(max(v, 1e-18)))
    peak = float(np.abs(ir).max()) if ir.size else 0.0
    rms = float(np.sqrt(np.mean(ir * ir))) if ir.size else 0.0
    l1 = float(np.abs(ir).sum(axis=-1).max()) if ir.size else 0.0
    fp = estimate_max_frequency_gain(ir)
    return IRFinalAnalysis(peak=peak, peak_db=db(peak), rms=rms, rms_db=db(rms),
                           l1_norm=l1, l1_db=db(l1), freq_peak_gain=fp,
                           freq_peak_gain_db=db(fp))
