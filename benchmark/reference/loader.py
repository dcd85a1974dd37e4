"""Plain copies of the application's host set-up before the staged chain,
host NumPy in f64: the loader's trim and energy scale, the IR's
frequency-response peak, and the AutoGainPlanner's plan for EQ -> convolver
with the EQ's gain estimates that feed it.  Copied from the reference
C++ sources' formulas (LoaderThread.cpp:619-641, IRConverter.cpp:17-38
and :173-196, IRAnalyzer.cpp:62-155, AutoGainPlanner.{h,cpp},
EQResponseSampler / PeakEstimator / UpperBoundEstimator); they never
import the program.

One load of one IR: the loader's current-IR jump protection
(IRConverter.cpp:124-168) needs a previous IR and never acts on a first
load, so it is left out.  The planner computes in float32, as ConvoPeq
does, so its clamps agree to the bit.
"""
from __future__ import annotations

import numpy as np

from . import coeffs as C

ENERGY_MARGIN = 10.0 ** (-6.0 / 20.0)     # -6 dB (IRConverter.cpp:36)
PEAK_CEILING, RMS_CEILING, FREQ_CEILING = 0.5, 0.25, 1.41
ANALYSIS_WINDOW = 65536                   # IRAnalyzer.h kMaxAnalysisWindow
TUKEY_ALPHA = 0.5
EQ_GRID_POINTS = 2048


def trim(ir: np.ndarray, sample_rate: float, target_len: int) -> np.ndarray:
    """The IR cut or zero-padded to target_len, its last 2% (256 samples
    to 80 ms) faded linearly from 1 towards 0."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    n = min(target_len, ir.shape[-1])
    out = np.zeros((ir.shape[0], target_len))
    out[:, :n] = ir[:, :n]
    longest = max(256, int(round(0.080 * sample_rate)))
    fade = min(max(int(round(0.02 * n)), 256), longest)
    fade = max(0, min(fade, n - 1))
    if fade:
        out[:, n - fade:n] *= 1.0 - np.arange(fade) / fade
    return out


def tukey(n: int) -> np.ndarray:
    """The n-point Tukey window of alpha 0.5: raised-cosine tapers over
    the first and last alpha (n - 1) / 2 samples."""
    t = np.arange(n, dtype=np.float64)
    width = TUKEY_ALPHA * (n - 1)
    edge = width * 0.5
    w = np.ones(n)
    head, tail = t < edge, t > (n - 1) - edge
    w[head] = 0.5 * (1.0 + np.cos(2.0 * np.pi * t[head] / width - np.pi))
    w[tail] = 0.5 * (1.0 + np.cos(2.0 * np.pi * (t[tail] - (n - 1 - edge))
                                  / width))
    return w


def max_frequency_gain(ir: np.ndarray) -> float:
    """The largest |H| of any channel over its first <= 65,536 samples,
    Tukey-windowed on a power-of-two grid, each local maximum refined by
    the 3-point log-Gaussian step, over the window's mean."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    n = min(ir.shape[-1], ANALYSIS_WINDOW)
    m = C.next_pow2(n)
    if n <= 0 or m < 2:
        return 1.0
    w = tukey(m)[:n]
    mean = w.sum() / n
    if mean < 1e-18:
        return 1.0
    best = 0.0
    for row in ir:
        mag = np.abs(np.fft.rfft(row[:n] * w, m))
        best = max(best, float(mag.max()))
        a, b, c = mag[:-2], mag[1:-1], mag[2:]
        peak = (b > a) & (b > c) & (np.minimum(np.minimum(a, b), c) > 1e-18)
        if not peak.any():
            continue
        la, lb, lc = (np.log(v[peak]) for v in (a, b, c))
        den = la - 2.0 * lb + lc
        ok = np.abs(den) > 1e-18
        if ok.any():
            d = 0.5 * (la[ok] - lc[ok]) / den[ok]
            best = max(best, float((b[peak][ok]
                                    * np.exp(-d * (lb[ok] - la[ok]))).max()))
    best /= mean
    return best if best > 1e-18 else 1.0


def ir_scale(ir: np.ndarray) -> float:
    """The loader's scale of a first load: 1 / sqrt(the largest channel
    energy) less 6 dB, then lowered until the peak is at most 0.5, the
    RMS (over all channels) at most 0.25 and the frequency-response peak
    at most 1.41."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    e = [float(row @ row) for row in ir]
    e = max([v for v in e if np.isfinite(v) and v > 1e-18], default=0.0)
    if e <= 1e-18:
        return 1.0
    scale = ENERGY_MARGIN / np.sqrt(e)
    peak = float(np.abs(ir).max())
    rms = float(np.sqrt(np.mean(ir * ir)))
    if peak * scale > PEAK_CEILING:
        scale *= PEAK_CEILING / (peak * scale)
    if rms * scale > RMS_CEILING:
        scale *= RMS_CEILING / (rms * scale)
    f = max_frequency_gain(ir * scale)
    if f > FREQ_CEILING:
        scale *= FREQ_CEILING / f
    return float(scale)


def prepare_ir(ir: np.ndarray, sample_rate: float, target_seconds: float):
    """(the prepared IR (C, L): trimmed, times its scale; its
    frequency-response peak in dB, which the gain plan reads)."""
    t = trim(ir, sample_rate, int(round(target_seconds * sample_rate)))
    prepared = t * ir_scale(t)
    return prepared, float(20.0 * np.log10(max(max_frequency_gain(prepared),
                                               1e-18)))


# ---------------------------------------------------------- the gain plan

def _log_grid(sr: float) -> np.ndarray:
    top = min(40000.0, sr * 0.5 * 0.999)
    return np.exp(np.linspace(np.log(10.0), np.log(top), EQ_GRID_POINTS))


def eq_peak_db(eq: dict, sr: float) -> float:
    """The measured peak of the bands' serial response in dB, on a
    2,048-point log grid from 10 Hz, refined by a parabola through the
    largest point and its neighbours; at least 0."""
    f = _log_grid(sr)
    db = 20.0 * np.log10(np.maximum(np.abs(C.eq_response(eq, sr, f)),
                                    1e-12))
    i = int(np.argmax(db))
    best = db[i]
    if 0 < i < db.size - 1:
        lo, mid, hi = db[i - 1], db[i], db[i + 1]
        den = lo - 2.0 * mid + hi
        if abs(den) > 1e-12:
            best = mid - 0.25 * (lo - hi) * (0.5 * (lo - hi) / den)
    return float(max(best, 0.0))


def eq_upper_bound_db(eq: dict, sr: float) -> float:
    """A safe upper bound of the bands' gain in dB: the grid's largest
    sum of log1p |H_b - 1| over the bands (each term over 1e-6)."""
    f = _log_grid(sr)
    z = np.exp(2j * np.pi * f / sr)
    c = C.svf_coeffs(eq["band_types"], eq["freqs"], eq["gains_db"],
                     eq["qs"], sr)
    total = np.zeros(f.size)
    for b in np.flatnonzero(C.band_active(eq)):
        b0, b1, b2, a0, a1, a2 = C._svf_biquad(*(float(v[b]) for v in c))
        den = a0 * z * z + a1 * z + a2
        ok = np.abs(den) > 1e-18
        H = np.where(ok, (b0 * z * z + b1 * z + b2)
                     / np.where(ok, den, 1.0), 0.0)
        d = np.abs(H - 1.0)
        use = np.isfinite(d) & (d > 1e-6)
        total += np.where(use, np.log1p(np.where(use, d, 0.0)), 0.0)
    return float(np.max(20.0 / np.log(10.0) * total)) \
        if C.band_active(eq).any() else 0.0


def eq_max_q(eq: dict) -> float:
    """The largest Q of the active bands that boost (or pass-filter)."""
    t = np.asarray(eq["band_types"])
    use = C.band_active(eq) & ((np.asarray(eq["gains_db"]) > 0.0)
                               | (t == C.LOW_PASS) | (t == C.HIGH_PASS))
    return float(np.max(np.asarray(eq["qs"], np.float64)[use],
                        initial=0.0))


def auto_gain_eq_conv(eq: dict, sr: float, ir_peak_db: float):
    """The plan's (input headroom, makeup, convolver trim) linear gains
    for EQ -> convolver, both active (AutoGainPlanner.cpp:15-110): the
    EQ's gain the larger of its measured peak and its upper bound, the
    input down by its boost over 1.5 dB and the empirical margin, the
    trim by the IR's peak over 1 dB, the makeup their sum back to 0 dB."""
    f32 = np.float32
    eq_db = f32(max(eq_peak_db(eq, sr), eq_upper_bound_db(eq, sr)))
    q = f32(eq_max_q(eq))
    margin = f32(0.0)
    if eq_db > f32(0.5):
        margin = np.minimum(f32(2.5), np.maximum(f32(0.0), f32(0.8)
                            + np.maximum(f32(0.0),
                                         (q - f32(0.707)) * f32(0.12))
                            + eq_db * f32(0.04)))
    eq_boost = np.maximum(f32(0.0), eq_db)
    ir_boost = np.maximum(f32(0.0), f32(ir_peak_db))
    g_in = np.clip(-np.maximum(f32(0.0), eq_boost - f32(1.5)) - margin,
                   f32(-18.0), f32(0.0))
    g_trim = np.clip(-np.maximum(f32(0.0), ir_boost - f32(1.0)),
                     f32(-12.0), f32(0.0))
    g_makeup = np.clip(-g_in - g_trim, f32(0.0), f32(12.0))
    return tuple(float(10.0 ** (float(g) / 20.0))
                 for g in (g_in, g_makeup, g_trim))
