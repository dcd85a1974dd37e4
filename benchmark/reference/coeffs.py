"""Frozen copies of ConvoPeq's coefficient formulas, host NumPy in f64.

The reference recomputes every response the program bakes into its
folded IR from the configuration alone, with these copies: the NUC's
layer plan and its contour gains (SetImpulse), the HC/LC spectrum curve,
the two-stage DC blocker, the output filter's RBJ biquads, the 20-band
EQ's TPT-SVF coefficients and their biquad responses, the local 2x soft
clip's halfband and its Pade tanh.  They are copied from the reference
C++ sources' formulas (MKLNonUniformConvolver.cpp, OutputFilter.cpp,
EQProcessor.Coefficients.cpp, UltraHighRateDCBlocker.h,
AudioEngine.Processing.DSPCoreDouble.cpp) and never import the program.
"""
from __future__ import annotations

import numpy as np

K_OUTPUT_HEADROOM = 0.8912509381337456      # -1 dBFS (DSPCoreDouble.cpp:581)
CONVOLUTION_HEADROOM_GAIN = 1.0             # ConvolverProcessor.h:209
NUM_BANDS = 20
DEFAULT_FREQS = np.array([
    25.0, 40.0, 63.0, 100.0, 160.0, 250.0, 400.0, 630.0, 1000.0, 1600.0,
    2500.0, 4000.0, 6300.0, 10000.0, 11000.0, 12500.0, 14000.0, 16500.0,
    18000.0, 19500.0])
DEFAULT_Q = 0.707
LOW_SHELF, PEAKING, HIGH_SHELF, LOW_PASS, HIGH_PASS = range(5)
HC_SHARP, HC_NATURAL, HC_SOFT = 0, 1, 2
LC_NATURAL, LC_SOFT = 0, 1
TAIL_AIR_ABSORPTION, TAIL_CONTOUR, TAIL_BYPASS = 0, 1, 2
IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0)


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def equal_power_sin(x: float) -> float:
    """equalPowerSin: the 9th-order Taylor sine of x pi / 2."""
    t = x * (np.pi * 0.5)
    t2 = t * t
    return float(t * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 + t2 * (
        -1.0 / 5040.0 + t2 * (1.0 / 362880.0))))))


# ------------------------------------------------------------ NUC plan

def layer_gains(ir_len: int, block_size: int, spec: dict):
    """[(offset, length, gain)] of SetImpulse's three layers
    (MKLNonUniformConvolver.cpp:624-768) for a FilterSpec given as a
    dict (tail_mode, tail_enabled, tail_start_seconds, tail_strength,
    tail_l1l2_multiplier, sample_rate)."""
    tail_mode = int(np.clip(spec.get("tail_mode", TAIL_CONTOUR), 0, 2))
    tail_enabled = tail_mode != TAIL_BYPASS and spec.get("tail_enabled", True)
    sr = spec["sample_rate"]
    tail_start = float(np.clip(spec.get("tail_start_seconds", 0.085),
                               0.01, 0.80))
    user = float(np.clip(spec.get("tail_strength", 1.0), 0.0, 2.0))
    mult = int(np.clip(spec.get("tail_l1l2_multiplier", 8), 2, 16))
    s01 = min(max(user * 0.5, 0.0), 1.0)
    if not tail_enabled:
        g1 = g2 = 0.0
    elif tail_mode == TAIL_AIR_ABSORPTION:
        raise ValueError("air absorption damps each tail layer: it does "
                         "not fold, so no folded configuration has it")
    elif tail_mode == TAIL_CONTOUR:
        tail_start = float(np.clip(max(tail_start, 0.12), 0.01, 0.80))
        strength = float(np.clip(max(user, 1.25), 0.0, 2.0))
        mult = int(np.clip(max(mult, 8), 2, 16))
        g1 = float(np.clip(strength * (1.05 + 0.20 * s01), 0.0, 2.0))
        g2 = float(np.clip(strength * (0.82 + 0.12 * s01), 0.0, 2.0))
    else:
        g1 = g2 = 0.0
    p0 = next_pow2(max(block_size, 64))
    p1 = p0 * mult
    l0_target = int(np.clip(int(round(tail_start * sr)), p0, 32 * p0))
    l0 = min(ir_len, l0_target if tail_enabled else 32 * p0)
    l1 = max(0, min(ir_len - l0, 64 * p1)) if tail_enabled else 0
    l2 = max(0, ir_len - l0 - l1) if tail_enabled else 0
    return [(o, n, g) for o, n, g in ((0, l0, 1.0), (l0, l1, g1),
                                      (l0 + l1, l2, g2)) if n > 0]


def spectrum_filter_gain(fft_size: int, spec: dict) -> np.ndarray:
    """The HC/LC gain curve (applySpectrumFilter, cpp:336-440)."""
    fs = spec["sample_rate"]
    hc_mode = spec.get("hc_mode", HC_NATURAL)
    lc_mode = spec.get("lc_mode", LC_NATURAL)
    n = fft_size
    half = n // 2
    k = np.arange(half + 1)
    gain = np.ones(half + 1)
    hc_start = 18000.0 if fs <= 48000.0 else 22000.0
    k_start = int(round(hc_start * n / fs))
    k_end = min(half, int(round(fs * 0.5 * n / fs)))
    in_roll = (k > k_start) & (k <= k_end)
    x = (k - k_start) / max(1, (k_end - k_start))
    if hc_mode == HC_SHARP:
        roll = 1.0 / np.sqrt(1.0 + np.power(x, 8.0))
    elif hc_mode == HC_NATURAL:
        roll = 0.5 * (1.0 + np.cos(np.pi * x))
    else:
        roll = np.exp(-4.60517 * x * x)
    gain = np.where(in_roll, roll, gain)
    lc_end = 6.0 if lc_mode == LC_SOFT else 8.0
    lc_start = 15.0 if lc_mode == LC_SOFT else 18.0
    k_lc_end = int(round(lc_end * n / fs))
    k_lc_start = int(round(lc_start * n / fs))
    gain = np.where(k <= k_lc_end, 0.0, gain)
    ramp = (k > k_lc_end) & (k < k_lc_start)
    xr = (k - k_lc_end) / max(1, k_lc_start - k_lc_end)
    return np.where(ramp, gain * 0.5 * (1.0 - np.cos(np.pi * xr)), gain)


# ------------------------------------------------- DC blocker, biquads

def dc_blocker_alphas(sample_rate: float, cutoff_hz: float):
    """UltraHighRateDCBlocker init (:78-115): two one-pole sections at
    the cutoff -+ 10%."""
    out = []
    for ratio in (0.9, 1.1):
        a = -np.expm1(-2.0 * np.pi * cutoff_hz * ratio / sample_rate)
        out.append(float(a) if np.isfinite(a) and 0.0 < a < 1.0 else 1e-6)
    return out


def dc_blocker_response(z, sample_rate: float, cutoff_hz: float = 3.0):
    """H(z) of the two sections, y = x - s' with the updated state."""
    H = np.ones(z.shape, complex)
    for a in dc_blocker_alphas(sample_rate, cutoff_hz):
        H = H * (1.0 - a) * (z - 1.0) / (z - (1.0 - a))
    return H


def _rbj(kind: str, fc: float, q: float, fs: float):
    """makeLPF / makeHPF (OutputFilter.cpp:25-67), a0-normalized."""
    if fc >= fs * 0.4999 or q <= 0.0 or fs <= 0.0 or fc <= 0.0:
        return IDENTITY
    w0 = 2.0 * np.pi * fc / fs
    sn, cs = np.sin(w0), np.cos(w0)
    alpha = sn / (2.0 * q)
    a0inv = 1.0 / (1.0 + alpha)
    if kind == "lp":
        b = ((1.0 - cs) * 0.5, 1.0 - cs, (1.0 - cs) * 0.5)
    else:
        b = ((1.0 + cs) * 0.5, -(1.0 + cs), (1.0 + cs) * 0.5)
    return (b[0] * a0inv, b[1] * a0inv, b[2] * a0inv, -2.0 * cs * a0inv,
            (1.0 - alpha) * a0inv)


def output_filter_stages(fs: float, conv_is_last: bool, hc_mode: int,
                         lc_mode: int, lp_mode: int):
    """The three biquads of OutputFilter::prepare (cpp:79-125)."""
    fc_hc = 19000.0 if fs <= 48000.0 else 22000.0
    fc_lp = 19000.0 if fs <= 48000.0 else 24000.0
    if conv_is_last:
        qs = {HC_SHARP: (0.54120, 1.30656), HC_NATURAL: (0.70711, 0.70711),
              HC_SOFT: (0.5, None)}[hc_mode]
        hc = [_rbj("lp", fc_hc, q, fs) if q else IDENTITY for q in qs]
        lc = (_rbj("hp", 18.0, 0.70711, fs) if lc_mode == LC_NATURAL
              else _rbj("hp", 15.0, 0.5, fs))
        return hc + [lc]
    q = {HC_SHARP: 1.0, HC_NATURAL: 0.70711, HC_SOFT: 0.5}[lp_mode]
    return [_rbj("hp", 20.0, 0.70711, fs), _rbj("lp", fc_lp, q, fs),
            _rbj("lp", fc_lp, q, fs)]


def biquad_pole_radius(a1: float, a2: float) -> float:
    disc = a1 * a1 - 4.0 * a2
    if disc < 0.0:
        return float(np.sqrt(max(a2, 0.0)))
    s = np.sqrt(disc)
    return float(max(abs((-a1 + s) / 2.0), abs((-a1 - s) / 2.0)))


# ------------------------------------------------------------- the EQ

def _clamp_params(freq, gain_db, q, sr):
    """validateAndClampParameters: the parameter plane is float32."""
    f32 = np.float32
    max_f = np.minimum(f32(20000.0), f32(sr * 0.5) * f32(0.95))
    freq = np.clip(np.asarray(freq, f32), f32(20.0), max_f)
    q = np.clip(np.asarray(q, f32), f32(0.01), f32(20.0))
    gain_db = np.clip(np.asarray(gain_db, f32), f32(-48.0), f32(48.0))
    return (freq.astype(np.float64), gain_db.astype(np.float64),
            q.astype(np.float64))


def svf_coeffs(band_type, freq, gain_db, q, sr):
    """(a1, a2, a3, m0, m1, m2) of the TPT SVF of each band
    (EQProcessor.Coefficients.cpp:431-607)."""
    freq, gain_db, q = _clamp_params(freq, gain_db, q, sr)
    t = np.asarray(band_type)
    A = np.power(10.0, gain_db / 40.0)
    g0 = np.tan(np.pi * freq / sr)
    g = np.where(t == LOW_SHELF, g0 / np.sqrt(A),
                 np.where(t == HIGH_SHELF, g0 * np.sqrt(A), g0))
    k = np.where(t == PEAKING, 1.0 / (q * A), 1.0 / q)
    den = 1.0 + g * (g + k)
    a1 = 1.0 / den
    a2 = g * a1
    a3 = g * a2
    m0 = np.where(t == LOW_PASS, 0.0, np.where(t == HIGH_SHELF, A * A, 1.0))
    m1 = np.select([t == LOW_SHELF, t == PEAKING, t == HIGH_SHELF,
                    t == HIGH_PASS],
                   [k * (A - 1.0), (A - 1.0 / A) / q, k * (1.0 - A) * A, -k],
                   0.0)
    m2 = np.select([t == LOW_SHELF, t == HIGH_SHELF, t == LOW_PASS,
                    t == HIGH_PASS], [A * A - 1.0, 1.0 - A * A, 1.0, -1.0],
                   0.0)
    bad = ~np.isfinite(g) | ~np.isfinite(k) | (np.abs(den) < 1e-15)
    return (np.where(bad, 1.0, a1), np.where(bad, 0.0, a2),
            np.where(bad, 0.0, a3), np.where(bad, 1.0, m0),
            np.where(bad, 0.0, m1), np.where(bad, 0.0, m2))


def band_active(eq: dict) -> np.ndarray:
    """createBandNode's rule: a shelf or peak under 0.01 dB (in f32) is
    skipped."""
    t = np.asarray(eq["band_types"])
    tiny = np.abs(np.asarray(eq["gains_db"], np.float32)) < np.float32(0.01)
    return (np.asarray(eq["enabled"], bool)
            & ~((t != LOW_PASS) & (t != HIGH_PASS) & tiny))


def _svf_biquad(a1, a2, a3, m0, m1, m2):
    """The SVF as an unnormalized biquad (b0, b1, b2, A0, A1, A2)."""
    if a1 < 1e-15:
        return (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    g2, g, gk = a3 / a1, a2 / a1, (1.0 - a1 - a3) / a1
    return (m0 * (1.0 + gk + g2) + m1 * g + m2 * g2,
            -2.0 * m0 + 2.0 * (m0 + m2) * g2,
            m0 * (1.0 - gk + g2) - m1 * g + m2 * g2,
            1.0 + gk + g2, -2.0 + 2.0 * g2, 1.0 - gk + g2)


def eq_response(eq: dict, sr: float, freqs) -> np.ndarray:
    """The serial cascade of the active bands at `freqs` (Hz); every
    band stereo, so one response serves both channels."""
    if any(int(m) != 0 for m, a in zip(eq["modes"], band_active(eq)) if a):
        raise ValueError("mid/side or one-channel bands do not fold")
    if eq.get("structure", 0) != 0:
        raise ValueError("only the serial structure is folded here")
    c = svf_coeffs(eq["band_types"], eq["freqs"], eq["gains_db"], eq["qs"],
                   sr)
    z = np.exp(1j * 2.0 * np.pi * np.asarray(freqs, np.float64) / sr)
    H = np.ones(z.shape, complex)
    for b in np.flatnonzero(band_active(eq)):
        b0, b1, b2, A0, A1, A2 = _svf_biquad(*(float(v[b]) for v in c))
        den = A0 * z * z + A1 * z + A2
        ok = np.abs(den) > 1e-18
        H = H * np.where(ok, (b0 * z * z + b1 * z + b2)
                         / np.where(ok, den, 1.0), 0.0)
    return H


def eq_ring_tail(eq: dict, sr: float, eps: float = 1e-10) -> int:
    """Samples until the slowest active band's ringing falls under eps."""
    c = svf_coeffs(eq["band_types"], eq["freqs"], eq["gains_db"], eq["qs"],
                   sr)
    r = 0.0
    for b in np.flatnonzero(band_active(eq)):
        A = np.array([[2 * c[0][b] - 1.0, -2 * c[1][b]],
                      [2 * c[1][b], 1.0 - 2 * c[2][b]]])
        r = max(r, min(float(np.max(np.abs(np.linalg.eigvals(A)))),
                       1.0 - 1e-12))
    return 0 if r <= 0.0 else int(np.ceil(np.log(eps) / np.log(r)))


def eq_params(gains_db) -> dict:
    """The default 20-band EQ (all peaking, stereo, serial) at `gains_db`."""
    return {"band_types": np.full(NUM_BANDS, PEAKING), "freqs":
            DEFAULT_FREQS.copy(), "gains_db": np.asarray(gains_db, float),
            "qs": np.full(NUM_BANDS, DEFAULT_Q),
            "modes": np.zeros(NUM_BANDS, int),
            "enabled": np.ones(NUM_BANDS, bool), "structure": 0}


# ------------------------------------------------------ soft clip parts

def soft_clip_params(saturation: float):
    """DSPCoreDouble.cpp:471-475: threshold, knee, asymmetry."""
    s = float(saturation)
    return 0.95 - 0.45 * s, 0.05 + 0.35 * s, 0.10 * s


def _bessel_i0(x):
    x = np.asarray(x, np.float64)
    s = np.ones_like(x)
    term = np.ones_like(x)
    for n in range(1, 100):
        term = term * x * x / (4.0 * n * n)
        s = s + term
        if np.all(term < s * 1e-18):
            break
    return s


def halfband_conv_taps(taps: int = 31, atten_db: float = 90.0) -> np.ndarray:
    """The non-zero arm of the Kaiser halfband of prepareStage
    (cpp:287-372): taps 31 at 90 dB give 16 coefficients, conv parity 0."""
    M = (taps - 1) // 2
    centre_parity = M & 1
    a = atten_db
    beta = (0.1102 * (a - 8.7) if a > 50.0 else
            0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0
            else 0.0)
    n = np.arange(taps)
    t = (n - M).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(t == 0.0, 0.5, np.sin(np.pi * 0.5 * t) / (np.pi * t))
    frac = t / M
    h = sinc * _bessel_i0(beta * np.sqrt(np.maximum(0.0, 1.0 - frac * frac))) \
        / float(_bessel_i0(beta))
    h = np.where((n != M) & ((n & 1) == centre_parity), 0.0, h)
    h = h / h.sum()
    h[M] = 0.5
    h = np.where(n != M, h * (0.5 / (h.sum() - h[M])), h)
    h[M] = 0.5
    if centre_parity != 1:
        raise ValueError("the local 2x clip's halfband has an odd centre")
    return h[0::2].copy()
