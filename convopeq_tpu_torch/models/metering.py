"""Metering: BS.1770 loudness, true peak and the spectrum analyzer
(counterpart of convopeq_tpu/models/metering.py).

- LoudnessMeter (src/LoudnessMeter.{h,cpp}): the K-weighting recomputed
  per sample rate from the analog prototypes (stage 1 an RBJ high shelf,
  1500 Hz, Q 1/sqrt 2, +4 dB; stage 2 the RLB high-pass, 38 Hz, Q 0.5;
  LoudnessMeter.cpp:142-217), run as two `biquad_df2t_scan`s on the
  signal's device (ops/scan_iir.py's routes: in f32 the RLB's double
  real pole at ~0.995 takes `diag`, two real one-poles; in f64 both take
  `2x2`); block mean-square power, momentary (400 ms), short-term (3 s)
  and gated integrated loudness.  Channel weights 1.0 (LoudnessMeter.h:
  15).  The sliding windows difference a cumulative sum, which the port
  accumulates in float64 whatever the signal's type: an f32 cumulative
  sum over 20 s would lose ~N / window x 2^-24 of each window's power.
- TruePeakDetector (src/TruePeakDetector.{h,cpp}): 4x oversampling as two
  2x halfband stages (63 and 31 taps, Kaiser, 100 dB), each arm the
  port's causal FIR (`ops/oversample._causal_fir`, banded-Toeplitz
  GEMMs), then max |.|.  Rows go in groups whose 4x signal stays under
  TRUE_PEAK_CHUNK_VALUES, so a 64-stream x 20 s call never holds the
  whole 4x signal; the rows are independent, so the result is the same.
- SpectrumAnalyzer (src/SpectrumAnalyzerComponent.h:66-95): 4096-point
  Hann-windowed frames with hop 1024 and magnitude scale 2/N, the peak
  hold over frames and the EMA smoothing (`one_pole_scan` over frames).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.oversample import _causal_fir, design_halfband
from ..ops.scan_iir import biquad_df2t_scan, one_pole_scan

LUFS_OFFSET = -0.691             # BS.1770-4 eq. 2
ABSOLUTE_GATE_LUFS = -70.0
RELATIVE_GATE_LU = -10.0
MOMENTARY_SEC = 0.4
SHORT_TERM_SEC = 3.0
# values of the 4x signal a true-peak row group may hold (f32: 256 MB)
TRUE_PEAK_CHUNK_VALUES = 1 << 26


def k_weighting_coeffs(sample_rate: float):
    """Exact transcription of updateCoefficients (LoudnessMeter.cpp:154-217).

    Returns (pre, rlb), each (b0, b1, b2, a1, a2) normalized to a0 = 1
    (host float64)."""
    fs = sample_rate
    # Stage 2: RLB HPF 38 Hz Q=0.5
    w0 = 2.0 * np.pi * 38.0 / fs
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * 0.50)
    a0 = 1.0 + alpha
    rlb = ((1.0 + cw) / 2.0 / a0, -(1.0 + cw) / a0, (1.0 + cw) / 2.0 / a0,
           -2.0 * cw / a0, (1.0 - alpha) / a0)

    # Stage 1: high-shelf 1500 Hz, Q=1/sqrt2, +4 dB
    w0 = 2.0 * np.pi * 1500.0 / fs
    cw, sw = np.cos(w0), np.sin(w0)
    A = 10.0 ** (4.0 / 40.0)
    alpha = sw / (2.0 * 0.7071067811865476)
    sqrtA = np.sqrt(A)
    b0 = A * ((A + 1.0) + (A - 1.0) * cw + 2.0 * sqrtA * alpha)
    b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cw)
    b2 = A * ((A + 1.0) + (A - 1.0) * cw - 2.0 * sqrtA * alpha)
    a0 = (A + 1.0) - (A - 1.0) * cw + 2.0 * sqrtA * alpha
    a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cw)
    a2 = (A + 1.0) - (A - 1.0) * cw - 2.0 * sqrtA * alpha
    pre = (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)
    return pre, rlb


def k_weight(x, sample_rate: float):
    """The 2-stage K-weighting filter along the last axis of x."""
    pre, rlb = k_weighting_coeffs(sample_rate)
    y, _ = biquad_df2t_scan(x, *pre)
    y, _ = biquad_df2t_scan(y, *rlb)
    return y


def block_power(x, block_size: int):
    """Mean-square power per non-overlapping block, channels weighted 1.0:
    x (..., C, N) -> (..., nb)."""
    n = x.shape[-1]
    nb = n // block_size
    b = x[..., :nb * block_size].reshape(x.shape[:-1] + (nb, block_size))
    return (b * b).mean(dim=-1).sum(dim=-2)


def _windowed_power(z, sample_rate, window_sec, hop_sec=0.1):
    """Mean square over sliding windows (hop 100 ms per BS.1770), summed
    over the channels (axis -2) when z has one; in z's dtype.  The
    cumulative sum runs in float64 (see the module docstring)."""
    win = int(round(window_sec * sample_rate))
    hop = int(round(hop_sec * sample_rate))
    n = z.shape[-1]
    if n < win:
        # shorter-than-window signals: single gate block over what exists
        win = n
        hop = max(1, n)
    nwin = (n - win) // hop + 1
    idx = torch.arange(nwin, device=z.device) * hop
    e2 = (z * z).sum(dim=-2) if z.dim() >= 2 else z * z
    csum = F.pad(torch.cumsum(e2.to(torch.float64), dim=-1), (1, 0))
    return ((csum[..., idx + win] - csum[..., idx]) / win).to(z.dtype)


def lufs_from_power(p):
    p = torch.as_tensor(p)
    return LUFS_OFFSET + 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def loudness_momentary(x, sample_rate: float):
    """Momentary loudness (400 ms windows, 100 ms hop).  x: (..., C, N)."""
    z = k_weight(x, sample_rate)
    return lufs_from_power(_windowed_power(z, sample_rate, MOMENTARY_SEC))


def loudness_short_term(x, sample_rate: float):
    """Short-term loudness (3 s windows, 100 ms hop).  x: (..., C, N)."""
    z = k_weight(x, sample_rate)
    return lufs_from_power(_windowed_power(z, sample_rate, SHORT_TERM_SEC))


def loudness_integrated(x, sample_rate: float):
    """Gated integrated loudness (BS.1770-4 section 2, two-stage gating):
    the 400 ms blocks above -70 LUFS, then above their mean - 10 LU;
    -inf where no block passes.  x: (..., C, N) -> (...)."""
    z = k_weight(x, sample_rate)
    p = _windowed_power(z, sample_rate, MOMENTARY_SEC)
    lv = lufs_from_power(p)
    abs_mask = lv > ABSOLUTE_GATE_LUFS
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    p_abs = torch.where(abs_mask, p, zero)
    n_abs = torch.clamp(abs_mask.sum(dim=-1), min=1)
    mean_abs = p_abs.sum(dim=-1) / n_abs
    rel_gate = lufs_from_power(mean_abs) + RELATIVE_GATE_LU
    mask = abs_mask & (lv > rel_gate.unsqueeze(-1))
    n_ok = torch.clamp(mask.sum(dim=-1), min=1)
    mean_p = torch.where(mask, p, zero).sum(dim=-1) / n_ok
    return torch.where(mask.sum(dim=-1) > 0, lufs_from_power(mean_p),
                       torch.full_like(mean_p, -np.inf))


def _delay(x, k):
    if k == 0:
        return x
    if k < 0:
        return _advance(x, -k)
    return F.pad(x, (k, 0))[..., :x.shape[-1]]


def _advance(x, k):
    if k == 0:
        return x
    if k < 0:
        return _delay(x, -k)
    return F.pad(x, (0, k))[..., k:]


def _tp_interpolate2x(x, stage):
    """TruePeakDetector::interpolateStage (TruePeakDetector.cpp:284-311):
    both phases combine the 0.5 center tap with the half-band arm (DC gain
    1, no x2):
      even[n] = 0.5 x[n-d]   + sum_s conv[s] x[n-d-vp+cc-1-s]
      odd[n]  = 0.5 x[n-d+1] + sum_s conv[s] x[n-d-1+vp+cc-1-s]
    """
    cc = len(stage.conv)
    d = stage.center_delay
    vp = stage.conv_parity
    n = x.shape[-1]
    # look-ahead: the arm reads up to cc-1-d samples past the current input
    # (the reference reads them from its zero-initialized history tail)
    g = _causal_fir(F.pad(x, (0, cc)), stage.conv)   # sum_s conv[s] x[n-s]

    def ge(k):
        return g[..., k:k + n] if k >= 0 else _delay(g[..., :n], -k)
    even = 0.5 * _delay(x, d) + ge(cc - 1 - d - vp)
    odd = 0.5 * _delay(x, d - 1) + ge(cc - 2 - d + vp)
    return torch.stack([even, odd], dim=-1).reshape(x.shape[:-1] + (2 * n,))


def true_peak(x, taps: int = 63, attenuation_db: float = 100.0):
    """BS.1770 true peak: 4x oversampling as two 2x halfband stages
    (stage 0 `taps`, stage 1 max(15, taps // 2); TruePeakDetector.cpp
    prepare:24-28), then max |.| over the 4x signal.  x: (..., N) ->
    (...) linear true peak.  Offline the signal is zero-padded, so the
    last ~taps samples see the edge roll-off (the reference's history
    buffer covers them between blocks)."""
    st0 = design_halfband(taps, attenuation_db)
    st1 = design_halfband(max(15, taps // 2), attenuation_db)
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    group = max(1, TRUE_PEAK_CHUNK_VALUES // max(1, 4 * n))
    peaks = [_tp_interpolate2x(_tp_interpolate2x(rows[r:r + group], st0),
                               st1).abs().amax(dim=-1)
             for r in range(0, rows.shape[0], group)]
    return torch.cat(peaks).reshape(x.shape[:-1])


# Spectrum analyzer constants (SpectrumAnalyzerComponent.h:66-95)
ANALYZER_FFT = 4096
ANALYZER_HOP = ANALYZER_FFT // 4
ANALYZER_MAG_SCALE = 2.0 / ANALYZER_FFT


def spectrum_frames(x, fft_size: int = ANALYZER_FFT, hop: int = ANALYZER_HOP):
    """Hann-windowed magnitude STFT frames (scale 2/N) of x (..., N):
    (..., nframes, fft_size // 2 + 1), a signal shorter than one frame
    zero-padded to it.  When hop divides fft_size the frames are the
    concatenation of fft_size / hop shifted contiguous slices of the
    (N / hop, hop)-reshaped signal (JAX :206-216); otherwise a strided
    view of x."""
    n = x.shape[-1]
    if n < fft_size:
        x = F.pad(x, (0, fft_size - n))
        n = fft_size
    nf = (n - fft_size) // hop + 1
    if fft_size % hop == 0:
        m = n // hop
        r = x[..., :m * hop].reshape(x.shape[:-1] + (m, hop))
        frames = torch.cat([r[..., j:j + nf, :]
                            for j in range(fft_size // hop)], dim=-1)
    else:
        frames = x.unfold(-1, fft_size, hop)
    # juce::dsp::WindowingFunction hann (symmetric)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(fft_size)
                           / (fft_size - 1))
    spec = torch.fft.rfft(frames * torch.as_tensor(w, dtype=x.dtype,
                                                   device=x.device), dim=-1)
    return spec.abs() * ANALYZER_MAG_SCALE


def spectrum_peak_hold(x, sample_rate: float, hold_sec: float = 1.0,
                       fft_size: int = ANALYZER_FFT, hop: int = ANALYZER_HOP):
    """Per-bin peak with hold (SpectrumAnalyzerComponent.h:88,123
    PEAK_HOLD_SEC = 1.0): each frame shows the max magnitude over the
    trailing `hold_sec` of frames.  A running max over the shifted frame
    sequences (the JAX package stacks them, then takes the max: the same
    values)."""
    mags = spectrum_frames(x, fft_size, hop)
    frames_per_hold = max(1, int(round(hold_sec * sample_rate / hop)))
    nf = mags.shape[-2]
    held = mags
    for k in range(1, min(frames_per_hold, nf + 1)):
        shifted = F.pad(mags, (0, 0, k, 0))[..., :nf, :]
        held = torch.maximum(held, shifted)
    return held


def spectrum_smoothed(x, ema_alpha: float = 0.15, **kw):
    """EMA-smoothed analyzer frames: s[f] = s[f-1] (1-a) + mag[f] a (one-pole
    scan over the frame axis)."""
    mags = spectrum_frames(x, **kw)
    m = mags.movedim(-2, -1)                          # (..., bins, nf)
    pre, fin = one_pole_scan(m, 1.0 - ema_alpha, ema_alpha, 0.0)
    post = torch.cat([pre[..., 1:], fin.unsqueeze(-1)], dim=-1)
    return post.movedim(-1, -2)
