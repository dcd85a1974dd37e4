"""Spectrum-analyzer display surface — EQ overlay + display bars +
adaptive refresh (counterpart of convopeq_tpu/models/analyzer_view.py;
the non-GUI core of src/SpectrumAnalyzerComponent.cpp).  Host NumPy f64;
the frames come from the port's `spectrum_frames` on a CPU tensor, and
`AnalyzerView.push` takes host arrays or tensors on any device (a block
is copied to the host, as the reference's FIFO is).

Reproduces the reference's display pipeline (headless — the rebuild
exposes the data surface a front-end would render):

- 128 log-spaced display bars, 20 Hz..20 kHz, with the reference's
  sqrt-warped X<->log-frequency map (MAP_COEFF_* constants,
  SpectrumAnalyzerComponent.h:154-157, .cpp:78-85).
- per-bar values by linear interpolation of the smoothed/peak dB bins at
  the bar frequency (paintSpectrum, .cpp:776-815), clamped [-80, +20] dB.
- running smoothing state: rawBuffer -> EMA (SMOOTHING_ALPHA = 0.85,
  .cpp:509-510) -> peak-hold 1.0 s with exponential decay
  (time constant 0.4 s, .cpp:318-319, 513-533).
- EQ overlay: total L/R response curves + per-band individual curves in
  dB at the bar frequencies, routed by channel mode (updateEQData,
  .cpp:826-900; response math shared with engine/eq_analysis).
- adaptive refresh rate: 60 Hz active / 15 Hz idle-visible / 5 Hz hidden
  (TIMER_HZ_*, SpectrumAnalyzerComponent.h:202-204).
"""
from __future__ import annotations

import numpy as np
import torch

from ..engine.eq_analysis import svf_to_biquad
from ..models.eq import EQParams, band_active_mask, NUM_BANDS
from ..models.eq import STEREO, LEFT, RIGHT, MID, SIDE
from ..ops.svf import svf_coeffs
from .metering import ANALYZER_FFT, spectrum_frames

NUM_DISPLAY_BARS = 128                 # AudioEngine.h:1082
MIN_FREQ_HZ = 20.0                     # SpectrumAnalyzerComponent.h:118
MAX_FREQ_HZ = 20000.0
MIN_DB = -80.0
MAX_DB = 20.0
FFT_DISPLAY_MIN_DB = -100.0
FFT_DISPLAY_MIN_MAG = 1e-9
SMOOTHING_ALPHA = 0.85                 # .h:116
PEAK_HOLD_SEC = 1.0                    # .h:123
PEAK_DECAY_TC_SEC = 0.4                # .cpp:318
MAP_COEFF_A = 49.0                     # .h:154-157
MAP_COEFF_D = 2499.0
TIMER_HZ_ACTIVE = 60                   # .h:202-204
TIMER_HZ_IDLE_VISIBLE = 15
TIMER_HZ_HIDDEN = 5


def map_x_to_log_freq(x):
    """mapXToLogFreq (.cpp): sqrt-warped normalized X -> log-f fraction."""
    x = np.asarray(x, np.float64)
    return (np.sqrt(1.0 + MAP_COEFF_D * x) - 1.0) / MAP_COEFF_A


def display_frequencies() -> np.ndarray:
    """The 128 bar center frequencies (.cpp:78-85)."""
    i = np.arange(NUM_DISPLAY_BARS)
    x = i / (NUM_DISPLAY_BARS - 1)
    log_t = map_x_to_log_freq(x)
    lo = np.log10(MIN_FREQ_HZ)
    hi = np.log10(MAX_FREQ_HZ)
    return 10.0 ** (lo + log_t * (hi - lo))


def adaptive_timer_hz(analyzer_enabled: bool, visible: bool = True) -> int:
    """Adaptive refresh-rate policy (.cpp:227-236)."""
    if not visible:
        return TIMER_HZ_HIDDEN
    return TIMER_HZ_ACTIVE if analyzer_enabled else TIMER_HZ_IDLE_VISIBLE


def bins_to_bars(bins_db: np.ndarray, processing_rate: float) -> np.ndarray:
    """Per-bar dB by linear interpolation of FFT-bin dB at the bar
    frequency (paintSpectrum, .cpp:776-793).  bins_db: (..., NUM_BINS)."""
    bins_db = np.asarray(bins_db)
    nbins = bins_db.shape[-1]
    bin_factor = (2 * (nbins - 1)) / processing_rate
    nyq = processing_rate / 2.0
    freq = np.minimum(display_frequencies(), nyq)
    bin_idx = np.clip(freq * bin_factor, 0.0, nbins - 1)
    i0 = bin_idx.astype(int)
    i1 = np.minimum(i0 + 1, nbins - 1)
    frac = bin_idx - i0
    db = bins_db[..., i0] * (1.0 - frac) + bins_db[..., i1] * frac
    return np.clip(db, MIN_DB, MAX_DB)


def _band_responses(params: EQParams, sample_rate: float):
    """Per-band complex response at the bar frequencies (zCache analog)."""
    freqs = display_frequencies()
    w = 2.0 * np.pi * np.minimum(freqs, sample_rate * 0.5) / sample_rate
    z = np.exp(1j * w)
    z2 = z * z
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    out = {}
    for b in range(NUM_BANDS):
        b0, b1, b2, a0, a1, a2 = svf_to_biquad(
            *(float(c[b]) for c in coeffs))
        out[b] = (b0 * z2 + b1 * z + b2) / (a0 * z2 + a1 * z + a2)
    return out


def eq_overlay_curves(params: EQParams, processing_rate: float) -> dict:
    """Total + per-band EQ display curves in dB at the bar frequencies
    (updateEQData, .cpp:826-900).

    Returns {"freqs", "total_l", "total_r", "bands_l", "bands_r",
    "bands_mid", "bands_side"} — per-band arrays are (NUM_BANDS, 128),
    inactive bands are 0 dB (the reference fills 0 for display)."""
    active = band_active_mask(params)
    H = _band_responses(params, processing_rate)
    n = NUM_DISPLAY_BARS
    tl = np.ones(n, complex)
    tr = np.ones(n, complex)
    bands_l = np.zeros((NUM_BANDS, n))
    bands_r = np.zeros((NUM_BANDS, n))
    bands_mid = np.zeros((NUM_BANDS, n))
    bands_side = np.zeros((NUM_BANDS, n))
    to_db = lambda m: 20.0 * np.log10(np.maximum(m, FFT_DISPLAY_MIN_MAG))
    for b in range(NUM_BANDS):
        if not active[b]:
            continue
        mode = int(params.modes[b])
        mag_db = to_db(np.abs(H[b]))
        if mode in (STEREO, LEFT):
            bands_l[b] = mag_db
        if mode in (STEREO, RIGHT):
            bands_r[b] = mag_db
        if mode == MID:
            bands_mid[b] = mag_db
        if mode == SIDE:
            bands_side[b] = mag_db
        # total response: L/R follow the 2x2 stereo map's diagonal as the
        # reference's calcEQResponseCurve does (mid/side contribute the
        # (H+1)/2 diagonal to both channels)
        if mode == STEREO:
            tl = tl * H[b]
            tr = tr * H[b]
        elif mode == LEFT:
            tl = tl * H[b]
        elif mode == RIGHT:
            tr = tr * H[b]
        else:
            diag = (H[b] + 1.0) * 0.5
            tl = tl * diag
            tr = tr * diag
    return {
        "freqs": display_frequencies(),
        "total_l": to_db(np.abs(tl)),
        "total_r": to_db(np.abs(tr)),
        "bands_l": bands_l, "bands_r": bands_r,
        "bands_mid": bands_mid, "bands_side": bands_side,
    }


class AnalyzerView:
    """Running analyzer display state (raw -> EMA -> peak-hold) fed by
    audio blocks; `bars()` returns the render-ready per-bar values."""

    def __init__(self, processing_rate: float, fft_size: int = ANALYZER_FFT):
        self.rate = float(processing_rate)
        self.fft_size = fft_size
        nbins = fft_size // 2 + 1
        self.smoothed = np.full(nbins, MIN_DB)
        self.peak = np.full(nbins, MIN_DB)
        self.hold = np.zeros(nbins)
        self._frame_dt = (fft_size // 4) / self.rate
        self._fifo = np.empty(0, np.float64)   # inter-push sample carry

    def push(self, x: np.ndarray):
        """Feed (N,) or (C, N) samples; mono mix is analyzed (the
        reference taps a mono FIFO).  Updates EMA + peak-hold per frame.

        Samples accumulate in a FIFO across pushes: frames are cut only
        from REAL contiguous audio (a push shorter than fft_size is held
        until enough arrives — never zero-padded into a mostly-silent
        frame), and the tail past the last full hop carries over."""
        if torch.is_tensor(x):
            x = x.detach().to("cpu", torch.float64).numpy()
        x = np.asarray(x)
        if x.ndim > 1:
            x = x.mean(axis=0)
        hop = self.fft_size // 4
        buf = np.concatenate([self._fifo, np.asarray(x, np.float64)])
        if buf.size < self.fft_size:
            self._fifo = buf
            return self
        nf = (buf.size - self.fft_size) // hop + 1
        consumed = nf * hop                    # hop-aligned carry
        self._fifo = buf[consumed:]
        mags = spectrum_frames(
            torch.from_numpy(buf[:(nf - 1) * hop + self.fft_size]),
            self.fft_size, hop).numpy()
        for f in range(mags.shape[0]):
            raw = np.where(mags[f] > FFT_DISPLAY_MIN_MAG,
                           20.0 * np.log10(np.maximum(mags[f],
                                                      FFT_DISPLAY_MIN_MAG)),
                           FFT_DISPLAY_MIN_DB)
            self.smoothed = (SMOOTHING_ALPHA * self.smoothed
                             + (1.0 - SMOOTHING_ALPHA) * raw)
            rise = self.smoothed >= self.peak
            self.peak = np.where(rise, self.smoothed, self.peak)
            self.hold = np.where(rise, PEAK_HOLD_SEC, self.hold)
            holding = ~rise & (self.hold > 0.0)
            self.hold = np.where(holding,
                                 np.maximum(0.0, self.hold - self._frame_dt),
                                 self.hold)
            decay = np.exp(-self._frame_dt / PEAK_DECAY_TC_SEC)
            decayed = self.smoothed + (self.peak - self.smoothed) * decay
            self.peak = np.where(~rise & ~holding,
                                 np.maximum(decayed, MIN_DB), self.peak)
        return self

    def bars(self) -> dict:
        return {
            "freqs": display_frequencies(),
            "bars_db": bins_to_bars(self.smoothed, self.rate),
            "peaks_db": bins_to_bars(self.peak, self.rate),
        }
