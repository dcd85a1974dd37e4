"""The adaptive noise-shaper learner (counterpart of
convopeq_tpu/models/learner.py): the learned coefficient banks, the
psychoacoustic spectral evaluator, the lattice shaper's error simulation
and the CMA-ES learning loop (src/NoiseShaperLearner.{h,cpp},
src/MklFftEvaluator.h).

180 banks: 10 sample rates x 3 bit depths x 6 learning modes, each nine
reflection coefficients of the adaptive lattice shaper
(src/DeviceSettings.cpp adaptiveCoeff_{sr}_{bit}_{i}).  The factory banks
ship as convopeq_tpu_torch/data/learned_banks.json, a copy of the JAX
package's file, so the port reads nothing of that package.

The learner captures stereo blocks, simulates the 9th-order lattice
shaper's quantization error for every candidate of a CMA-ES population
(18 candidates, 6 elite, in atanh-parcor space) at four target levels,
and scores each error with the psychoacoustic cost of `SpectralEvaluator`
(4096-point FFT, A-weighting, the tonal / noise masking model, JND
weighting, the flatness, ultra-high-share and tonal penalties).  The
evaluator and the CMA-ES are host NumPy, copies of the JAX package's
(the reference runs them on worker threads; so does this module).

The simulation of a whole population is one call of
`models.dither.lattice_dither(..., ladder="fir")` with one coefficient
row a signal row (18 x 4 levels x 2 channels = 144 rows, f64, on the
learner's device): on the card one launch of the quantizer kernel's
per-row form, on the CPU its plain version.  The JAX package computes the
same by vmapping `lattice_dither` over the candidates.
"""
from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ir.cmaes import CmaEs, CmaEsParams
from ..utils.dsputil import K_OUTPUT_HEADROOM
from .dither import LATTICE_COEFF_LIMIT, NS_ORDER_LATTICE, lattice_dither

K_FFT_LENGTH = 4096
K_SPECTRUM_BINS = K_FFT_LENGTH // 2 + 1
K_MIN_POWER = 1.0e-24
K_REFERENCE_SPL_DB = 90.0
K_EFFECTIVE_CAP_DB = 20.0
K_SOFTPLUS_K = 2.0
K_JND_MIN = 0.5
K_JND_LOW_PEAK = 1.0
K_JND_HIGH_SLOPE = 0.2
K_JND_WEIGHT_CONST = 0.3

# Masking model (MklFftEvaluator.h:430-453)
K_BARK_BANDS = 24
K_TONAL_PEAK_DB = 7.0
K_NOISE_CORR_DB = -5.0
K_TONAL_ABSORB_BARK = 0.5
K_SPREAD_MAX_BARK = 8.0
K_SPREAD_STEP = 0.01
K_SPREAD_UP_DB = -27.0
K_SPREAD_DOWN_TONAL_DB = -24.0
K_SPREAD_DOWN_NOISE_DB = -27.0
K_MAX_MASKERS = 128

BANK_SAMPLE_RATES = [44100.0, 48000.0, 88200.0, 96000.0, 176400.0,
                     192000.0, 352800.0, 384000.0, 705600.0, 768000.0]
BANK_BIT_DEPTHS = [16, 24, 32]
BANK_MODES = 6
NUM_BANKS = len(BANK_SAMPLE_RATES) * len(BANK_BIT_DEPTHS) * BANK_MODES
FACTORY_BANKS = Path(__file__).resolve().parent.parent / "data" / \
    "learned_banks.json"


def coefficient_bank_index(sample_rate: float, bit_depth: int,
                           mode: int) -> int:
    sr_idx = int(np.argmin([abs(sample_rate - r) for r in BANK_SAMPLE_RATES]))
    bd_idx = 0 if bit_depth <= 16 else 1 if bit_depth <= 24 else 2
    mode = int(np.clip(mode, 0, BANK_MODES - 1))
    return (sr_idx * len(BANK_BIT_DEPTHS) + bd_idx) * BANK_MODES + mode


class AdaptiveCoefficientBanks:
    """The bank store: set / get by (sample rate, bit depth, mode), and
    the JSON dict form {str(index): [9 floats]}."""

    def __init__(self):
        self._banks: dict = {}

    @staticmethod
    def _key(sample_rate: float, bit_depth: int, mode: int) -> int:
        return coefficient_bank_index(sample_rate, bit_depth, mode)

    def set(self, sample_rate: float, bit_depth: int, mode: int, coeffs):
        c = np.asarray(coeffs, np.float64)
        if c.shape != (NS_ORDER_LATTICE,):
            raise ValueError(f"expected ({NS_ORDER_LATTICE},) coefficients")
        self._banks[self._key(sample_rate, bit_depth, mode)] = c.copy()
        return self

    def get(self, sample_rate: float, bit_depth: int, mode: int):
        """Learned coefficients for the bank, or None if never trained."""
        return self._banks.get(self._key(sample_rate, bit_depth, mode))

    def store_state(self, state: "LearnedState", sample_rate: float,
                    bit_depth: int, mode: int):
        """Publish a learner's best coefficients into their bank."""
        return self.set(sample_rate, bit_depth, mode,
                        state.best_coefficients)

    def to_dict(self) -> dict:
        return {str(k): v.tolist() for k, v in sorted(self._banks.items())}

    @classmethod
    def from_dict(cls, d: dict) -> "AdaptiveCoefficientBanks":
        b = cls()
        for k, v in (d or {}).items():
            c = np.asarray(v, np.float64)
            if c.shape != (NS_ORDER_LATTICE,):
                raise ValueError(f"bank {k}: expected ({NS_ORDER_LATTICE},) "
                                 f"coefficients, got {c.shape}")
            b._banks[int(k)] = c.copy()
        return b

    def __len__(self):
        return len(self._banks)


def factory_banks() -> AdaptiveCoefficientBanks:
    """The factory banks shipped with the package."""
    with open(FACTORY_BANKS) as f:
        return AdaptiveCoefficientBanks.from_dict(json.load(f)["banks"])


# Learner normalization target levels (the reference normalizes captured
# audio to several target levels so the fit covers the loudness range)
TARGET_LEVELS = [0.1, 0.25, 0.5, 0.8]


# Learning modes (NoiseShaperLearner.h LearningMode; convergence windows
# ARCHITECTURE.md:40-45)
SHORTEST, SHORT, MIDDLE, LONG, ULTRA, CONTINUOUS = range(6)

# Phase boundaries in accumulated playback seconds per mode
# (NoiseShaperLearner::computePhase)
PHASE_THRESHOLDS = {
    SHORTEST: (5.0, 10.0),
    SHORT: (10.0, 20.0),
    MIDDLE: (30.0, 60.0),
    LONG: (60.0, 120.0),
    ULTRA: (120.0, 240.0),
    CONTINUOUS: (30.0, 60.0),
}

# (generation_interval_sec, cov_retention_target) per mode x phase and the
# per-mode covariance retention ramp step (NoiseShaperLearner::
# applyPhaseParams)
PHASE_PARAMS = {
    SHORTEST: ((0.25, 0.80), (0.5, 0.85), (1.0, 0.90), 0.02),
    SHORT: ((0.5, 0.85), (1.0, 0.90), (2.0, 0.95), 0.01),
    MIDDLE: ((1.0, 0.90), (2.0, 0.95), (4.0, 0.98), 0.005),
    LONG: ((2.0, 0.95), (4.0, 0.98), (8.0, 0.99), 0.002),
    ULTRA: ((4.0, 0.98), (8.0, 0.99), (16.0, 0.995), 0.001),
    CONTINUOUS: ((1.0, 0.90), (2.0, 0.95), (4.0, 0.98), 0.005),
}

# Target-level weighting per phase: 1 = high-level focus (stability),
# 2 = balanced, 3 = low-level focus (idle-tone detection)
LEVEL_WEIGHTS_BY_PHASE = {
    1: np.array([0.1, 0.2, 0.3, 0.4]),
    2: np.array([0.25, 0.25, 0.25, 0.25]),
    3: np.array([0.5, 0.3, 0.1, 0.1]),
}


def compute_phase(mode: int, playback_seconds: float) -> int:
    """Phase 1: exploration, 2: convergence, 3: fine-tune
    (NoiseShaperLearner::computePhase)."""
    t1, t2 = PHASE_THRESHOLDS.get(int(mode), PHASE_THRESHOLDS[CONTINUOUS])
    if playback_seconds < t1:
        return 1
    if playback_seconds < t2:
        return 2
    return 3


def a_weight_power(f, nyquist_hz):
    """bandWeightForHz (MklFftEvaluator.h:187-206): squared A-weighting
    response with a steep rolloff above 18 kHz."""
    f = np.maximum(np.asarray(f, np.float64), 1.0)
    f2 = f * f
    h1 = (-4.737338981378384e-24 * f2 ** 3 + 2.043828333606125e-15 * f2 ** 2
          - 1.363894795463638e-7 * f2 + 1.0)
    h2 = (1.306612257402824e-19 * f2 ** 2 * f - 2.118150887541247e-11 * f2 * f
          + 5.559488023498642e-4 * f)
    r = (1.246332637532143e-4 * f) / np.sqrt(h1 * h1 + h2 * h2)
    w = r * r
    hi = f > 18000.0
    roll = 10.0 ** (-12.0 * (f - 18000.0)
                    / np.maximum(1000.0, nyquist_hz - 18000.0) / 20.0)
    w = np.where(hi, w * roll * roll, w)
    return np.maximum(1.0e-6, w)


def ath_spl_db(f):
    """Terhardt absolute threshold (MklFftEvaluator.h:570-578)."""
    fk = np.maximum(0.01, np.asarray(f, np.float64) / 1000.0)
    return (3.64 * fk ** -0.8 - 6.5 * np.exp(-0.6 * (fk - 3.3) ** 2)
            + 0.001 * fk ** 4)


def jnd_weight(f):
    fk = np.maximum(0.0, np.asarray(f, np.float64) / 1000.0)
    jnd = np.clip(K_JND_MIN + K_JND_LOW_PEAK * np.exp(-0.5 * (fk - 0.5) ** 2)
                  + K_JND_HIGH_SLOPE * (fk - 3.0) ** 2, K_JND_MIN, 3.0)
    return 1.0 / np.maximum(1e-6, jnd + K_JND_WEIGHT_CONST)


def freq_to_bark(f):
    """freqToBark (MklFftEvaluator.h:558-562)."""
    f = np.maximum(0.0, np.asarray(f, np.float64))
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _spread_db(delta_bark, tonal: np.ndarray):
    """spreadingFunctionAnnexD (MklFftEvaluator.h:456-484, 602-611):
    Schroeder-style spreading, table-quantized at 0.01 bark like the
    reference's lookup; `tonal` selects the -24 (tonal) vs -27 (noise)
    downward slope."""
    d = np.round(np.asarray(delta_bark, np.float64) / K_SPREAD_STEP) \
        * K_SPREAD_STEP
    up = K_SPREAD_UP_DB * d
    x = d + 0.474
    nonlin = 15.81 + 7.5 * x - 17.5 * np.sqrt(1.0 + x * x)
    down_slope = np.where(tonal, K_SPREAD_DOWN_TONAL_DB,
                          K_SPREAD_DOWN_NOISE_DB)
    down = nonlin + (down_slope + 27.0) * np.abs(d)
    out = np.where(d >= 0.0, up, down)
    return np.where(np.abs(d) > K_SPREAD_MAX_BARK + 0.5 * K_SPREAD_STEP,
                    0.0, out)


def _softplus(x):
    z = K_SOFTPLUS_K * np.asarray(x)
    out = np.where(z > 50.0, x,
                   np.log1p(np.exp(np.clip(z, -50.0, 50.0))) / K_SOFTPLUS_K)
    return np.where(z < -50.0, np.exp(np.clip(z, -745, 0)) / K_SOFTPLUS_K, out)


@dataclass
class EvaluatorResult:
    noise_power: float = 0.0
    spectral_flatness_penalty: float = 0.0
    hf_penalty: float = 0.0
    time_domain_rms: float = 0.0
    composite_score: float = 0.0


class SpectralEvaluator:
    """Psychoacoustic spectral cost (MklFftEvaluator equivalent)."""

    def __init__(self, sample_rate: float):
        self.sample_rate = max(8000.0, float(sample_rate))
        nyq = self.sample_rate / 2.0
        bin_width = nyq / (K_SPECTRUM_BINS - 1)
        f = np.arange(K_SPECTRUM_BINS) * bin_width
        self.freq = f
        self.weights = a_weight_power(f, nyq)
        self.ath_db = ath_spl_db(f) - K_REFERENCE_SPL_DB
        self.jnd_w = jnd_weight(f)
        self.flatness_penalty_weight = 0.35
        self.hf_penalty_weight = float(np.clip(
            0.20 * np.sqrt(48000.0 / self.sample_rate), 0.05, 0.20))

        def hz_to_bin(hz):
            return int(np.clip(round(hz / bin_width), 0, K_SPECTRUM_BINS - 1))
        fs_start = min(12000.0, nyq * 0.60)
        fs_end = min(18000.0, nyq * 0.82)
        if fs_end <= fs_start + bin_width * 8.0:
            fs_start, fs_end = nyq * 0.50, nyq * 0.80
        self.flat_lo = hz_to_bin(fs_start)
        self.flat_hi = max(self.flat_lo + 1, hz_to_bin(fs_end))
        hb_start = max(14000.0, nyq * 0.60)
        if hb_start >= nyq:
            hb_start = nyq * 0.60
        uh_start = nyq * 0.85
        if uh_start <= hb_start + bin_width * 8.0:
            uh_start = hb_start + bin_width * 8.0
        self.high_bin = hz_to_bin(hb_start)
        self.uh_bin = max(self.high_bin + 1, hz_to_bin(uh_start))
        hb_bins = max(1, K_SPECTRUM_BINS - self.high_bin)
        uh_bins = max(1, K_SPECTRUM_BINS - self.uh_bin)
        self.expected_uh_share = uh_bins / hb_bins

        # --- masking-model tables (configureForSampleRate, h:214-239) ---
        self.bark = freq_to_bark(f)
        # Terhardt's 0.001*fk^4 term reaches thousands of dB near high-rate
        # Nyquist; clamp at +300 dB before exponentiating (behaviorally
        # neutral — the threshold sits astronomically above any signal
        # either way, but 10**(db/10) would overflow f64 and warn).
        self.ath_power = 10.0 ** (np.minimum(self.ath_db, 300.0) / 10.0)
        max_bark = freq_to_bark(nyq)
        bark_step = max(1e-9, max_bark / K_BARK_BANDS)
        self.bin_to_band = np.clip((self.bark / bark_step).astype(int),
                                   0, K_BARK_BANDS - 1)
        # neighborRangeBins (h:613-619): half the critical bandwidth in bins
        fk = np.maximum(0.0, f / 1000.0)
        bw = 25.0 + 75.0 * (1.0 + 1.4 * fk * fk) ** 0.69
        self.neighbor_range = np.clip(
            (bw / max(1.0, bin_width) * 0.5).astype(int), 1, 24)
        # getBinWidth (h:621-628): centered difference, one-sided at edges
        gw = np.empty(K_SPECTRUM_BINS)
        gw[0] = f[1] - f[0]
        gw[-1] = f[-1] - f[-2]
        gw[1:-1] = 0.5 * (f[2:] - f[:-2])
        self.bin_width_arr = gw

    def _detect_tonal_maskers(self, p):
        """detectTonalMaskersFixed (h:630-685): local peaks >= 7 dB above
        every neighbor within the critical-band range; each absorbs the
        energy within +-0.5 bark (+-8 bins) into a bark-centroid masker."""
        db = 10.0 * np.log10(np.maximum(p, K_MIN_POWER))
        nbins = K_SPECTRUM_BINS
        is_peak = np.zeros(nbins, bool)
        is_peak[3:nbins - 3] = True
        for k in range(1, 25):
            active = self.neighbor_range >= k
            left = np.empty(nbins)
            left[:k] = np.inf                    # no left neighbor -> pass
            left[k:] = db[:-k]
            right = np.empty(nbins)
            right[-k:] = np.inf
            right[:-k] = db[k:]
            # reference checks (i-k)>=0 / (i+k)<bins; inf sentinels mean
            # "neighbor absent = condition passes", but for i in [3, n-4]
            # with k<=24 > i-k can be negative only for i<24: match exactly
            ok = np.ones(nbins, bool)
            has_l = np.arange(nbins) - k >= 0
            has_r = np.arange(nbins) + k < nbins
            ok &= ~has_l | (db - left >= K_TONAL_PEAK_DB)
            ok &= ~has_r | (db - right >= K_TONAL_PEAK_DB)
            is_peak &= ~active | ok
        peaks = np.nonzero(is_peak)[0]

        consumed = np.zeros(nbins, bool)
        maskers = []
        e_bw = p * self.bin_width_arr
        for i in peaks[:K_MAX_MASKERS]:
            lo = max(0, i - 8)
            hi = min(nbins - 1, i + 8)
            j = np.arange(lo, hi + 1)
            sel = np.abs(self.bark[j] - self.bark[i]) <= K_TONAL_ABSORB_BARK
            j = j[sel]
            e = e_bw[j]
            s = e.sum()
            consumed[j] = True
            if s <= K_MIN_POWER:
                continue
            maskers.append((s, float((self.bark[j] * e).sum() / s), True, 1.0))
        return maskers, consumed

    def _build_noise_maskers(self, p, consumed):
        """buildNoiseMaskersFixed (h:712-746): one masker per bark band from
        the unconsumed bins; tonality from the band's spectral flatness."""
        maskers = []
        e_bw = p * self.bin_width_arr
        free = ~consumed
        for band in range(K_BARK_BANDS):
            sel = free & (self.bin_to_band == band)
            if not sel.any():
                continue
            e = e_bw[sel]
            s = e.sum()
            if s <= K_MIN_POWER:
                continue
            pb = np.maximum(p[sel], 1e-15)
            sfm = np.exp(np.mean(np.log(pb))) / max(np.mean(pb), 1e-15)
            tonality = float(np.clip(-0.299 - 0.43 * np.log10(max(sfm, 1e-12)),
                                     0.0, 1.0))
            maskers.append((s, float((self.bark[sel] * e).sum() / s),
                            False, tonality))
        return maskers

    def _masking_energy(self, maskers):
        """computeMaskingEnergyStable (h:748-798): power-sum of all masker
        contributions spread across bark distance, floored at the ATH."""
        if not maskers:
            return self.ath_power.copy()
        energy = np.array([m[0] for m in maskers])
        bark = np.array([m[1] for m in maskers])
        tonal = np.array([m[2] for m in maskers])
        tonality = np.array([m[3] for m in maskers])
        level_db = 10.0 * np.log10(np.maximum(energy, K_MIN_POWER))
        level_db = level_db + np.where(tonal, 0.0,
                                       K_NOISE_CORR_DB * (1.0 - tonality))
        delta = self.bark[:, None] - bark[None, :]          # (bins, M)
        in_range = np.abs(delta) <= K_SPREAD_MAX_BARK
        total_db = level_db[None, :] + _spread_db(delta, tonal[None, :])
        contrib = np.where(in_range, 10.0 ** (total_db / 10.0), 0.0)
        total = contrib.sum(axis=1)
        return np.where(in_range.any(axis=1),
                        np.maximum(total, self.ath_power), self.ath_power)

    def signal_masking_thresholds(self, left, right):
        """precomputeMaskingThresholds (NoiseShaperLearner.cpp:1377-1397):
        per-bin threshold power masked by the SIGNAL segment itself,
        max(ATH, binEnergy * 10^((-12 - 0.6*bark)/10))."""
        el = np.asarray(left, np.float64)[:K_FFT_LENGTH]
        er = np.asarray(right, np.float64)[:K_FFT_LENGTH]
        if len(el) < K_FFT_LENGTH:
            el = np.pad(el, (0, K_FFT_LENGTH - len(el)))
            er = np.pad(er, (0, K_FFT_LENGTH - len(er)))
        pl = np.abs(np.fft.rfft(el)) ** 2
        pr = np.abs(np.fft.rfft(er)) ** 2
        e = np.maximum(0.5 * (pl + pr), K_MIN_POWER)
        spread = e * 10.0 ** ((-12.0 - 0.6 * self.bark) / 10.0)
        return np.maximum(self.ath_power, spread)

    def evaluate(self, err_l: np.ndarray, err_r: np.ndarray,
                 masking_thresholds: np.ndarray | None = None) \
            -> EvaluatorResult:
        el = np.asarray(err_l, np.float64)[:K_FFT_LENGTH]
        er = np.asarray(err_r, np.float64)[:K_FFT_LENGTH]
        if len(el) < K_FFT_LENGTH:
            el = np.pad(el, (0, K_FFT_LENGTH - len(el)))
            er = np.pad(er, (0, K_FFT_LENGTH - len(er)))
        time_rms = np.sqrt(0.5 * (el @ el + er @ er) / K_FFT_LENGTH)

        SL = np.fft.rfft(el)
        SR_ = np.fft.rfft(er)
        p = np.maximum(K_MIN_POWER,
                       0.5 * (np.abs(SL) ** 2 + np.abs(SR_) ** 2))

        # flatness over the 12-18k (or scaled) band
        band = p[self.flat_lo:self.flat_hi + 1] + K_MIN_POWER
        geo = np.exp(np.mean(np.log(band)))
        arith = np.mean(band)
        flatness = float(np.clip(geo / max(arith, K_MIN_POWER), 0.0, 1.0))

        high = p[self.high_bin:].sum()
        uh = p[self.uh_bin:].sum()
        hf_pen = max(0.0, uh / max(high + K_MIN_POWER, K_MIN_POWER)
                     - self.expected_uh_share) \
            / max(1.0 - self.expected_uh_share, K_MIN_POWER)

        # tonal peak detection (bin > 6x local average)
        local = 0.5 * (p[:-2] + p[2:]) + K_MIN_POWER
        peaks = p[1:-1][p[1:-1] > 6.0 * local]
        peak_energy = peaks.max() if peaks.size else 0.0
        tonal_pen = max(0.0, peak_energy / (p.sum() + K_MIN_POWER)
                        - 0.05) * 10.0

        # psychoacoustic over-threshold power: threshold = max(masking
        # energy from the tonal/noise masker spreading model, ATH, optional
        # precomputed signal-masking thresholds) (h:325-349)
        tonal_m, consumed = self._detect_tonal_maskers(p)
        noise_m = self._build_noise_maskers(p, consumed)
        mask_energy = self._masking_energy(tonal_m + noise_m)
        threshold_db = np.maximum(
            10.0 * np.log10(np.maximum(mask_energy, K_MIN_POWER)),
            self.ath_db)
        if masking_thresholds is not None:
            threshold_db = np.maximum(
                threshold_db, 10.0 * np.log10(
                    np.maximum(masking_thresholds, K_MIN_POWER)))
        signal_db = 10.0 * np.log10(p)
        delta_db = signal_db - threshold_db
        eff_db = K_EFFECTIVE_CAP_DB * np.tanh(_softplus(delta_db)
                                              / K_EFFECTIVE_CAP_DB)
        eff_power = np.maximum(0.0, 10.0 ** (eff_db / 10.0) - 1.0)
        w = self.weights * self.jnd_w
        noise_power = float((w * eff_power).sum() / max(w.sum(), K_MIN_POWER)
                            * K_FFT_LENGTH)

        res = EvaluatorResult(
            noise_power=noise_power,
            spectral_flatness_penalty=1.0 - flatness,
            hf_penalty=float(hf_pen),
            time_domain_rms=float(time_rms))
        res.composite_score = noise_power * (
            1.0 + self.flatness_penalty_weight * res.spectral_flatness_penalty
            + self.hf_penalty_weight * res.hf_penalty + tonal_pen)
        return res


def ntf_l2_gain(reflection_coeffs) -> float:
    """L2 norm of the fir ladder's noise transfer function.

    The fir ladder realizes NTF(z) = A_9(z), the prediction-error
    polynomial of the reflection coefficients (Levinson recursion), so the
    shaper's white-noise amplification is ||A||_2 = sqrt(sum a_i^2), in
    closed form.  Banks with a large ||A||_2 resonate: the closed loop
    carries bursty limit cycles under broadband input that a tonal
    training block never excites.  The learner multiplies its cost by
    (1 + w * max(0, ||A||_2 - NTF_L2_BUDGET)).  The coefficients are
    clamped at LATTICE_COEFF_LIMIT, as the shaper clamps them (the JAX
    package writes the same 0.85 as a literal)."""
    k = np.clip(np.nan_to_num(np.asarray(reflection_coeffs, np.float64)),
                -LATTICE_COEFF_LIMIT, LATTICE_COEFF_LIMIT)
    a = np.array([1.0])
    for km in k:
        a = np.concatenate([a, [0.0]]) + km * np.concatenate(
            [[0.0], a[::-1]])
    return float(np.sqrt(np.sum(a * a)))


NTF_L2_BUDGET = 3.0
NTF_L2_PENALTY_WEIGHT = 2.0


def _ntf_penalty(k) -> float:
    return 1.0 + NTF_L2_PENALTY_WEIGHT * max(
        0.0, ntf_l2_gain(k) - NTF_L2_BUDGET)


def simulate_shaper_error_population(audio_levels, coeff_matrix,
                                     bit_depth: int, uniforms,
                                     ladder: str = "fir",
                                     device="cuda") -> np.ndarray:
    """Quantization error of the lattice shaper for a whole CMA-ES
    population in one call: every (candidate, level, channel) is a signal
    row of one `lattice_dither` call with that candidate's coefficients
    (the per-row form of the quantizer; on the card one kernel launch).

    audio_levels: (L, 2, N) leveled blocks; coeff_matrix: (P, order);
    uniforms: (L, 2, N, 2), a NumPy array or a tensor (the learner passes
    its session's uniforms already on the device).  Runs in f64 on
    `device`.  Returns (P, L, 2, N) errors (host NumPy).

    The simulated ladder is the production "fir" variant (the learner
    must train the shaper it ships)."""
    dev = resolve_device(device)
    a = np.asarray(audio_levels, np.float64)
    K = np.asarray(coeff_matrix, np.float64)
    P = K.shape[0]
    x = torch.from_numpy(a).to(dev).expand((P,) + a.shape)
    u = torch.as_tensor(uniforms).to(dev, torch.float64)
    u = u.expand((P,) + a.shape + (2,))
    k = np.broadcast_to(K[:, None, None, :], (P,) + a.shape[:-1]
                        + (K.shape[-1],))
    y = lattice_dither(x, u, k, bit_depth, ladder=ladder)
    return y.cpu().numpy() - a[None] * K_OUTPUT_HEADROOM


def simulate_shaper_error(audio_lr, reflection_coeffs, sample_rate: float,
                          bit_depth: int,
                          rng: np.random.Generator | None = None,
                          uniforms=None, ladder: str = "fir",
                          device="cuda"):
    """Quantization error of the lattice shaper on a stereo block, f64 on
    `device`.

    Pass `uniforms` for a deterministic cost (the learner fixes the dither
    draw per session so CMA-ES sees a noise-free objective)."""
    dev = resolve_device(device)
    x = np.asarray(audio_lr, np.float64)
    if uniforms is None:
        uniforms = (rng or np.random.default_rng(0)).uniform(
            size=x.shape + (2,))
    y = lattice_dither(torch.from_numpy(x).to(dev),
                       torch.as_tensor(uniforms).to(dev, torch.float64),
                       reflection_coeffs, bit_depth, ladder=ladder)
    return y.cpu().numpy() - x * K_OUTPUT_HEADROOM


@dataclass
class LearnedState:
    """NoiseShaperLearner::LearnedState analog."""
    best_coefficients: np.ndarray
    best_score: float
    generations: int
    bank_index: int = 0


class NoiseShaperLearner:
    """CMA-ES learning loop (NoiseShaperLearner.h; dims from
    CmaEsOptimizer.h:14-16: dim 9, population 18, elite 6).

    device: where the population's simulation runs ("cuda" by default: a
    CPU run must be asked for).  The evaluator runs on the host on a pool
    of `workers` threads.  `sim_seconds` and `eval_seconds` add up the
    wall of the simulation (device, fenced by the copy of its errors to
    the host) and of the scoring (host) over the generations run."""

    def __init__(self, sample_rate: float, bit_depth: int = 16, mode: int = 0,
                 seed: int = 0, workers: int = 4, eval_blocks: int = 1,
                 device="cuda"):
        # eval_blocks: simulate eval_blocks * 4096 samples per candidate
        # and score every window AFTER the first, so the objective sees
        # the shaper's warm (stationary) state rather than the quieter
        # zero-state startup transient.  The offline factory-bank
        # trainer uses eval_blocks=16; 1 keeps the reference's
        # per-captured-block live cost.
        self.device = resolve_device(device)
        self.eval_blocks = max(1, int(eval_blocks))
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self.mode = mode
        self.workers = max(1, int(workers))
        self.evaluator = SpectralEvaluator(sample_rate)
        self.opt = CmaEs(NS_ORDER_LATTICE, population=18, elite=6,
                         params=CmaEsParams(sigma_min=0.03, sigma_max=0.30),
                         seed=seed)
        self.opt.init_mean(np.zeros(NS_ORDER_LATTICE))
        self.rng = np.random.default_rng(seed + 1)
        self._uniforms = None
        self._uniforms_dev = None
        self.best = None
        self.best_score = np.inf
        self.generation = 0
        self.sim_seconds = 0.0
        self.eval_seconds = 0.0
        # phased schedule state (computePhase / applyPhaseParams)
        self.accumulated_seconds = 0.0
        self.phase = 0                       # forces apply on first feed
        self.level_weights = LEVEL_WEIGHTS_BY_PHASE[1]
        self.generation_interval_seconds = PHASE_PARAMS[
            int(np.clip(mode, 0, BANK_MODES - 1))][0][0]
        self._apply_phase(1)

    def _apply_phase(self, phase: int):
        """applyPhaseParams: per-phase generation pacing, covariance
        retention ramp, and target-level weighting."""
        if phase == self.phase:
            return
        self.phase = phase
        mode = int(np.clip(self.mode, 0, BANK_MODES - 1))
        p1, p2, p3, step = PHASE_PARAMS[mode]
        interval, cov_target = (p1, p2, p3)[phase - 1]
        self.generation_interval_seconds = interval
        self.opt.params.cov_retention_target = cov_target
        self.opt.params.cov_retention_step = step
        self.opt.cov_retention = min(self.opt.cov_retention, cov_target)
        self.level_weights = LEVEL_WEIGHTS_BY_PHASE[phase]

    def _session_uniforms(self):
        """The session's fixed dither draw (2, nsim, 2), drawn once from
        the learner's generator, and its copy on the device."""
        nsim = self.eval_blocks * K_FFT_LENGTH
        if self._uniforms is None or \
                self._uniforms.shape[:2] != (2, nsim):
            self._uniforms = self.rng.uniform(size=(2, nsim, 2))
            self._uniforms_dev = torch.from_numpy(self._uniforms).to(
                self.device)
        return self._uniforms

    def _windowed_score(self, err, thr):
        """Average evaluator cost over every 4096 window after the first
        (startup dropped); the plain single-window cost when
        eval_blocks == 1."""
        nb = self.eval_blocks
        if nb == 1:
            return self.evaluator.evaluate(err[0], err[1], thr)\
                .composite_score
        ew = err.reshape(2, nb, K_FFT_LENGTH)
        tot = 0.0
        for w in range(1, nb):
            tot += self.evaluator.evaluate(ew[0, w], ew[1, w], thr)\
                .composite_score
        return tot / float(nb - 1)

    def _population_inputs(self, audio_lr):
        """(blocks (L, 2, 4096): the captured block at each target level,
        sim_blocks (L, 2, eval_blocks x 4096): them repeated, the
        session's uniforms on the device broadcast to sim_blocks' shape +
        (2,))."""
        rms = np.sqrt(np.mean(audio_lr ** 2)) + 1e-12
        blocks = np.stack([audio_lr[:, :K_FFT_LENGTH] * (lvl / rms)
                           for lvl in TARGET_LEVELS])
        sim_blocks = np.tile(blocks, (1, 1, self.eval_blocks))
        self._session_uniforms()
        return blocks, sim_blocks, self._uniforms_dev.expand(
            sim_blocks.shape + (2,))

    def _population_scores(self, K, errs, blocks):
        """The candidates' costs from their errors (P, L, 2, N): the
        spectral evaluator on a pool of `workers` threads (the
        reference's evaluationWorkers analog)."""
        thresholds = [self.evaluator.signal_masking_thresholds(b[0], b[1])
                      for b in blocks]

        def score(p):
            # phase-weighted level mix (currentLevelWeights)
            tot = 0.0
            for li in range(len(TARGET_LEVELS)):
                tot += self.level_weights[li] * self._windowed_score(
                    errs[p, li], thresholds[li])
            return tot / float(np.sum(self.level_weights)) \
                * _ntf_penalty(K[p])

        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            return np.array(list(ex.map(score, range(len(K)))))

    def _population_costs(self, cands, audio_lr):
        """Score a whole population: one simulation call for every
        (candidate, level) pair on the device, then the evaluator on the
        host."""
        K = np.stack([CmaEs.to_parcor(c) for c in cands])
        blocks, sim_blocks, u = self._population_inputs(audio_lr)
        t0 = time.perf_counter()
        errs = simulate_shaper_error_population(sim_blocks, K,
                                                self.bit_depth, u,
                                                device=self.device)
        t1 = time.perf_counter()
        costs = self._population_scores(K, errs, blocks)
        self.sim_seconds += t1 - t0
        self.eval_seconds += time.perf_counter() - t1
        return costs

    def feed(self, audio_lr: np.ndarray, generations: int = 1):
        """Run CMA-ES generations on a captured stereo block (2, >=4096).

        Accumulated playback time drives the 3-phase schedule
        (exploration -> convergence -> fine-tune): phase transitions
        retune the optimizer's covariance-retention ramp, the generation
        pacing, and the target-level weighting."""
        audio_lr = np.asarray(audio_lr, np.float64)
        self.accumulated_seconds += audio_lr.shape[-1] / self.sample_rate
        self._apply_phase(compute_phase(self.mode, self.accumulated_seconds))
        for _ in range(generations):
            cands = self.opt.sample()
            fits = self._population_costs(cands, audio_lr)
            i = int(np.argmin(fits))
            if fits[i] < self.best_score:
                self.best_score = float(fits[i])
                self.best = CmaEs.to_parcor(cands[i])
            self.opt.update(cands, fits)
            self.generation += 1
        return self.state()

    def state(self) -> LearnedState:
        coeffs = self.best if self.best is not None \
            else np.zeros(NS_ORDER_LATTICE)
        return LearnedState(
            best_coefficients=np.asarray(coeffs),
            best_score=float(self.best_score),
            generations=self.generation,
            bank_index=coefficient_bank_index(self.sample_rate,
                                              self.bit_depth, self.mode))
