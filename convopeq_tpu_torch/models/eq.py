"""20-band parametric EQ, host part (counterpart of
convopeq_tpu/models/eq.py:37-277): parameters, the band-activity rule,
the 2x2 band-matrix response and the ring-tail length that the folded
chain bakes into the IR.  Host NumPy f64.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import svf as svf_ops
from ..ops.svf import svf_coeffs

NUM_BANDS = 20
# Channel modes (EQProcessor.h: enum class EQChannelMode)
STEREO, LEFT, RIGHT, MID, SIDE = 0, 1, 2, 3, 4
# Structures (EQProcessor.h: enum class FilterStructure)
SERIAL, PARALLEL = 0, 1

# Default band frequencies (EQProcessor.h:158-163)
DEFAULT_FREQS = np.array([
    25.0, 40.0, 63.0, 100.0, 160.0,
    250.0, 400.0, 630.0, 1000.0, 1600.0,
    2500.0, 4000.0, 6300.0, 10000.0, 11000.0,
    12500.0, 14000.0, 16500.0, 18000.0, 19500.0,
])
DEFAULT_Q = 0.707


@dataclass
class EQParams:
    """Full EQ parameter set (mirrors the reference EQState snapshot)."""
    band_types: np.ndarray = field(
        default_factory=lambda: np.full(NUM_BANDS, svf_ops.PEAKING, np.int32))
    freqs: np.ndarray = field(default_factory=lambda: DEFAULT_FREQS.copy())
    gains_db: np.ndarray = field(default_factory=lambda: np.zeros(NUM_BANDS))
    qs: np.ndarray = field(default_factory=lambda: np.full(NUM_BANDS, DEFAULT_Q))
    modes: np.ndarray = field(default_factory=lambda: np.zeros(NUM_BANDS, np.int32))
    enabled: np.ndarray = field(default_factory=lambda: np.ones(NUM_BANDS, bool))
    structure: int = SERIAL
    saturation: float = 0.0
    agc_enabled: bool = False

    def set_band(self, i, band_type=None, freq=None, gain_db=None, q=None,
                 mode=None, enabled=None):
        if band_type is not None:
            self.band_types[i] = band_type
        if freq is not None:
            self.freqs[i] = freq
        if gain_db is not None:
            self.gains_db[i] = gain_db
        if q is not None:
            self.qs[i] = q
        if mode is not None:
            self.modes[i] = mode
        if enabled is not None:
            self.enabled[i] = enabled
        return self


def band_active_mask(params: EQParams) -> np.ndarray:
    """createBandNode activity rule (EQProcessor.Coefficients.cpp:35-53).

    The gain skip compares the float32 band gain against 0.01f.
    """
    types = np.asarray(params.band_types)
    gains_f32 = np.abs(np.asarray(params.gains_db, np.float32))
    not_passband = (types != svf_ops.LOW_PASS) & (types != svf_ops.HIGH_PASS)
    tiny_gain = gains_f32 < np.float32(0.01)
    return np.asarray(params.enabled, bool) & ~(not_passband & tiny_gain)


def _band_matrix_response(params: EQParams, sample_rate, freqs):
    """2x2 complex MIMO response of the active bands at `freqs` (host f64).

    Every channel mode is a 2x2 LTI map on (L, R):
      Stereo: diag(H, H); Left: diag(H, 1); Right: diag(1, H);
      Mid:  [[(H+1)/2, (H-1)/2], [(H-1)/2, (H+1)/2]]
      Side: [[(H+1)/2, (1-H)/2], [(1-H)/2, (H+1)/2]]
    Serial structure = ordered matrix product; Parallel = I + sum(T_b - I).
    Returns (h11, h12, h21, h22) complex128 arrays.
    """
    from ..engine.eq_analysis import svf_to_biquad, biquad_response
    active = band_active_mask(params)
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    nf = len(freqs)
    eye = (np.ones(nf, complex), np.zeros(nf, complex),
           np.zeros(nf, complex), np.ones(nf, complex))

    def band_T(b):
        bq = svf_to_biquad(*(float(c[b]) for c in coeffs))
        H = biquad_response(bq, freqs, sample_rate)
        mode = int(params.modes[b])
        one = np.ones(nf, complex)
        if mode == STEREO:
            return (H, 0 * H, 0 * H, H)
        if mode == LEFT:
            return (H, 0 * H, 0 * H, one)
        if mode == RIGHT:
            return (one, 0 * H, 0 * H, H)
        if mode == MID:
            return ((H + 1) / 2, (H - 1) / 2, (H - 1) / 2, (H + 1) / 2)
        return ((H + 1) / 2, (1 - H) / 2, (1 - H) / 2, (H + 1) / 2)  # SIDE

    def mat_mul(a, b):
        a11, a12, a21, a22 = a
        b11, b12, b21, b22 = b
        return (a11 * b11 + a12 * b21, a11 * b12 + a12 * b22,
                a21 * b11 + a22 * b21, a21 * b12 + a22 * b22)

    if params.structure == SERIAL:
        T = eye
        for b in range(NUM_BANDS):
            if active[b]:
                T = mat_mul(band_T(b), T)   # band applied after T
        return T
    acc = [np.zeros(nf, complex) for _ in range(4)]
    for b in range(NUM_BANDS):
        if not active[b]:
            continue
        Tb = band_T(b)
        for i in range(4):
            acc[i] = acc[i] + (Tb[i] - eye[i])
    return tuple(eye[i] + acc[i] for i in range(4))


def _eq_ring_tail_samples(params: EQParams, sample_rate, eps=1e-10):
    """Padding needed so truncated IIR ringing is below eps: from the max
    pole radius of the active bands (host-side, static)."""
    active = band_active_mask(params)
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    max_r = 0.0
    for b in range(NUM_BANDS):
        if not active[b]:
            continue
        A = np.array([[2 * coeffs[0][b] - 1.0, -2 * coeffs[1][b]],
                      [2 * coeffs[1][b], 1.0 - 2 * coeffs[2][b]]])
        r = float(np.max(np.abs(np.linalg.eigvals(A))))
        max_r = max(max_r, min(r, 1.0 - 1e-12))
    if max_r <= 0.0:
        return 0
    return int(np.ceil(np.log(eps) / np.log(max_r)))
