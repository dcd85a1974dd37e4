"""Kaiser-halfband oversampling, host part (counterpart of
convopeq_tpu/ops/oversample.py:32-107; src/CustomInputOversampler.cpp).

Ported here: the coefficient design only (`bessel_i0`, `HalfbandStage`,
`design_halfband`), host NumPy f64, which the local 2x soft clip
(ops/softclip.py) takes its 31-tap stage from.  The oversampling signal
path is not ported yet.

Design (cpp:287-352): odd symmetric taps, the zero-phase arm zeroed (a
true halfband), DC normalization, the center coefficient forced to 0.5
and the non-center arm rescaled to sum 0.5.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Preset (src/CustomInputOversampler.h Preset enum: IIRLike, LinearPhase)
PRESET_IIR_LIKE = 0
PRESET_LINEAR_PHASE = 1

_TAPS = {PRESET_IIR_LIKE: (511, 127, 31), PRESET_LINEAR_PHASE: (1023, 255, 63)}
_ATTEN = {PRESET_IIR_LIKE: (140.0, 110.0, 90.0),
          PRESET_LINEAR_PHASE: (160.0, 140.0, 120.0)}


def bessel_i0(x):
    """Series I0 matching the reference's besselI0 (cpp:144-157)."""
    x = np.asarray(x, np.float64)
    s = np.ones_like(x)
    term = np.ones_like(x)
    xx = x * x
    for n in range(1, 100):
        term = term * xx / (4.0 * n * n)
        s = s + term
        if np.all(term < s * 1e-18):
            break
    return s


@dataclass
class HalfbandStage:
    taps: int
    center_tap: int          # M
    center_parity: int       # M & 1 (always 1 for the preset tap counts)
    conv_parity: int         # 1 - center_parity
    conv: np.ndarray         # non-zero arm coefficients conv[r] = h[convParity+2r]
    center_delay: int        # (M - center_parity) / 2, in input samples
    center_gain: float       # 0.5 (reference) or 1.0 (unity variant)


def design_halfband(taps: int, attenuation_db: float,
                    center_phase_gain: str = "reference") -> HalfbandStage:
    """prepareStage coefficient design (cpp:287-372), host NumPy."""
    taps = max(3, taps | 1)
    M = (taps - 1) // 2
    center_parity = M & 1
    conv_parity = 1 - center_parity

    a = attenuation_db
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    i0b = float(bessel_i0(beta))

    n = np.arange(taps)
    t = (n - M).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(t == 0.0, 0.5, np.sin(np.pi * 0.5 * t) / (np.pi * t))
    frac = t / M
    win = bessel_i0(beta * np.sqrt(np.maximum(0.0, 1.0 - frac * frac))) / i0b
    h = sinc * win
    h = np.where((n != M) & ((n & 1) == center_parity), 0.0, h)
    s = h.sum()
    if abs(s) > 1e-20:
        h = h / s
    h[M] = 0.5
    nc = h.sum() - h[M]
    if abs(nc) > 1e-20:
        h = np.where(n != M, h * (0.5 / nc), h)
    h[M] = 0.5

    conv_count = (taps - conv_parity + 1) // 2
    idx = conv_parity + 2 * np.arange(conv_count)
    conv = np.where(idx < taps, h[np.minimum(idx, taps - 1)], 0.0)
    center_gain = 0.5 if center_phase_gain == "reference" else 1.0
    return HalfbandStage(taps=taps, center_tap=M, center_parity=center_parity,
                         conv_parity=conv_parity, conv=conv,
                         center_delay=(M - center_parity) // 2,
                         center_gain=center_gain)
