"""Kaiser-halfband oversampling, host part (counterpart of
convopeq_tpu/ops/oversample.py:32-107; src/CustomInputOversampler.cpp).

Ported here: the coefficient design (`bessel_i0`, `HalfbandStage`,
`design_halfband`), host NumPy f64, which the local 2x soft clip
(ops/softclip.py) takes its 31-tap stage from, and the banded-Toeplitz
causal FIR `_fir_matmul` (the f32 low-radius biquads of
ops/scan_iir.py).  The oversampling signal path is not ported yet.

Design (cpp:287-352): odd symmetric taps, the zero-phase arm zeroed (a
true halfband), DC normalization, the center coefficient forced to 0.5
and the non-center arm rescaled to sum 0.5.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


def _fir_matmul(x, c):
    """Causal FIR y[n] = sum_k c[k] x[n-k] along the last axis of x, as
    blocked banded-Toeplitz GEMMs (convopeq_tpu/ops/oversample.py:
    156-186): with chunk >= len(c) the band spans at most two adjacent
    chunks, so y = X @ T0^T + Xprev @ T1^T with two host-constant
    (chunk, chunk) matrices,
    T0[i, j] = c[i-j] (the in-chunk band) and T1[i, j] = c[i-j+chunk]
    (the spill from the previous chunk).  c: host taps (float64)."""
    c = np.asarray(c, np.float64)
    r = len(c)
    n = x.shape[-1]
    batch = x.shape[:-1]
    chunk = 1 << int(np.ceil(np.log2(max(r, 128))))
    nc = -(-n // chunk)
    npad = nc * chunk
    xp = torch.nn.functional.pad(x, (0, npad - n)) if npad != n else x
    xr = xp.reshape((-1, nc, chunk))
    xprev = torch.nn.functional.pad(xr[:, :-1, :], (0, 0, 1, 0))
    d = np.subtract.outer(np.arange(chunk), np.arange(chunk))
    T0 = np.where((d >= 0) & (d < r), c[np.clip(d, 0, r - 1)], 0.0)
    dp = d + chunk
    T1 = np.where(dp < r, c[np.clip(dp, 0, r - 1)], 0.0)
    as_t = lambda T: torch.as_tensor(T.T.copy(), dtype=x.dtype,
                                     device=x.device)
    y = xr @ as_t(T0) + xprev @ as_t(T1)
    return y.reshape(batch + (npad,))[..., :n]
