"""The plain psychoacoustic dither quantizer (PsychoacousticDither.h:280+,
dispatched by DSPCoreDouble.cpp:644-653): 12th-order error feedback
with the TPDF term added before the rounding, NumPy over rows, a loop
over time, every operation in the signal's own type and in ConvoPeq's
order (no fused multiply-add), so that in f32 it is the quantizer the
configuration states to the last bit.

  tmp = (x h + d) + sum_i c_i e_i     (summed in order, c_0 first)
  q   = round(tmp / s) s              (half to even)
  e  <- [tmp - q, e_0, ..., e_10]

with d = ((u0 - 1/2) + (u1 - 1/2)) s, s = 2^-(bits - 1) and h the output
headroom.  There is no clamp: the error is bounded by s / 2.
"""
from __future__ import annotations

import numpy as np


def psycho_quantize(x, u, coeffs, bits: int, headroom: float) -> np.ndarray:
    """x (R, N), u (R, N, 2) in [0, 1), coeffs (12,) -> q (R, N) in x's
    type, from zero state."""
    x = np.asarray(x)
    T = x.dtype.type
    c = [T(v) for v in coeffs]
    s = T(1.0 / 2.0 ** (bits - 1))
    half = T(0.5)
    xh = x * T(headroom)
    d = ((u[..., 0].astype(T) - half) + (u[..., 1].astype(T) - half)) * s
    R, N = xh.shape
    e = [np.zeros(R, T) for _ in c]
    q = np.empty((R, N), T)
    for t in range(N):
        fb = c[0] * e[0]
        for i in range(1, len(c)):
            fb = fb + c[i] * e[i]
        tmp = (xh[:, t] + d[:, t]) + fb
        qt = np.round(tmp / s) * s
        q[:, t] = qt
        e = [tmp - qt] + e[:-1]
    return q
