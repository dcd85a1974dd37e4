"""The plain error-feedback quantizer with the lattice noise shaper
(LatticeNoiseShaper.h:229-295, the "fir" ladder: each stage stores the
previous stage's backward output), NumPy over rows, a loop over time,
every operation in the signal's own type and in the reference's order
(no fused multiply-add), so that in f32 it is the quantizer the
configuration states to the last bit.

y = x h + sum_i c_i st_i (summed in order), q = round((clamp(y, -1,
1 - s) + d) / s) s clamped to [-1, 1 - s], with d = ((u0 + u1) - 1) s
the TPDF term and s = 2^-(bits - 1); the error clamp(q - y, +-2 s)
drives the ladder, each state clamped to +-2.
"""
from __future__ import annotations

import numpy as np

COEFF_LIMIT = 0.85
STATE_LIMIT = 2.0


def lattice_quantize(x, u, k, bits: int, headroom: float) -> np.ndarray:
    """x (R, N), u (R, N, 2) in [0, 1), k (9,) reflection coefficients
    (clamped to +-0.85 here) -> q (R, N) in x's type, from zero state."""
    x = np.asarray(x)
    T = x.dtype.type
    c = [T(v) for v in np.clip(np.nan_to_num(np.asarray(k, np.float64)),
                               -COEFF_LIMIT, COEFF_LIMIT)]
    order = len(c)
    s = T(1.0 / 2.0 ** (bits - 1))
    inv, hi, lim = T(1.0) / s, T(1.0) - s, T(2.0) * s
    xh = x * T(headroom)
    d = ((u[..., 0].astype(T) + u[..., 1].astype(T)) - T(1.0)) * s
    R, N = xh.shape
    st = [np.zeros(R, T) for _ in range(order)]
    q = np.empty((R, N), T)
    for t in range(N):
        fb = c[0] * st[0]
        for i in range(1, order):
            fb = fb + c[i] * st[i]
        y = xh[:, t] + fb
        qt = np.clip(np.round((np.clip(y, T(-1.0), hi) + d[:, t]) * inv)
                     * s, T(-1.0), hi)
        q[:, t] = qt
        fwd = g = np.clip(qt - y, -lim, lim)
        for i in range(order):
            old = st[i]
            st[i] = np.clip(g, T(-STATE_LIMIT), T(STATE_LIMIT))
            if i + 1 < order:
                g = c[i] * fwd + old
                fwd = fwd + c[i] * old
    return q
