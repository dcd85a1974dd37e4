"""High-quality IR resampling, the r8brain-equivalent stage (counterpart
of convopeq_tpu/ir/resample.py; host NumPy f64).

Spec parity with the reference's usage (src/IRDSP.h:7-13, src/IRDSP.cpp):
transition band 2.0 (percent of input bandwidth), 140 dB stop-band
attenuation, linear phase.  The implementation is an independent
Kaiser-windowed-sinc rational polyphase resampler meeting the same spec
(not a port of r8brain): for conversion L/M the prototype low-pass cuts at
min(in, out)/2 with a transition band of `trans_band`% of the input
bandwidth, Kaiser beta and length from the standard attenuation formulas.
"""
from __future__ import annotations

from math import gcd

import numpy as np

from ..ops.oversample import bessel_i0


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def design_resample_filter(L: int, M: int, trans_band_pct: float = 2.0,
                           atten_db: float = 140.0) -> np.ndarray:
    """Prototype FIR at the upsampled rate L*fs_in, DC gain L."""
    # cutoff at the narrower Nyquist, in units of the upsampled rate
    fc = 0.5 * min(1.0, L / M) / L           # cycles/sample at rate L*fs_in
    # transition width: trans_band% of the input bandwidth (fs_in/2)
    tw = (trans_band_pct / 100.0) * 0.5 / L
    fc_center = fc - tw / 2.0                # place stopband edge at fc
    beta = _kaiser_beta(atten_db)
    ntaps = int(np.ceil((atten_db - 7.95) / (2.285 * 2.0 * np.pi * tw)))
    ntaps |= 1                                # odd, linear phase
    mth = (ntaps - 1) / 2.0
    nn = np.arange(ntaps) - mth
    h = 2.0 * fc_center * np.sinc(2.0 * fc_center * nn)
    frac = nn / mth
    win = bessel_i0(beta * np.sqrt(np.maximum(0.0, 1.0 - frac * frac))) \
        / bessel_i0(beta)
    h = h * win
    # normalize DC gain to L (compensates zero-stuffing)
    return h * (L / h.sum())


def resample_ir(ir: np.ndarray, input_sr: float, target_sr: float,
                trans_band_pct: float = 2.0, atten_db: float = 140.0,
                max_denominator: int = 1000) -> np.ndarray:
    """resampleIR equivalent (src/IRDSP.cpp:1-142).  ir: (..., N).

    Output length = ceil(N * target/input) (r8brain produces the full
    resampled stream; the loader trims afterwards).

    True rational polyphase: only the L needed filter phases are evaluated
    (never the zero-stuffed stream).  Grouping outputs by phase turns the
    whole conversion into ONE (Q, K) @ (K, L) GEMM over stride-M input
    frames — 44.1k<->48k on a 1M-tap stereo IR is ~4e9 f64 MACs, seconds
    on host BLAS (the previous zero-stuffed np.convolve form was O(N*L*T),
    ~1e12 MACs at this size).
    """
    ir = np.asarray(ir, np.float64)
    if input_sr == target_sr:
        return ir.copy()
    from fractions import Fraction
    frac = Fraction(target_sr / input_sr).limit_denominator(max_denominator)
    L, M = frac.numerator, frac.denominator
    g = gcd(L, M)
    L //= g
    M //= g

    h = design_resample_filter(L, M, trans_band_pct, atten_db)
    n = ir.shape[-1]
    out_len = int(np.ceil(n * target_sr / input_sr))
    delay = (len(h) - 1) // 2                 # linear-phase group delay
    T = len(h)

    # Aligned decimated output: y[j] = (x_up * h)[j*M + delay] where
    # x_up is x zero-stuffed by L.  Only indices j*M + delay - k that are
    # multiples of L survive; writing j = q*L + p gives, per phase p:
    #   y[q*L + p] = sum_r hp[p, r] * x[q*M + d_p - r]
    #   with phase filter hp[p, r] = h[r*L + (p*M + delay) mod L]
    #   and input offset  d_p = floor((p*M + delay) / L).
    Tp = -(-T // L)                           # taps per phase
    ph = (np.arange(L) * M + delay) % L
    d = (np.arange(L) * M + delay) // L
    hp = np.zeros((L, Tp))
    r = np.arange(Tp)
    idx = r[None, :] * L + ph[:, None]        # (L, Tp) prototype indices
    valid = idx < T
    hp[valid] = h[np.clip(idx, 0, T - 1)][valid]

    # One GEMM: F[q, c] = xpad[q*M + c]; G[p, c0 + d_p - r] = hp[p, r].
    dmin = int(d.min())
    c0 = (Tp - 1) - dmin                      # left zero-padding of x
    K = Tp + int(d.max()) - dmin              # frame width
    Q = -(-out_len // L)                      # output blocks of L phases
    G = np.zeros((K, L))
    cols = c0 + d[:, None] - r[None, :]       # (L, Tp)
    G[cols.ravel(), np.repeat(np.arange(L), Tp)] = hp.ravel()

    flat = ir.reshape(-1, n)
    need = (Q - 1) * M + K                    # padded length the frames read
    xpad = np.zeros((flat.shape[0], max(need, c0 + n)))
    xpad[:, c0:c0 + n] = flat
    from numpy.lib.stride_tricks import as_strided
    s = xpad.strides
    F = as_strided(xpad, shape=(flat.shape[0], Q, K),
                   strides=(s[0], M * s[1], s[1]))
    Y = np.ascontiguousarray(F.reshape(-1, K)) @ G     # (B*Q, L)
    outs = Y.reshape(flat.shape[0], Q * L)[:, :out_len]
    return outs.reshape(ir.shape[:-1] + (out_len,))
