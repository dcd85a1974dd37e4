"""Cascaded one-pole DC blockers (counterpart of
convopeq_tpu/ops/dc_blocker.py; src/UltraHighRateDCBlocker.h).

Two first-order high-pass sections in series with cutoffs spread +-10%:
  alpha_i = 1 - exp(-2 pi fc (1 -+ 0.1) / sr)        (init, :78-115)
  per sample: s_i' = s_i + alpha_i (x_i - s_i);  y_i = x_i - s_i'
(the output uses the UPDATED state, :127-150).  Linear in (s0, s1):
  s0' = (1-a0) s0 + a0 x
  s1' = -a1(1-a0) s0 + (1-a1) s1 + a1(1-a0) x
  y   = (1-a1)( (1-a0)(x - s0) - s1 )

`dc_block` runs the pair as one DC section of ops/iir_cascade.py: on the
CPU the JAX package's direct-Toeplitz form (`dc_block_toeplitz`), on the
card one launch of the IIR cascade kernel; inside `dispatch.plain()`,
the cascade's FFT form on any device (the plain path's reference).
"""
from __future__ import annotations

import numpy as np
import torch

from .iir_cascade import dc_section, iir_cascade

INTERNAL_SPREAD = 0.1


def dc_blocker_alphas(sample_rate: float, cutoff_hz: float):
    """init() coefficients (host libm, exact)."""
    alphas = []
    for ratio in (1.0 - INTERNAL_SPREAD, 1.0 + INTERNAL_SPREAD):
        omega = 2.0 * np.pi * cutoff_hz * ratio / sample_rate
        a = -np.expm1(-omega)
        if not np.isfinite(a) or a <= 0.0 or a >= 1.0:
            a = 1.0e-6
        alphas.append(float(a))
    return alphas


def dc_block(x, sample_rate: float, cutoff_hz: float, state0=None):
    """Apply the 2-stage DC blocker along the last axis of x (..., N).
    Returns (y, final_state) with state = (s0, s1), (..., 2); inside
    `dispatch.plain()` from zero state, final_state None."""
    a0, a1 = dc_blocker_alphas(sample_rate, cutoff_hz)
    s0 = None if state0 is None else torch.as_tensor(state0).unsqueeze(-2)
    y, final = iir_cascade(x, (dc_section(a0, a1),), s0)
    return y, None if final is None else final[..., 0, :]
