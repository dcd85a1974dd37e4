"""Cascaded one-pole DC blockers, coefficients only (counterpart of
convopeq_tpu/ops/dc_blocker.py:22-34; src/UltraHighRateDCBlocker.h).

  alpha_i = 1 - exp(-2 pi fc (1 -+ 0.1) / sr)        (init, :78-115)
"""
from __future__ import annotations

import numpy as np

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
