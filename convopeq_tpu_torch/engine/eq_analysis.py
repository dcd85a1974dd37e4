"""EQ response helpers (counterpart of convopeq_tpu/engine/eq_analysis.py:22-45).

svf_to_biquad: exact transcription of svfToDisplayBiquad
(EQProcessor.Coefficients.cpp:404-425).  Host NumPy f64.
"""
from __future__ import annotations

import numpy as np


def svf_to_biquad(a1, a2, a3, m0, m1, m2):
    """(b0,b1,b2,a0,a1,a2) in RBJ ordering, unnormalized."""
    if a1 < 1e-15:
        return (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    g2 = a3 / a1
    g = a2 / a1
    gk = (1.0 - a1 - a3) / a1
    A0 = 1.0 + gk + g2
    A1 = -2.0 + 2.0 * g2
    A2 = 1.0 - gk + g2
    b0 = m0 * (1.0 + gk + g2) + m1 * g + m2 * g2
    b1 = -2.0 * m0 + 2.0 * (m0 + m2) * g2
    b2 = m0 * (1.0 - gk + g2) - m1 * g + m2 * g2
    return (b0, b1, b2, A0, A1, A2)


def biquad_response(coeffs, freqs, sample_rate):
    """Complex response of an (unnormalized) biquad at freqs (Hz)."""
    b0, b1, b2, a0, a1, a2 = coeffs
    z = np.exp(1j * 2.0 * np.pi * np.asarray(freqs) / sample_rate)
    z2 = z * z
    num = b0 * z2 + b1 * z + b2
    den = a0 * z2 + a1 * z + a2
    return np.where(np.abs(den) > 1e-18,
                    num / np.where(np.abs(den) > 1e-18, den, 1.0), 0.0)
