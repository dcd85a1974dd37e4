"""Biquad pole radius (counterpart of convopeq_tpu/ops/scan_iir.py:59)."""
from __future__ import annotations

import numpy as np


def _biquad_pole_radius(a1: float, a2: float) -> float:
    """Largest pole magnitude of z^2 + a1 z + a2."""
    disc = a1 * a1 - 4.0 * a2
    if disc < 0.0:
        return float(np.sqrt(max(a2, 0.0)))
    s = np.sqrt(disc)
    return float(max(abs((-a1 + s) / 2.0), abs((-a1 - s) / 2.0)))
