"""TPT (topology-preserving transform) state-variable filter
(counterpart of convopeq_tpu/ops/svf.py).

Coefficient formulas: src/eqprocessor/EQProcessor.Coefficients.cpp:431-607.
Host NumPy in f64, as in the JAX package: the reference computes them on
the message thread with libm.

The recurrence (EQProcessor.Processing.cpp:128-186) is linear in the
state (ic1eq, ic2eq): the saturation blend touches only the output and
never feeds back, so `svf_process` solves the state trajectory with
`affine_scan_2x2` and evaluates the output, the blend and the clamps
elementwise.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..utils.dsputil import device_constants
from .fast_tanh import fast_tanh_eq, fast_tanh_eq_v
from .scan_iir import _all_scalar, affine_scan_2x2

_TRANSITIONS: OrderedDict = OrderedDict()

# Band types (ref: src/eqprocessor/EQProcessor.h:43-62)
LOW_SHELF = 0
PEAKING = 1
HIGH_SHELF = 2
LOW_PASS = 3
HIGH_PASS = 4

# Parameter clamping (ref: EQProcessor.h:174-180, validateAndClampParameters)
DSP_MIN_FREQ = 20.0
DSP_MAX_FREQ = 20000.0
DSP_MAX_FREQ_NYQUIST_RATIO = 0.95
DSP_MIN_Q = 0.01
DSP_MAX_Q = 20.0
DSP_MIN_GAIN_DB = -48.0
DSP_MAX_GAIN_DB = 48.0

# Output protection (EQProcessor.Processing.cpp:156-180)
STATE_ABS_MAX = 1.0e15
OUTPUT_CLAMP = 100.0


def clamp_params(freq, gain_db, q, sample_rate):
    """validateAndClampParameters (EQProcessor.Coefficients.cpp:84-99).

    The reference's parameter plane is FLOAT32 (jlimit clamps in f32
    before widening to double), so the clamp runs in f32 here too."""
    f32 = np.float32
    nyquist = f32(np.asarray(sample_rate, np.float64) * 0.5)
    max_freq = np.minimum(f32(DSP_MAX_FREQ),
                          nyquist * f32(DSP_MAX_FREQ_NYQUIST_RATIO))
    freq = np.clip(np.asarray(freq, f32), f32(DSP_MIN_FREQ), max_freq)
    q = np.clip(np.asarray(q, f32), f32(DSP_MIN_Q), f32(DSP_MAX_Q))
    gain_db = np.clip(np.asarray(gain_db, f32), f32(DSP_MIN_GAIN_DB),
                      f32(DSP_MAX_GAIN_DB))
    return (freq.astype(np.float64), gain_db.astype(np.float64),
            q.astype(np.float64))


def svf_coeffs(band_type, freq, gain_db, q, sample_rate):
    """Vectorized SVF coefficients for all five band types (host NumPy).

    Args broadcast together; `band_type` selects the type per element.
    Returns (a1, a2, a3, m0, m1, m2) float64 arrays.

      LowShelf  (:431): A=10^(dB/40), g=tan(pi f/sr)/sqrt(A), k=1/Q,
                        m0=1, m1=k(A-1), m2=A^2-1
      Peaking   (:470): g=tan(pi f/sr), k=1/(Q A), m0=1, m1=(A-1/A)/Q, m2=0
      HighShelf (:508): g=tan(pi f/sr)*sqrt(A), k=1/Q,
                        m0=A^2, m1=k(1-A)A, m2=1-A^2
      LowPass   (:541): g=tan(pi f/sr), k=1/Q, m0=0, m1=0, m2=1
      HighPass  (:573): g=tan(pi f/sr), k=1/Q, m0=1, m1=-k, m2=-1
      all: a1 = 1/(1 + g(g+k)), a2 = g a1, a3 = g a2
    """
    band_type = np.asarray(band_type)
    freq = np.asarray(freq, np.float64)
    gain_db = np.asarray(gain_db, np.float64)
    q = np.asarray(q, np.float64)
    freq, gain_db, q = clamp_params(freq, gain_db, q, sample_rate)
    band_type, freq, gain_db, q = np.broadcast_arrays(band_type, freq,
                                                      gain_db, q)

    A = np.power(10.0, gain_db / 40.0)
    sqrtA = np.sqrt(A)
    g_base = np.tan(np.pi * freq / sample_rate)

    g = np.where(band_type == LOW_SHELF, g_base / sqrtA,
        np.where(band_type == HIGH_SHELF, g_base * sqrtA, g_base))
    k = np.where(band_type == PEAKING, 1.0 / (q * A), 1.0 / q)

    denom = 1.0 + g * (g + k)
    a1 = 1.0 / denom
    a2 = g * a1
    a3 = g * a2

    m0 = np.where(band_type == LOW_PASS, 0.0,
         np.where(band_type == HIGH_SHELF, A * A, 1.0))
    m1 = np.where(band_type == LOW_SHELF, k * (A - 1.0),
         np.where(band_type == PEAKING, (A - 1.0 / A) / q,
         np.where(band_type == HIGH_SHELF, k * (1.0 - A) * A,
         np.where(band_type == HIGH_PASS, -k, 0.0))))
    m2 = np.where(band_type == LOW_SHELF, A * A - 1.0,
         np.where(band_type == HIGH_SHELF, 1.0 - A * A,
         np.where(band_type == LOW_PASS, 1.0,
         np.where(band_type == HIGH_PASS, -1.0, 0.0))))

    # Division-by-zero / non-finite protection -> bypass coefficients
    bad = (~np.isfinite(g)) | (~np.isfinite(k)) | (np.abs(denom) < 1.0e-15)
    a1 = np.where(bad, 1.0, a1)
    a2 = np.where(bad, 0.0, a2)
    a3 = np.where(bad, 0.0, a3)
    m0 = np.where(bad, 1.0, m0)
    m1 = np.where(bad, 0.0, m1)
    m2 = np.where(bad, 0.0, m2)
    return a1, a2, a3, m0, m1, m2


def svf_transition(a1, a2, a3):
    """2x2 state-transition matrix of the TPT SVF recurrence, (..., 2, 2)
    for tensor coefficients of shape (...):

    ic1' = (2 a1 - 1) ic1 - 2 a2 ic2 + 2 a2 u
    ic2' =  2 a2 ic1 + (1 - 2 a3) ic2 + 2 a3 u
    """
    row0 = torch.stack([2.0 * a1 - 1.0, -2.0 * a2], dim=-1)
    row1 = torch.stack([2.0 * a2, 1.0 - 2.0 * a3], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def svf_process(x, coeffs, state0=None, saturation=0.0, simd_tanh=True):
    """Apply one SVF band to x (time on the last axis, leading axes batch).

    coeffs: (a1, a2, a3, m0, m1, m2), host scalars (one shared transition)
    or tensors broadcastable to x.shape[:-1].  Returns (y, final_state).
    Output: (1-sat) y + sat fastTanh(y) when sat > 0, non-finite or
    |y| >= STATE_ABS_MAX forced to 0, clamped to +-OUTPUT_CLAMP.
    simd_tanh: the stereo SSE2 form (clamp then evaluate, True) or the
    scalar exact-+-1 form (False), or a per-batch-element mask of x's
    batch shape."""
    dt, dev = x.dtype, x.device
    batch = x.shape[:-1]
    if _all_scalar(coeffs):
        a1, a2, a3, m0, m1, m2 = (float(c) for c in coeffs)
        # made on the host in dt (the same roundings as on the card) and
        # copied to the device once: see ops/scan_iir.py
        A, = device_constants(
            _TRANSITIONS, (a1, a2, a3),
            lambda: (svf_transition(*(torch.tensor(c, dtype=dt)
                                      for c in (a1, a2, a3))),), dt, dev)
        key = ("svf", a1, a2, a3)
    else:
        a1, a2, a3, m0, m1, m2 = (
            torch.as_tensor(c, dtype=dt, device=dev).expand(batch)
            .unsqueeze(-1) for c in coeffs)
        A = svf_transition(a1[..., 0], a2[..., 0], a3[..., 0])
        key = None
    bu = torch.stack([2.0 * a2 * x, 2.0 * a3 * x], dim=-1)
    if state0 is None:
        state0 = torch.zeros(batch + (2,), dtype=dt, device=dev)
    pre, final = affine_scan_2x2(A, bu, state0, key=key)
    ic1 = pre[..., 0]
    ic2 = pre[..., 1]
    v3 = x - ic2
    v1 = a1 * ic1 + a2 * v3
    v2 = ic2 + a2 * ic1 + a3 * v3
    y = m0 * x + m1 * v1 + m2 * v2
    sat = float(saturation)
    if sat > 0.0:
        if isinstance(simd_tanh, bool):
            tanh_y = fast_tanh_eq_v(y) if simd_tanh else fast_tanh_eq(y)
        else:
            mask = torch.as_tensor(simd_tanh, device=dev).expand(batch)
            tanh_y = torch.where(mask.unsqueeze(-1), fast_tanh_eq_v(y),
                                 fast_tanh_eq(y))
        y = y * (1.0 - sat) + tanh_y * sat
    y = torch.where(torch.isfinite(y) & (y.abs() < STATE_ABS_MAX), y, 0.0)
    return y.clamp(-OUTPUT_CLAMP, OUTPUT_CLAMP), final
