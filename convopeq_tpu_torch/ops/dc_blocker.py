"""Cascaded one-pole DC blockers (counterpart of
convopeq_tpu/ops/dc_blocker.py; src/UltraHighRateDCBlocker.h).

Two first-order high-pass sections in series with cutoffs spread +-10%:
  alpha_i = 1 - exp(-2 pi fc (1 -+ 0.1) / sr)        (init, :78-115)
  per sample: s_i' = s_i + alpha_i (x_i - s_i);  y_i = x_i - s_i'
(the output uses the UPDATED state, :127-150).  Linear in (s0, s1):
  s0' = (1-a0) s0 + a0 x
  s1' = -a1(1-a0) s0 + (1-a1) s1 + a1(1-a0) x
  y   = (1-a1)( (1-a0)(x - s0) - s1 )

`dc_block` is the direct-Toeplitz form of the JAX package (`_dc_kernels`
and the signal path of `dc_block`, :41-170): per state component one
strictly-lower Toeplitz matmul on the input chunks, the chunk-boundary
states through `affine_scan_2x2`, then the output combination.  The
Toeplitz products are `torch.matmul` in the signal's type (TF32 off on
the card), their operands built on the host and copied to the device
once.  Its TPU-only f64 emulation (`_dc_block_dd`) is not ported:
the card runs native f64 through this same path.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..utils.dsputil import device_constants
from .scan_iir import affine_scan_2x2

INTERNAL_SPREAD = 0.1
DC_CHUNK = 128

_DC_CONSTANTS: OrderedDict = OrderedDict()


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


def _dc_kernels(a0: float, a1: float, chunk: int):
    """Host-f64 direct-Toeplitz operands for the 2-state recurrence.

    With drive u x[j] (u = [a0, a1 b0]) the in-chunk solution is
        s_pre[i] = A^i s_b + sum_{j<i} w[i-1-j] x[j],   w[k] = A^k u,
    per state component one strictly-lower Toeplitz matmul on x itself;
    row `chunk` of each Toeplitz carries the chunk-boundary drive.
    Returns (P = [A^0..A^chunk] (chunk+1, 2, 2), T0, T1 (chunk,
    chunk+1))."""
    b0, b1 = 1.0 - a0, 1.0 - a1
    A = np.array([[b0, 0.0], [-a1 * b0, b1]], np.float64)
    u = np.array([a0, a1 * b0], np.float64)
    P = np.empty((chunk + 1, 2, 2))
    P[0] = np.eye(2)
    for k in range(chunk):
        P[k + 1] = A @ P[k]
    w = P[:chunk] @ u                           # (chunk, 2)
    idx = np.subtract.outer(np.arange(chunk + 1), np.arange(chunk)) - 1
    T = np.where(idx[..., None] >= 0,
                 w[np.clip(idx, 0, chunk - 1)], 0.0)   # (chunk+1, chunk, 2)
    return P, T[..., 0].T.copy(), T[..., 1].T.copy()


def dc_block(x, sample_rate: float, cutoff_hz: float, state0=None):
    """Apply the 2-stage DC blocker along the last axis of x (..., N).
    Returns (y, final_state) with state = (s0, s1), (..., 2)."""
    dt, dev = x.dtype, x.device
    a0, a1 = dc_blocker_alphas(sample_rate, cutoff_hz)
    b0, b1 = 1.0 - a0, 1.0 - a1
    n = x.shape[-1]
    batch = x.shape[:-1]
    if state0 is None:
        state0 = torch.zeros(batch + (2,), dtype=dt, device=dev)
    chunk = min(DC_CHUNK, n)
    nc = -(-n // chunk)
    npad = nc * chunk
    xp = torch.nn.functional.pad(x, (0, npad - n)) if npad != n else x
    xr = xp.reshape(batch + (nc, chunk))
    Pt, T0, T1 = device_constants(_DC_CONSTANTS, (a0, a1, chunk),
                                  lambda: _dc_kernels(a0, a1, chunk), dt,
                                  dev)
    d0 = xr @ T0
    d1 = xr @ T1
    # chunk-boundary states: s_{b+1} = A^chunk s_b + drive_end[b]
    dend = torch.stack([d0[..., chunk], d1[..., chunk]], dim=-1)
    sb, s_after = affine_scan_2x2(Pt[chunk], dend, state0)  # (..., nc, 2)
    # y[i] = b1 (b0 (x - s0_pre) - s1_pre), s_pre = A^i s_b + drive[i]
    s0p = sb @ Pt[:chunk, 0, :].T + d0[..., :chunk]
    s1p = sb @ Pt[:chunk, 1, :].T + d1[..., :chunk]
    y = b1 * (b0 * (xr - s0p) - s1p)
    y = y.reshape(batch + (npad,))[..., :n]
    if npad == n:
        return y, s_after
    # the true final state is the state at offset k of the LAST chunk
    # (the padded boundary recursion ran over zeros): A^k s_b + drive[k];
    # x[j >= n] is zero, so Toeplitz row k (covering j < k) is exact
    k = n - (nc - 1) * chunk
    final = sb[..., -1, :] @ Pt[k].T + torch.stack(
        [d0[..., -1, k], d1[..., -1, k]], dim=-1)
    return y, final
