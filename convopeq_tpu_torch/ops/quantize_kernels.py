"""The sequential error-feedback dither quantizer (counterpart of
convopeq_tpu/ops/pallas_kernels.py:47 `error_feedback_quantize`).

A wrapper, a plain PyTorch version and a launch count:

- A CPU tensor takes the plain version: a Python loop over time of
  elementwise tensor ops over the rows, every multiply and every add its
  own op (no `addcmul`, no `torch.compile`), so that nothing is
  contracted into a fused multiply-add, on the CPU or on the card.
- Any other tensor (f32 or f64) takes the hand-written kernel of
  csrc/error_feedback_quantize.cu, built with -fmad=false, or raises
  ValueError for a mode, order, type or shape the kernel does not take.
  The kernel is bit-identical to the plain version, and keeps running
  inside `dispatch.plain()`: the one wrapper that tests the device
  itself (see ops/dispatch.py).
- `launch_counts["error_feedback_quantize"]` grows by one at each kernel
  launch, and nowhere else (under a lock: the engine's live learner
  launches from its own thread); `launch_counts[
  "error_feedback_quantize_rint"]` by one at each launch that rounds
  with rint.  The kernel's host code picks the rounding's form at each
  launch: the folded add pair where `scale` is a power of two (and, in
  the modes that clamp q, 2^(digits-1)*scale >= 1), rint elsewhere; both
  give the same bits.

Both take x (R, N), the uniforms u (R, N, 2) in [0, 1), the feedback
coefficients (pre-clamped to +-0.85 for the lattice modes, as
models/dither.py does), the quantization step `scale` = 2^-(bits-1), the
headroom and an optional state (R, order) (zeros when None), and return
(q (R, N), state after sample N (R, order)).  The coefficients are
either shared, (order,), or one row a signal row, (R, order), for the
lattice modes only: the per-row form simulates a whole CMA-ES population
in one call (models/learner.py; the JAX package vmaps `lattice_dither`
over the candidates).  The per-row coefficients are taken in x's type,
as the shared form rounds its host doubles to x's type, so the two forms
agree bit for bit where the rows' coefficients are equal.  The modes and their
arithmetic are stated in the source note of the .cu file; the dither
term is formed as the JAX wrapper forms it (pallas_kernels.py:97-100).

What bounds the kernel at config6 (R = 512, N = 480,000, f32,
lattice_fir): 16 B of device traffic a sample (3.9 GB, ~1.2 ms at
3.35 TB/s), but each row is one chain of ~20 dependent f32 ops a step
(>= ~106 cycles at the card's latencies, 25.5 ms), so the loop over
time, not memory, sets its time.  The earlier kernel lost ~340 cycles a
step to the staging its one warp ran between steps (121 ms); the kernel
now gives the chain a warp of its own, fed from shared memory by a copy
warp on another scheduler of the SM, and rounds by the folded add pair:
~139 cycles a step, 33.6 ms on an H100 80GB HBM3 at 700 W (~157 and
37.8 ms with rint; see the source note and PERF.md).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ._build import load

MODES = {"psycho": 0, "fixed": 1, "fixed15": 2, "lattice": 3,
         "lattice_fir": 4}
# the (mode, order) pairs the kernel is built for
ORDERS = {"psycho": (12,), "fixed": (4, 16), "fixed15": (4, 16),
          "lattice": (9,), "lattice_fir": (9,)}
STATE_LIMIT = 2.0      # lattice per-stage state clamp (LatticeNoiseShaper)
ROW_MODES = ("lattice", "lattice_fir")   # the modes with a per-row form
CLAMPS_Q = ("fixed15", "lattice", "lattice_fir")  # q clamped to [-1, 1-s]

launch_counts = {"error_feedback_quantize": 0,
                 "error_feedback_quantize_rint": 0}
_COUNT_LOCK = threading.Lock()     # a live learner launches from its thread


def _check_mode(mode: str, order: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown quantizer mode {mode!r}")
    if order not in ORDERS[mode]:
        raise ValueError(f"mode {mode!r} takes order {ORDERS[mode]}, got "
                         f"{order}")


def _coeff_columns(coeffs, mode, x):
    """(order, per-row coefficients (R, order) of x's type on x's device,
    or None for the shared form)."""
    if getattr(coeffs, "ndim", 1) != 2:
        return len(coeffs), None
    if mode not in ROW_MODES:
        raise ValueError(f"per-row coefficients are for the modes "
                         f"{ROW_MODES}, not {mode!r}")
    rc = torch.as_tensor(coeffs).to(x.device, x.dtype).contiguous()
    if x.dim() != 2 or rc.shape[0] != x.shape[0]:
        raise ValueError(f"per-row coefficients must be (R, order) with R = "
                         f"{x.shape[0] if x.dim() else '?'} rows, got "
                         f"{tuple(rc.shape)}")
    return rc.shape[1], rc


def _check_shapes(x, u, state, order):
    if x.dim() != 2:
        raise ValueError(f"x must be (R, N), got {tuple(x.shape)}")
    if tuple(u.shape) != tuple(x.shape) + (2,):
        raise ValueError(f"u must be {tuple(x.shape) + (2,)}, got "
                         f"{tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (x.shape[0], order):
        raise ValueError(f"state must be {(x.shape[0], order)}, got "
                         f"{tuple(state.shape)}")


# ------------------------------------------------------------ plain version

def error_feedback_quantize_plain(x, u, coeffs, scale: float,
                                  headroom: float, mode: str, state=None):
    """The quantizer as a loop over time of one-op-a-launch tensor ops
    (op for op what the kernel computes, on any device).  Shared
    coefficients are Python floats; per-row ones (R,) columns of x's type,
    each product still one op."""
    order, rc = _coeff_columns(coeffs, mode, x)
    c = [float(v) for v in coeffs] if rc is None else \
        list(rc.T.contiguous())
    _check_mode(mode, order)
    _check_shapes(x, u, state, order)
    R, N = x.shape
    inv_scale, hi, lim = 1.0 / scale, 1.0 - scale, 2.0 * scale
    # elementwise terms of the whole signal (the same values the kernel
    # forms sample by sample), time-major so each step reads a row
    xh = (x * headroom).T.contiguous()
    if mode == "psycho":
        d = ((u[..., 0] - 0.5) + (u[..., 1] - 0.5)) * scale
    else:
        d = ((u[..., 0] + u[..., 1]) - 1.0) * scale
    d = d.T.contiguous()
    s = (list(torch.zeros((order, R), dtype=x.dtype, device=x.device))
         if state is None else list(state.to(x.dtype).T.contiguous()))
    q_out = torch.empty((N, R), dtype=x.dtype, device=x.device)
    lattice = mode in ("lattice", "lattice_fir")
    for t in range(N):
        fb = c[0] * s[0]
        for i in range(1, order):
            fb = fb + c[i] * s[i]
        if mode == "psycho":
            tmp = (xh[t] + d[t]) + fb
            q = torch.round(tmp * inv_scale) * scale
            err = tmp - q
        else:
            y = xh[t] + fb if lattice else xh[t] - fb
            q = torch.round((torch.clamp(y, -1.0, hi) + d[t]) * inv_scale) \
                * scale
            if mode in CLAMPS_Q:
                q = torch.clamp(q, -1.0, hi)
            err = torch.clamp(q - y, -lim, lim)
        q_out[t] = q
        if mode == "lattice":
            fwd = err
            for i in range(order):
                nf = fwd + c[i] * s[i]
                s[i] = torch.clamp(c[i] * fwd + s[i], -STATE_LIMIT,
                                   STATE_LIMIT)
                fwd = nf
        elif mode == "lattice_fir":
            fwd = gprev = err
            for i in range(order):
                si = s[i]
                s[i] = torch.clamp(gprev, -STATE_LIMIT, STATE_LIMIT)
                if i + 1 < order:   # the last stage's outputs are unused
                    gprev = c[i] * fwd + si
                    fwd = fwd + c[i] * si
        else:
            s = [err] + s[:-1]
    return q_out.T.contiguous(), torch.stack(s, dim=-1)


# ------------------------------------------------------------------ wrapper

def error_feedback_quantize(x, u, coeffs, scale: float, headroom: float,
                            mode: str, state=None):
    """x (R, N), u (R, N, 2), state (R, order) or None -> (q, state).
    coeffs: (order,) shared, or (R, order) one row a signal row (lattice
    modes)."""
    if x.device.type == "cpu":      # the kernel stays under plain()
        return error_feedback_quantize_plain(x, u, coeffs, scale, headroom,
                                             mode, state)
    order, rc = _coeff_columns(coeffs, mode, x)
    _check_mode(mode, order)
    _check_shapes(x, u, state, order)
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA kernel takes float32 or float64, got "
                         f"{x.dtype}")
    for name, t in (("u", u), ("state", state)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"{name} must be {x.dtype} on {x.device}")
    R, N = x.shape
    x = x.contiguous()
    u = u.contiguous()
    s_in = (torch.zeros((R, order), dtype=x.dtype, device=x.device)
            if state is None else state.contiguous())
    q = torch.empty_like(x)
    s_out = torch.empty_like(s_in)
    lib = load("error_feedback_quantize")
    f32 = x.dtype == torch.float32
    if rc is None:
        fn = (lib.error_feedback_quantize_f32 if f32
              else lib.error_feedback_quantize_f64)
        carg = (ctypes.c_double * order)(*[float(v) for v in coeffs])
    else:
        fn = (lib.error_feedback_quantize_rows_f32 if f32
              else lib.error_feedback_quantize_rows_f64)
        carg = rc.data_ptr()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), u.data_ptr(), s_in.data_ptr(), q.data_ptr(),
                  s_out.data_ptr(), R, N, MODES[mode], carg, order,
                  float(scale), float(headroom),
                  torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"error_feedback_quantize: kernel launch failed "
                           f"(code {code})")
    rint = not lib.error_feedback_quantize_folds(MODES[mode], float(scale),
                                                 x.element_size())
    with _COUNT_LOCK:
        launch_counts["error_feedback_quantize"] += 1
        launch_counts["error_feedback_quantize_rint"] += rint
    return q, s_out
