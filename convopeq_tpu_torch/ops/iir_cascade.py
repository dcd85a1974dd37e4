"""The chain's linear recurrences: a cascade of 2-state sections along the
last axis of a signal (..., N), each section's output the next one's
input.  Two kinds of section:

- `dc_section(a0, a1)`: the two-stage DC blocker of ops/dc_blocker.py,
  state (s0, s1):  s0' = s0 + a0 (x - s0);  u = x - s0';
  s1' = s1 + a1 (u - s1);  y = u - s1'.
- `biquad_section(b0, b1, b2, a1, a2)`: a transposed-direct-form-II
  biquad, state (z1, z2), as `scan_iir.biquad_df2t_scan`.

`iir_cascade(x, sections, state0)` runs them from the initial states
state0 (..., K, 2) (zero when None) and returns (y, final states
(..., K, 2)).  What runs where:

- A CPU tensor takes the plain version, `iir_cascade_plain`: the
  sections one after another in the forms of the JAX package, the DC
  blocker as `dc_block_toeplitz` (counterpart of the signal path of
  convopeq_tpu/ops/dc_blocker.py `dc_block`: per state component one
  strictly-lower Toeplitz matmul on the input's chunks of DC_CHUNK, the
  chunk-boundary states through `affine_scan_2x2`, then the output
  combination; its operands built on the host and copied to the device
  once), a biquad through `biquad_df2t_scan`'s "auto" route.  Its
  TPU-only f64 emulation of the DC blocker (`_dc_block_dd`) is not
  ported.  The plain version runs on the card too, where `chip_smoke.py`
  times it beside the kernel (TF32 off).
- Any other tensor, float32 or float64 (a strided one through a
  contiguous copy), takes the hand-written kernel of csrc/iir_cascade.cu:
  one launch runs the whole cascade, in f64 state and arithmetic, reading
  the signal once and writing it once (its design and bound in the source
  note).  It takes one DC section alone or one to MAX_SECTIONS biquads;
  anything else raises ValueError: nothing falls back.
- `launch_counts["iir_cascade"]` grows by one at each kernel launch, and
  nowhere else.

Inside `dispatch.plain()`, any tensor takes `iir_cascade_fft`: the
cascade's frequency response, made in long double on the host from each
section's transfer function, applied to the zero-padded signal by FFT in
its type; zero initial state (an initial state raises), and no final
states (None).  It shares nothing with the kernel or with the plain
version, and is the f64 reference of the card's plain path.  In f64 it
sits 2e-16 to 2e-14 from the recurrence run in long double, where the
plain version's 2x2 route of the 15-20 Hz high-passes carries ~7e-11 at
48 kHz and ~5e-9 at 192 kHz (white noise x 0.25), over the 1e-12 that
the f64 lines are held to.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..utils.dsputil import device_constants, next_pow2
from ._build import load
from .dispatch import in_plain, use_kernel
from .scan_iir import affine_scan_2x2, biquad_df2t_scan

DC_CHUNK = 128
MAX_SECTIONS = 3
# a warp's tile of csrc/iir_cascade.cu: 32 lanes x 256 bytes
TILE_BYTES = 8192
_KIND = {"dc": 0, "biquad": 1}

_DC_CONSTANTS: OrderedDict = OrderedDict()
# `iir_cascade_fft`: e-folds of the slowest pole between the signal's end
# and the FFT's length, so that the response's wrap-around is nil
FFT_TAIL_EFOLDS = 60.0
_RESPONSES: OrderedDict = OrderedDict()
_PI = np.longdouble("3.14159265358979323846264338327950288")

launch_counts = {"iir_cascade": 0}


class Section(NamedTuple):
    kind: str        # "dc" or "biquad"
    coeffs: tuple    # host floats: (a0, a1) or (b0, b1, b2, a1, a2)


def dc_section(a0: float, a1: float) -> Section:
    return Section("dc", (float(a0), float(a1)))


def biquad_section(b0, b1, b2, a1, a2) -> Section:
    return Section("biquad", tuple(float(c) for c in (b0, b1, b2, a1, a2)))


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


def dc_block_toeplitz(x, a0: float, a1: float, state0=None):
    """The DC section along the last axis of x (..., N) in its
    direct-Toeplitz form.  Returns (y, final_state (..., 2))."""
    dt, dev = x.dtype, x.device
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


def iir_cascade_plain(x, sections, state0=None):
    """The cascade section by section in the JAX package's forms (see
    the module note).  Returns (y, final states (..., K, 2))."""
    finals = []
    for k, sec in enumerate(sections):
        s0 = None if state0 is None else state0[..., k, :]
        if sec.kind == "dc":
            x, fin = dc_block_toeplitz(x, *sec.coeffs, s0)
        else:
            x, fin = biquad_df2t_scan(x, *sec.coeffs, s0=s0)
        finals.append(fin)
    return x, torch.stack(finals, dim=-2)


def _u_polynomials(sec: Section):
    """Section sec's transfer function as (numerator, denominator), each
    (c0, c1, c2) in long double with H = (c0 + c1 u + c2 u^2) / (...) in
    u = 1 - z^-1, whose coefficients near z = 1 do not cancel:
    - DC: b0 b1 (1 - z^-1)^2 / ((1 - b0 z^-1)(1 - b1 z^-1)), b = 1 - a:
      each stage's output is b (v - s) of its input v and state s;
    - biquad: (b0 + b1 z^-1 + b2 z^-2) / (1 + a1 z^-1 + a2 z^-2)."""
    ld = np.longdouble
    if sec.kind == "dc":
        a0, a1 = (ld(c) for c in sec.coeffs)
        b0, b1 = 1 - a0, 1 - a1
        return ((ld(0), ld(0), b0 * b1),
                (a0 * a1, a0 * b1 + a1 * b0, b0 * b1))
    b0, b1, b2, a1, a2 = (ld(c) for c in sec.coeffs)
    return ((b0 + b1 + b2, -(b1 + 2 * b2), b2),
            (1 + a1 + a2, -(a1 + 2 * a2), a2))


def _pole_radius(sec: Section) -> float:
    if sec.kind == "dc":
        return max(1.0 - sec.coeffs[0], 1.0 - sec.coeffs[1])
    return float(np.abs(np.roots([1.0, sec.coeffs[3], sec.coeffs[4]])).max())


def fft_length(n: int, sections) -> int:
    """The FFT length of `iir_cascade_fft` for n samples: a power of two
    at least n plus FFT_TAIL_EFOLDS e-folds of the slowest pole."""
    r = max(_pole_radius(sec) for sec in sections)
    if not r < 1.0:
        raise ValueError(f"the FFT form takes stable sections, pole radius "
                         f"{r}")
    tail = int(np.ceil(FFT_TAIL_EFOLDS / -np.log(r)))
    return next_pow2(n + tail)


def _response(sections, m: int) -> np.ndarray:
    """The cascade's frequency response at the m // 2 + 1 bins of an m-point
    real FFT, made in long double, rounded once to complex128."""
    w = np.arange(m // 2 + 1, dtype=np.longdouble) * (_PI / m)   # half angle
    sw = np.sin(w)
    u = 2 * sw * sw + 1j * np.sin(2 * w)     # 1 - e^(-2iw), clongdouble
    h = np.ones_like(u)
    for sec in sections:
        num, den = _u_polynomials(sec)
        h = h * ((num[0] + u * (num[1] + u * num[2]))
                 / (den[0] + u * (den[1] + u * den[2])))
    return h.astype(np.complex128)


def iir_cascade_fft(x, sections):
    """The cascade along the last axis of x from zero state as an FFT
    convolution: x zero-padded to `fft_length`, times the cascade's
    frequency response (`_response`, kept by sections and length), back
    in x's type (see the module note).  Returns y, contiguous as the
    kernel's (the soft clip kernel after the output filter takes no
    other)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the FFT form takes float32 or float64, got "
                         f"{x.dtype}")
    sections = tuple(sections)
    n = x.shape[-1]
    m = fft_length(n, sections)
    complex_dt = (torch.complex128 if x.dtype == torch.float64
                  else torch.complex64)
    h, = device_constants(_RESPONSES, (sections, m),
                          lambda: (_response(sections, m),), complex_dt,
                          x.device, size=8)
    y = torch.fft.irfft(torch.fft.rfft(x, n=m) * h, n=m)
    return y[..., :n].contiguous()


def _check_kernel_input(x, sections, state0) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the IIR cascade kernel takes float32 or float64, "
                         f"got {x.dtype}")
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"the IIR cascade kernel takes rows of samples, "
                         f"got shape {tuple(x.shape)}")
    if x.numel() // x.shape[-1] >= 2 ** 31 or x.shape[-1] >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} too large for the IIR "
                         f"cascade kernel")
    kinds = [s.kind for s in sections]
    if not (kinds == ["dc"] or
            (0 < len(kinds) <= MAX_SECTIONS
             and all(k == "biquad" for k in kinds))):
        raise ValueError(f"the IIR cascade kernel takes one DC section or "
                         f"1-{MAX_SECTIONS} biquads, got {kinds}")
    want = x.shape[:-1] + (len(sections), 2)
    if state0 is not None and tuple(state0.shape) != want:
        raise ValueError(f"initial states of shape {tuple(state0.shape)}, "
                         f"want {want}")


def tiles(n: int, itemsize: int) -> int:
    """The kernel's tiles along a row of n samples."""
    return -(-n // (TILE_BYTES // itemsize))


def _entry_args(x, y, sections, state0, final, flags, vals):
    """The C entry's arguments but the stream: x and y as R rows of N."""
    n = x.shape[-1]
    coef = [0.0] * (5 * len(sections))
    for k, sec in enumerate(sections):
        coef[5 * k:5 * k + len(sec.coeffs)] = sec.coeffs
    return (x.data_ptr(), y.data_ptr(), x.numel() // n, n,
            tiles(n, x.element_size()), len(sections),
            _KIND[sections[0].kind], (ctypes.c_double * len(coef))(*coef),
            None if state0 is None else state0.data_ptr(),
            None if final is None else final.data_ptr(), flags.data_ptr(),
            vals.data_ptr())


def _launch(x, y, sections, state0, final, flags, vals) -> int:
    """One launch of the kernel on x's current stream; the C entry's
    return code."""
    lib = load("iir_cascade")
    fn = (lib.iir_cascade_f32 if x.dtype == torch.float32
          else lib.iir_cascade_f64)
    with torch.cuda.device(x.device):
        return fn(*_entry_args(x, y, sections, state0, final, flags, vals),
                  torch.cuda.current_stream(x.device).cuda_stream)


def iir_cascade(x, sections, state0=None):
    """The cascade `sections` along the last axis of x (any batch shape)
    from state0 (..., K, 2) or zero: one kernel launch, or the plain
    version where `use_kernel` says no; returns (y, final states
    (..., K, 2)).  Inside `dispatch.plain()`: `iir_cascade_fft` on any
    device, from zero state; returns (y, None)."""
    sections = tuple(sections)
    if in_plain():
        if state0 is not None:
            raise ValueError("the FFT form runs from zero state")
        return iir_cascade_fft(x, sections), None
    if not use_kernel(x):
        return iir_cascade_plain(x, sections, state0)
    _check_kernel_input(x, sections, state0)
    x = x.contiguous()          # the staged chain hands it strided views
    if state0 is not None:
        state0 = state0.to(device=x.device, dtype=x.dtype).contiguous()
    n = x.shape[-1]
    rows = x.numel() // n
    count = rows * tiles(n, x.element_size())
    y = torch.empty_like(x)
    final = torch.empty(x.shape[:-1] + (len(sections), 2), dtype=x.dtype,
                        device=x.device)
    flags = torch.zeros(count + 1, dtype=torch.int32, device=x.device)
    vals = torch.empty(count * 8 * len(sections), dtype=torch.float64,
                       device=x.device)
    code = _launch(x, y, sections, state0, final, flags, vals)
    if code != 0:
        raise RuntimeError(f"iir_cascade: kernel launch failed (code {code})")
    launch_counts["iir_cascade"] += 1
    return y, final
