"""2x/4x/8x polyphase Kaiser-halfband oversampling (counterpart of
convopeq_tpu/ops/oversample.py; src/CustomInputOversampler.{h,cpp}).

- A cascade of 2x halfband stages; per-stage taps and attenuation
  presets IIRLike {511, 127, 31} / {140, 110, 90 dB}, LinearPhase
  {1023, 255, 63} / {160, 140, 120 dB} (cpp:84-105); `make_stages` is
  the prepare() ladder (2 -> 1 stage, 4 -> 2, 8 -> 3).
- Design (cpp:287-352), host NumPy f64: odd symmetric taps, the
  zero-phase arm zeroed (a true halfband), DC normalization, the center
  coefficient forced to 0.5 and the non-center arm rescaled to sum 0.5.
  The local 2x soft clip (ops/softclip.py) takes its 31-tap stage from
  `design_halfband`.
- Interpolation (cpp:498-567): even output phase = 2 sum_r conv[r]
  x[n-r], odd phase = center_gain x[n - centerDelay].  The reference
  does NOT double the center phase, so the up -> down round trip has DC
  gain 0.75; this is reproduced by default, and
  `center_phase_gain="unity"` selects the flat variant.
- Decimation (cpp:569-720): y[n] = 0.5 u[2n - M] + sum_r conv[r]
  u[2n - convParity - 2r].

Route: every stage runs as the JAX package's banded-Toeplitz GEMM form
(`_resample2_matmul` over `_toeplitz_fir`: two constant matrices a stage
and direction, built on the host and copied to the device once,
`torch.matmul` in the signal's type, TF32 off on the card) on every
device.  The JAX package takes it off the CPU and the polyphase
shift-accumulate form on the CPU; the GEMM form meets the reference
binary's `oversampler` vectors at atol 2e-13 in f64 and the JAX
polyphase form at 1e-13 (tests/test_torch_oversample.py), so the port
keeps one route.  `_causal_fir` (the causal FIR of the polyphase form,
which the true-peak meter takes) is `_fir_matmul`, the same GEMMs at
rate 1, at every tap count.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.dsputil import device_constants, next_pow2

# Preset (src/CustomInputOversampler.h Preset enum: IIRLike, LinearPhase)
PRESET_IIR_LIKE = 0
PRESET_LINEAR_PHASE = 1

_TAPS = {PRESET_IIR_LIKE: (511, 127, 31), PRESET_LINEAR_PHASE: (1023, 255, 63)}
_ATTEN = {PRESET_IIR_LIKE: (140.0, 110.0, 90.0),
          PRESET_LINEAR_PHASE: (160.0, 140.0, 120.0)}


def bessel_i0(x):
    """Series I0 matching the reference's besselI0 (cpp:144-157)."""
    x = np.asarray(x, np.float64)
    s = np.ones_like(x)
    term = np.ones_like(x)
    xx = x * x
    for n in range(1, 100):
        term = term * xx / (4.0 * n * n)
        s = s + term
        if np.all(term < s * 1e-18):
            break
    return s


@dataclass
class HalfbandStage:
    taps: int
    center_tap: int          # M
    center_parity: int       # M & 1 (always 1 for the preset tap counts)
    conv_parity: int         # 1 - center_parity
    conv: np.ndarray         # non-zero arm coefficients conv[r] = h[convParity+2r]
    center_delay: int        # (M - center_parity) / 2, in input samples
    center_gain: float       # 0.5 (reference) or 1.0 (unity variant)


def design_halfband(taps: int, attenuation_db: float,
                    center_phase_gain: str = "reference") -> HalfbandStage:
    """prepareStage coefficient design (cpp:287-372), host NumPy."""
    taps = max(3, taps | 1)
    M = (taps - 1) // 2
    center_parity = M & 1
    conv_parity = 1 - center_parity

    a = attenuation_db
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    i0b = float(bessel_i0(beta))

    n = np.arange(taps)
    t = (n - M).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(t == 0.0, 0.5, np.sin(np.pi * 0.5 * t) / (np.pi * t))
    frac = t / M
    win = bessel_i0(beta * np.sqrt(np.maximum(0.0, 1.0 - frac * frac))) / i0b
    h = sinc * win
    h = np.where((n != M) & ((n & 1) == center_parity), 0.0, h)
    s = h.sum()
    if abs(s) > 1e-20:
        h = h / s
    h[M] = 0.5
    nc = h.sum() - h[M]
    if abs(nc) > 1e-20:
        h = np.where(n != M, h * (0.5 / nc), h)
    h[M] = 0.5

    conv_count = (taps - conv_parity + 1) // 2
    idx = conv_parity + 2 * np.arange(conv_count)
    conv = np.where(idx < taps, h[np.minimum(idx, taps - 1)], 0.0)
    center_gain = 0.5 if center_phase_gain == "reference" else 1.0
    return HalfbandStage(taps=taps, center_tap=M, center_parity=center_parity,
                         conv_parity=conv_parity, conv=conv,
                         center_delay=(M - center_parity) // 2,
                         center_gain=center_gain)


@functools.lru_cache(maxsize=None)
def make_stages(ratio: int, preset: int = PRESET_IIR_LIKE,
                center_phase_gain: str = "reference"):
    """prepare() stage ladder (cpp:416-452): 2 -> 1 stage, 4 -> 2, 8 -> 3.
    Designed once for each argument tuple; the stages are shared, read
    only."""
    ratio = 8 if ratio >= 8 else 4 if ratio >= 4 else 2 if ratio >= 2 else 1
    num = {8: 3, 4: 2, 2: 1, 1: 0}[ratio]
    return tuple(design_halfband(_TAPS[preset][i], _ATTEN[preset][i],
                                 center_phase_gain) for i in range(num))


_TOEPLITZ_CACHE: OrderedDict = OrderedDict()


def _toeplitz_fir(x, g, decim: int = 1, interp: int = 1):
    """y[i] = sum_j g[decim i - interp j] x[j] along the last axis of x:
    the causal FIR (1, 1), a 2x interpolation (1, 2) or a 2x decimation
    (2, 1), as blocked banded-Toeplitz GEMMs (JAX :156-230).  The input
    goes in chunks of `cin` samples, each giving `cout`; with the span
    interp cin = decim cout >= len(g) the band reaches at most one chunk
    back, so y = X @ T0^T + Xprev @ T1^T with T0[i, j] = g[decim i -
    interp j] (the in-chunk band) and T1[i, j] = g[decim i - interp j +
    span] (the spill from the previous chunk).  The span is the JAX
    package's: the next power of two >= len(g), at least 128 x the
    larger rate factor.
    g: host taps (float64); the matrices are built and copied to x's
    device once (`_toeplitz_operands`)."""
    g = np.asarray(g, np.float64)
    span = max(128 * max(decim, interp), next_pow2(len(g)))
    cin, cout = span // interp, span // decim
    n = x.shape[-1]
    batch = x.shape[:-1]
    nc = -(-n // cin)
    xp = torch.nn.functional.pad(x, (0, nc * cin - n)) if nc * cin != n \
        else x
    xr = xp.reshape((-1, nc, cin))
    xprev = torch.nn.functional.pad(xr[:, :-1, :], (0, 0, 1, 0))
    T0t, T1t = device_constants(
        _TOEPLITZ_CACHE, (g.tobytes(), decim, interp),
        lambda: _toeplitz_operands(g, decim, interp, span), x.dtype,
        x.device)
    y = xr @ T0t + xprev @ T1t
    return y.reshape(batch + (nc * cout,))[..., :n * interp // decim]


def _toeplitz_operands(g, decim: int, interp: int, span: int):
    """(T0^T, T1^T) host float64 of `_toeplitz_fir`, (cin, cout) each."""
    r = len(g)
    i = np.arange(span // decim)[:, None]
    j = np.arange(span // interp)[None, :]
    d = decim * i - interp * j
    T0 = np.where((d >= 0) & (d < r), g[np.clip(d, 0, r - 1)], 0.0)
    dp = d + span
    T1 = np.where((dp >= 0) & (dp < r), g[np.clip(dp, 0, r - 1)], 0.0)
    return T0.T.copy(), T1.T.copy()


def _fir_matmul(x, c):
    """Causal FIR y[n] = sum_k c[k] x[n-k] along the last axis of x, zero
    history (`_toeplitz_fir` at rate 1).  c: host taps (float64)."""
    return _toeplitz_fir(x, c)


# the causal FIR of the JAX package's polyphase form, which the true-peak
# meter takes: the port runs it as the Toeplitz GEMMs at every tap count
_causal_fir = _fir_matmul


def _stage_full_response(stage: HalfbandStage, for_up: bool) -> np.ndarray:
    """Dense taps g of the stage as one polyphase-merged filter.

    Up:   y[m] = sum_j g[m - 2j] x[j], g[vp+2r] = 2 conv[r],
          g[M] = center_gain  (interpolateStage semantics).
    Down: y[n] = sum_k g[k] u[2n - k], g[vp+2r] = conv[r], g[M] = 0.5
          (decimateStage semantics)."""
    g = np.zeros(stage.taps, np.float64)
    idx = stage.conv_parity + 2 * np.arange(len(stage.conv))
    keep = idx < stage.taps
    g[idx[keep]] = (2.0 if for_up else 1.0) * stage.conv[keep]
    g[stage.center_tap] = stage.center_gain if for_up else 0.5
    return g


def _resample2_matmul(x, g, up: bool):
    """Rate-2 polyphase FIR along the last axis of x (JAX :189-230):
    up, y[m] = sum_j g[m - 2j] x[j]; down, y[n] = sum_k g[2n - k] u[k]."""
    return _toeplitz_fir(x, g, *((1, 2) if up else (2, 1)))


def upsample2(x, stage: HalfbandStage):
    """One 2x interpolation stage (interpolateStage semantics) on the
    last axis of x."""
    return _resample2_matmul(x, _stage_full_response(stage, True), True)


def downsample2(u, stage: HalfbandStage):
    """One 2x decimation stage (decimateStage semantics):
    y[n] = 0.5 u[2n - M] + sum_r conv[r] u[2n - convParity - 2r]."""
    return _resample2_matmul(u, _stage_full_response(stage, False), False)


def oversample_up(x, stages):
    """processUp: the cascade of 2x stages (cpp:771-800)."""
    for st in stages:
        x = upsample2(x, st)
    return x


def oversample_down(u, stages):
    """processDown: the reverse cascade of 2x decimators (cpp:831-860)."""
    for st in reversed(stages):
        u = downsample2(u, st)
    return u


def oversampler_latency(stages):
    """The per-stage (taps-1)//2 list of the engine's latency model
    (AudioEngine.Processing.Latency.cpp:22-23, 80-124)."""
    return [st.center_tap for st in stages]
