"""Musical soft clip (counterpart of convopeq_tpu/ops/softclip.py:27-86;
ref src/audioengine/AudioEngine.Processing.DSPCoreDouble.cpp:107-224).

Memoryless and elementwise:
  clip_start = threshold - knee;  |x| <= clip_start -> x
  t = clamp((|x| - clip_start)/(2 knee), 0, 1);  ks = t^2 (3 - 2 t)
  clipped = threshold + knee * tanh_sc((|x| - threshold)/knee)
  mixed = |x| + (clipped - |x|) ks;  factor = 1 - asym (1 - sign)/2 ks
  y = sign * mixed * factor;  knee < 1e-9 -> hard clip at +-threshold.
Parameters from the saturation amount s (DSPCoreDouble.cpp:471-475):
  threshold = 0.95 - 0.45 s;  knee = 0.05 + 0.35 s;  asymmetry = 0.10 s

`soft_clip_local2x` is the local 2x oversampled clip (31-tap halfband
up -> clip -> down) with the 2x intermediate eliminated by polyphase
substitution, as in the JAX package.  What runs where:

- A CPU tensor, or any tensor inside `dispatch.plain()`, takes the plain
  version, `soft_clip_local2x_plain`: its two 16-tap FIRs as `F.conv1d`
  and the clip as eager elementwise PyTorch (~70 passes over the signal;
  on the card it is the plain path's soft clip, and `chip_smoke.py`
  times it beside the kernel, TF32 off).
- Any other tensor, float32 or float64 and contiguous, takes the
  hand-written kernel of csrc/softclip.cu, one launch that reads the
  signal once and writes it once (its design and bound in the source
  note), or raises ValueError for anything else: nothing falls back.
- `launch_counts["soft_clip_local2x"]` grows by one at each kernel
  launch, and nowhere else.

The elementwise `soft_clip` of the oversampled chains is eager PyTorch on
every device.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load
from .dispatch import use_kernel
from .fast_tanh import fast_tanh_clip
from .oversample import design_halfband

launch_counts = {"soft_clip_local2x": 0}


def soft_clip_params(saturation_amount: float):
    s = float(saturation_amount)
    return (0.95 - 0.45 * s, 0.05 + 0.35 * s, 0.10 * s)


def soft_clip(x, threshold: float, knee: float, asymmetry: float):
    if knee <= 1.0e-9:
        return torch.clamp(x, -threshold, threshold)
    clip_start = threshold - knee
    ax = x.abs()
    sign = torch.where(x > 0.0, 1.0, -1.0).to(x.dtype)
    t = torch.clamp((ax - clip_start) / (2.0 * knee), 0.0, 1.0)
    ks = t * t * (3.0 - 2.0 * t)
    clipped = threshold + knee * fast_tanh_clip((ax - threshold) / knee)
    mixed = ax + (clipped - ax) * ks
    factor = 1.0 - asymmetry * (1.0 - sign) * 0.5 * ks
    y = sign * mixed * factor
    return torch.where(ax > clip_start, y, x)


def _fir(x, taps):
    """y[k] = sum_s taps[s] x[k + len(taps) - 1 - s] (valid part), over
    the last axis, as one conv1d."""
    w = torch.as_tensor(taps[::-1].copy(), dtype=x.dtype, device=x.device)
    n = x.shape[-1]
    y = F.conv1d(x.reshape(-1, 1, n), w.reshape(1, 1, -1))
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def soft_clip_local2x_plain(x, threshold: float, knee: float,
                            asymmetry: float):
    """The local 2x soft clip (DSPCoreDouble.cpp:491-501), polyphase form:

        y[n] = 0.5 clip(0.5 x[n-15])
               + sum_r c[r] clip(2 sum_s c[s] x[n-r-s])

    with c the 16 conv-phase taps of the 31-tap stage; zero history at
    the block start; the 15 base-sample latency is the x[n-15] delay."""
    c = _conv_taps()
    n = x.shape[-1]
    xp = F.pad(x, (30, 0))
    # ue[k] = u[2(k-15)] for k in [0, n+15)
    ue = soft_clip(2.0 * _fir(xp, c), threshold, knee, asymmetry)
    y = _fir(ue, c)
    uo = soft_clip(0.5 * xp[..., 15:15 + n], threshold, knee, asymmetry)
    return 0.5 * uo + y


@functools.cache
def _conv_taps():
    """The 16 conv-phase taps of the 31-tap stage, (16,) host float64,
    designed once."""
    st = design_halfband(31, 90.0)
    if not (st.conv_parity == 0 and st.center_parity == 1):
        raise ValueError("unexpected halfband stage layout")
    return st.conv


@functools.cache
def _taps():
    """`_conv_taps` as the kernel's host doubles."""
    return (ctypes.c_double * 16)(*[float(v) for v in _conv_taps()])


def _check_kernel_input(x) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the soft clip kernel takes float32 or float64, "
                         f"got {x.dtype}")
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"the soft clip kernel takes rows of samples, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the soft clip kernel takes a contiguous signal")
    if x.numel() // x.shape[-1] >= 2 ** 31 or x.shape[-1] >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} too large for the soft "
                         f"clip kernel")


def _entry_args(x, y, threshold, knee, asymmetry):
    """The C entry's arguments but the stream: x and y as R rows of N."""
    n = x.shape[-1]
    return (x.data_ptr(), y.data_ptr(), x.numel() // n, n, _taps(),
            float(threshold), float(knee), float(asymmetry))


def _launch(x, y, threshold, knee, asymmetry) -> int:
    """One launch of the kernel on x's current stream; the C entry's
    return code."""
    lib = load("softclip")
    fn = (lib.soft_clip_local2x_f32 if x.dtype == torch.float32
          else lib.soft_clip_local2x_f64)
    with torch.cuda.device(x.device):
        return fn(*_entry_args(x, y, threshold, knee, asymmetry),
                  torch.cuda.current_stream(x.device).cuda_stream)


def soft_clip_local2x(x, threshold: float, knee: float, asymmetry: float):
    """`soft_clip_local2x_plain`'s function over the last axis of x (any
    batch shape): one kernel launch, or the plain version where
    `use_kernel` says no."""
    if not use_kernel(x):
        return soft_clip_local2x_plain(x, threshold, knee, asymmetry)
    _check_kernel_input(x)
    y = torch.empty_like(x)
    code = _launch(x, y, threshold, knee, asymmetry)
    if code != 0:
        raise RuntimeError(f"soft_clip_local2x: kernel launch failed "
                           f"(code {code})")
    launch_counts["soft_clip_local2x"] += 1
    return y
