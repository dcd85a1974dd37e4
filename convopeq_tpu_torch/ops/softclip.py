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
substitution, as in the JAX package.  Its two 16-tap FIRs run as
`F.conv1d` (one pass each; TF32 off on the card); the clip itself is
eager elementwise PyTorch, ~25 passes over the signal, where XLA fused it
on the TPU.  Fusing it into one kernel is left for later.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .fast_tanh import fast_tanh_clip
from .oversample import design_halfband


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


def soft_clip_local2x(x, threshold: float, knee: float, asymmetry: float):
    """The local 2x soft clip (DSPCoreDouble.cpp:491-501), polyphase form:

        y[n] = 0.5 clip(0.5 x[n-15])
               + sum_r c[r] clip(2 sum_s c[s] x[n-r-s])

    with c the 16 conv-phase taps of the 31-tap stage; zero history at
    the block start; the 15 base-sample latency is the x[n-15] delay."""
    st = design_halfband(31, 90.0)
    if not (st.conv_parity == 0 and st.center_parity == 1):
        raise ValueError("unexpected halfband stage layout")
    c = st.conv                      # (16,) host float64
    n = x.shape[-1]
    xp = F.pad(x, (30, 0))
    # ue[k] = u[2(k-15)] for k in [0, n+15)
    ue = soft_clip(2.0 * _fir(xp, c), threshold, knee, asymmetry)
    y = _fir(ue, c)
    uo = soft_clip(0.5 * xp[..., 15:15 + n], threshold, knee, asymmetry)
    return 0.5 * uo + y
