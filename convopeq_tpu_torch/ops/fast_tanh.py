"""Rational (Pade) tanh approximations (counterpart of
convopeq_tpu/ops/fast_tanh.py; ref src/dsp/math/FastTanhApprox.h:24-92),
elementwise on tensors:

- `fast_tanh_eq`   (DefaultFastTanhPolicy, scalar EQ path): x (27 + x^2) /
  (27 + 9 x^2), exactly +-1 at |x| >= 4.5.
- `fast_tanh_eq_v` (the SIMD EQ path): clamp to +-4.5, then the rational.
- `fast_tanh_clip` (SoftClipPadePolicy, clamp-then-evaluate, as
  softClipBlockAVX2): x (10395 + x^2 (1260 + 21 x^2)) / (10395 + x^2 (4725
  + x^2 (210 + x^2))).
"""
from __future__ import annotations

import torch

CLIP_THRESHOLD = 4.5


def fast_tanh_eq(x):
    x2 = x * x
    core = x * (27.0 + x2) / (27.0 + 9.0 * x2)
    one = torch.ones_like(x)
    return torch.where(x >= CLIP_THRESHOLD, one,
                       torch.where(x <= -CLIP_THRESHOLD, -one, core))


def fast_tanh_eq_v(x):
    x = torch.clamp(x, -CLIP_THRESHOLD, CLIP_THRESHOLD)
    x2 = x * x
    return x * (27.0 + x2) / (27.0 + 9.0 * x2)


def fast_tanh_clip(x):
    x = torch.clamp(x, -CLIP_THRESHOLD, CLIP_THRESHOLD)
    x2 = x * x
    num = x * (10395.0 + x2 * (1260.0 + x2 * 21.0))
    den = 10395.0 + x2 * (4725.0 + x2 * (210.0 + x2))
    return num / den
