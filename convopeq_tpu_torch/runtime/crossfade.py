"""Crossfade plane: glitch-free transitions between configurations
(counterpart of convopeq_tpu/runtime/crossfade.py).

Rebuild of the reference's CrossfadeAuthority + CrossfadeRuntime
(src/audioengine/CrossfadeAuthority.cpp, CrossfadeRuntime.h): when a
structural change is published, the audio thread runs BOTH the old and
the new DSP for the fade window and mixes them with a linear fade-in
ramp on the new path (LinearRamp 0 -> 1 over fadeTimeSec),
latency-aligned (runLatencyAlignedCrossfadeMixLoop,
AudioEngine.Processing.BlockDouble.cpp:402).

Fade times per trigger class (ARCHITECTURE.md:694-704): convolver bypass
80 ms, IR length 50 ms, phase mode 60 ms, direct head 10 ms, NUC filter
30 ms, tail mode 30 ms, oversampling 30 ms.

The trigger rules, `LinearRamp` and `CrossfadeState` are host Python;
`crossfade_mix` and `crossfade_blocks` mix tensors on their device, the
ramp built there in float64 and cast to the signal's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

# fadeTimeSec per trigger (ARCHITECTURE.md:694-704)
FADE_TIMES_SEC = {
    "conv_bypass": 0.080,
    "ir_length": 0.050,
    "phase_mode": 0.060,
    "direct_head": 0.010,
    "nuc_filter": 0.030,
    "tail_mode": 0.030,
    "oversampling": 0.030,
    "default": 0.050,
}


def classify_transition(old, new) -> tuple:
    """CrossfadeAuthority::evaluate analog: the triggered classes between
    two ChainConfig / engine snapshots (dataclasses or dicts)."""
    get = lambda o, k, d=None: (o.get(k, d) if isinstance(o, dict)
                                else getattr(o, k, d))
    triggers = []
    if get(old, "conv_bypassed") != get(new, "conv_bypassed"):
        triggers.append("conv_bypass")
    if get(old, "oversampling_factor") != get(new, "oversampling_factor"):
        triggers.append("oversampling")
    if get(old, "conv_hc_mode") != get(new, "conv_hc_mode") or \
            get(old, "conv_lc_mode") != get(new, "conv_lc_mode"):
        triggers.append("nuc_filter")
    if get(old, "phase_mode") != get(new, "phase_mode"):
        triggers.append("phase_mode")
    if get(old, "tail_mode") != get(new, "tail_mode"):
        triggers.append("tail_mode")
    if get(old, "enable_direct_head") != get(new, "enable_direct_head"):
        triggers.append("direct_head")
    if get(old, "target_ir_seconds") != get(new, "target_ir_seconds"):
        triggers.append("ir_length")
    return tuple(triggers)


@dataclass
class LinearRamp:
    """The reference's LinearRamp (DspNumericPolicy.h:319+), exact:
    reset() fixes the total step count; set_target() mid-ramp reuses the
    REMAINING steps as denominator; next_value() advances before
    returning and snaps to the target on the final step."""
    current: float = 0.0
    target: float = 0.0
    step: float = 0.0
    remaining: int = 0
    total_steps: int = 1

    def reset(self, sample_rate: float, time_sec: float):
        steps = int(sample_rate * time_sec + 0.5)
        self.total_steps = steps if steps > 0 else 1

    def set_current_and_target(self, v: float):
        self.current = self.target = v
        self.step = 0.0
        self.remaining = 0

    def set_target(self, v: float):
        if v == self.target:
            return
        self.target = v
        steps = self.remaining if self.remaining > 0 else self.total_steps
        self.step = (self.target - self.current) / steps
        self.remaining = steps

    def next_value(self) -> float:
        if self.remaining <= 0:
            return self.current
        self.remaining -= 1
        if self.remaining == 0:
            self.current = self.target
        else:
            self.current += self.step
        return self.current

    @property
    def is_smoothing(self) -> bool:
        return self.remaining > 0


def fade_time_for(triggers) -> float:
    """The effective fade time is the longest of the triggered classes."""
    if not triggers:
        return 0.0
    return max(FADE_TIMES_SEC.get(t, FADE_TIMES_SEC["default"])
               for t in triggers)


def crossfade_mix(old_y, new_y, sample_rate: float, fade_time_sec: float,
                  new_latency_offset: int = 0, start_sample: int = 0):
    """Linear fade-in of the new path over the old (the RT mix loop).

    old_y / new_y: (..., C, N) tensors on one device.  new_latency_offset
    > 0 delays the new path (latency alignment when the new DSP has more
    latency than the old); start_sample offsets the ramp (a fade resumed
    across blocks).  The first mixed sample carries gain 1/fade_samples
    and the ramp reaches exactly 1.0 on its final step (LinearRamp
    advances before it returns)."""
    old_y = torch.as_tensor(old_y)
    new_y = torch.as_tensor(new_y, device=old_y.device)
    n = old_y.shape[-1]
    fade_samples = max(1, int(round(fade_time_sec * sample_rate)))
    if new_latency_offset > 0:
        new_y = F.pad(new_y, (new_latency_offset, 0))[..., :n]
    g = (torch.arange(n, dtype=torch.float64, device=old_y.device)
         + (start_sample + 1)) / fade_samples
    g = g.clamp(0.0, 1.0).to(old_y.dtype)
    return old_y * (1.0 - g) + new_y * g


@dataclass
class CrossfadeState:
    """Carried fade progress for block-wise mixing (CrossfadeRuntime)."""
    fade_samples: int
    position: int = 0

    @property
    def active(self) -> bool:
        return self.position < self.fade_samples

    def advance(self, n: int):
        self.position = min(self.fade_samples, self.position + n)
        return self


def crossfade_blocks(state: CrossfadeState, old_block, new_block,
                     sample_rate: float):
    """Block-wise mix driver: mixes one block and advances the ramp."""
    n = old_block.shape[-1]
    out = crossfade_mix(old_block, new_block, sample_rate,
                        state.fade_samples / sample_rate,
                        start_sample=state.position)
    state.advance(n)
    return state, out
