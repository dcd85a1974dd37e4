"""Stereo convolver — equal-power wet/dry mix over per-channel NUC engines
(counterpart of convopeq_tpu/models/convolver.py; ref:
src/convolver/ConvolverProcessor.Runtime.cpp:601-603, 675-676).

    wet gain = equalPowerSin(mix) * CONVOLUTION_HEADROOM_GAIN (= 1.0)
    dry gain = equalPowerSin(1 - mix)

equalPowerSin is the 9th-order Taylor sine of x*pi/2, so the wet gain at
mix = 1 is not exactly 1.0.  The per-sample mix ramp is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..utils.dsputil import equal_power_sin
from .nuc import NUCState, nuc_convolve

CONVOLUTION_HEADROOM_GAIN = 1.0  # ConvolverProcessor.h:209


@dataclass
class StereoConvolverState:
    """Prepared stereo convolver: one NUCState per channel."""
    left: NUCState
    right: NUCState


def convolver_process(x, state: StereoConvolverState, mix: float = 1.0,
                      frame_mac="auto"):
    """Process (..., 2, N) through the stereo convolver with wet/dry mix."""
    wet_l = nuc_convolve(x[..., 0, :], state.left, frame_mac)
    wet_r = nuc_convolve(x[..., 1, :], state.right, frame_mac)
    wet = torch.stack([wet_l, wet_r], dim=-2)
    mix = float(mix)
    if mix >= 1.0:
        wet_g = float(equal_power_sin(1.0)) * CONVOLUTION_HEADROOM_GAIN
        return wet * wet_g
    wet_g = float(equal_power_sin(mix)) * CONVOLUTION_HEADROOM_GAIN
    dry_g = float(equal_power_sin(1.0 - mix))
    return wet * wet_g + x * dry_g


class StereoConvolver(nn.Module):
    """A prepared stereo convolver as a module: the partition spectra are
    buffers (they follow `.to(device)`), the plans are static."""

    def __init__(self, state: StereoConvolverState):
        super().__init__()
        self.plans = (state.left.plan, state.right.plan)
        for side, st in (("left", state.left), ("right", state.right)):
            for i, H in enumerate(st.layer_spectra):
                self.register_buffer(f"{side}_spectra_{i}", H)

    @property
    def state(self) -> StereoConvolverState:
        def side(name, plan):
            return NUCState(plan=plan, layer_spectra=[
                getattr(self, f"{name}_spectra_{i}")
                for i in range(plan.num_layers)])
        return StereoConvolverState(left=side("left", self.plans[0]),
                                    right=side("right", self.plans[1]))

    def forward(self, x, mix: float = 1.0, frame_mac="auto"):
        return convolver_process(x, self.state, mix, frame_mac)
