"""Stereo convolver — equal-power wet/dry mix over per-channel NUC engines
(counterpart of convopeq_tpu/models/convolver.py; ref:
src/convolver/ConvolverProcessor.Runtime.cpp:601-603, 675-676).

    wet gain = equalPowerSin(mix) * CONVOLUTION_HEADROOM_GAIN (= 1.0)
    dry gain = equalPowerSin(1 - mix)

equalPowerSin is the 9th-order Taylor sine of x*pi/2, so the wet gain at
mix = 1 is not exactly 1.0.  A pending mix change is ramped per sample
(the reference's mixSmoother, a LinearRamp) and each sample's gains go
through the same polynomial.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..utils.dsputil import equal_power_sin, equal_power_sin_poly
from .nuc import FilterSpec, NUCState, nuc_convolve, nuc_prepare

CONVOLUTION_HEADROOM_GAIN = 1.0  # ConvolverProcessor.h:209


@dataclass
class StereoConvolverState:
    """Prepared stereo convolver: one NUCState per channel."""
    left: NUCState
    right: NUCState


def stereo_prepare(ir_stereo, block_size: int, spec: FilterSpec | None = None,
                   scale: float = 1.0, enable_direct_head: bool = False,
                   apply_spectrum_filter: bool = True,
                   unit_layer_gains: bool = False, dtype=None,
                   device="cuda") -> StereoConvolverState:
    """loadImpulseResponse/SetImpulse for both channels.  ir_stereo:
    (2, N), or (N,) for a mono IR, which the reference duplicates across
    the pair.  The other arguments are `nuc_prepare`'s."""
    ir = torch.as_tensor(ir_stereo).to("cpu")
    if ir.dim() == 1:
        ir = torch.stack([ir, ir])

    def prep(ch):
        return nuc_prepare(ir[ch], block_size, spec, scale,
                           enable_direct_head, apply_spectrum_filter,
                           unit_layer_gains, dtype, device)
    return StereoConvolverState(left=prep(0), right=prep(1))


def linear_mix_ramp(n: int, old_mix: float, new_mix: float,
                    sample_rate: float, smoothing_time_sec: float = 0.1,
                    device="cuda") -> torch.Tensor:
    """Per-sample mix values (n,) float64 on `device` of a mix change from
    `old_mix` to `new_mix`: the reference's LinearRamp over
    `smoothing_time_sec`, which advances before its first sample (as the
    JAX engine builds it, convopeq_tpu/engine/engine.py:555-568)."""
    steps = max(1, int(sample_rate * smoothing_time_sec + 0.5))
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    return torch.where(k >= steps, new_mix,
                       old_mix + (new_mix - old_mix) / steps * k)


def convolver_process(x, state: StereoConvolverState, mix: float = 1.0,
                      mix_ramp=None):
    """Process (..., 2, N) through the stereo convolver with wet/dry mix.

    mix_ramp: optional per-sample mix values (N,), best on x's device
    (see `linear_mix_ramp`);
    when given it overrides the scalar `mix`, and the gains are evaluated
    per sample in x's dtype."""
    wet_l = nuc_convolve(x[..., 0, :], state.left)
    wet_r = nuc_convolve(x[..., 1, :], state.right)
    wet = torch.stack([wet_l, wet_r], dim=-2)
    if mix_ramp is not None:
        m = torch.as_tensor(mix_ramp, dtype=x.dtype, device=x.device)
        wet_g = equal_power_sin_poly(m) * CONVOLUTION_HEADROOM_GAIN
        dry_g = equal_power_sin_poly(1.0 - m)
        return wet * wet_g + x * dry_g
    mix = float(mix)
    if mix >= 1.0:
        wet_g = float(equal_power_sin(1.0)) * CONVOLUTION_HEADROOM_GAIN
        return wet * wet_g
    wet_g = float(equal_power_sin(mix)) * CONVOLUTION_HEADROOM_GAIN
    dry_g = float(equal_power_sin(1.0 - mix))
    return wet * wet_g + x * dry_g


class StereoConvolver(nn.Module):
    """A prepared stereo convolver as a module: the partition spectra and
    the direct heads' taps are buffers (they follow `.to(device)`), the
    plans are static."""

    def __init__(self, state: StereoConvolverState):
        super().__init__()
        self.plans = (state.left.plan, state.right.plan)
        for side, st in (("left", state.left), ("right", state.right)):
            for i, H in enumerate(st.layer_spectra):
                self.register_buffer(f"{side}_spectra_{i}", H)
            self.register_buffer(f"{side}_direct", st.direct_ir)

    @property
    def state(self) -> StereoConvolverState:
        def side(name, plan):
            return NUCState(plan=plan, layer_spectra=[
                getattr(self, f"{name}_spectra_{i}")
                for i in range(plan.num_layers)],
                direct_ir=getattr(self, f"{name}_direct"))
        return StereoConvolverState(left=side("left", self.plans[0]),
                                    right=side("right", self.plans[1]))

    def forward(self, x, mix: float = 1.0, mix_ramp=None):
        return convolver_process(x, self.state, mix, mix_ramp)
