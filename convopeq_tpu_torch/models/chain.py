"""The folded chain (counterpart of the fused mode of
convopeq_tpu/models/chain.py).

When every stage around the convolver is LTI (no soft clip, no AGC, no
oversampling, wet-only mix, EQ bands all-stereo or bypassed), the input
and output DC blockers, the EQ response, the output filter and the HC/LC
curve fold into the IR itself at rebuild time (host NumPy f64), and the
run-time chain is sanitize -> one uniform partitioned convolution per
channel -> scalar gains.  See the JAX module's block comment for why the
fold is exact (layer gains are baked into the IR before the fold).

Ported here: `ChainConfig`, `resolve_oversampling_factor`,
`fused_eligible`, `fused_prefilter_ir`, `throughput_partition_size`
(the f32 cap), `prepare_folded_convolver` with a single-layer partition
plan, `process_chain_fused` without a separate prefilter, and
`FoldedChain`, the prepared chain as a module.

The semi-fold for soft-clip chains (`prepare_semi_folded_convolver`,
`process_chain_semi_fused`, `SemiFoldedChain`; JAX :538-595): the LTI
prefix (input DC blocker, EQ, convolver, output filter, HC/LC curve)
folds into the IR; the nonlinear suffix (makeup -> local 2x soft clip ->
output DC blocker -> headroom) runs staged in the reference order.

The staged chain, the 3-layer and "fused2" plans and the separate
prefilter are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.dc_blocker import dc_block, dc_blocker_alphas
from ..ops.softclip import soft_clip_local2x, soft_clip_params
from ..utils.dsputil import K_OUTPUT_HEADROOM, next_pow2
from .convolver import (StereoConvolver, StereoConvolverState,
                        convolver_process)
from .eq import EQParams
from .gain_planner import CONVOLVER_THEN_EQ, EQ_THEN_CONVOLVER
from .output_filter import HC_NATURAL, LC_NATURAL

PRESET_IIR_LIKE = 0   # ops/oversample.py preset (oversampling not ported)


def resolve_oversampling_factor(requested: int, sample_rate: float) -> int:
    """OversamplingPolicy::resolve (src/audioengine/OversamplingPolicy.h:51-86):
    the max factor caps the internal rate at 768 kHz; requested == 0 (Auto)
    or any value outside {1,2,4,8} resolves to the MAX allowed factor; a
    valid request above the cap falls back to the cap; > 768 kHz input
    is unsupported and resolves to 1."""
    if sample_rate <= 96000.0:
        cap = 8
    elif sample_rate <= 192000.0:
        cap = 4
    elif sample_rate <= 384000.0:
        cap = 2
    elif sample_rate <= 768000.0:
        cap = 1
    else:
        return 1  # supported == false
    if requested not in (1, 2, 4, 8):
        return cap  # Auto / invalid-value fallback
    return requested if requested <= cap else cap


@dataclass
class ChainConfig:
    """Static per-stream configuration (the ProcessingState analog,
    src/audioengine/AudioEngine.h:822-848)."""
    sample_rate: float = 48000.0
    order: int = EQ_THEN_CONVOLVER
    eq_bypassed: bool = False
    conv_bypassed: bool = False
    oversampling_factor: int = 1       # requested; resolved via policy
    oversampling_preset: int = PRESET_IIR_LIKE
    input_headroom_gain: float = 1.0   # linear
    output_makeup_gain: float = 1.0    # linear
    convolver_input_trim_gain: float = 1.0  # linear
    soft_clip_enabled: bool = False
    saturation_amount: float = 0.0     # drives soft-clip params
    wet_dry_mix: float = 1.0
    conv_hc_mode: int = HC_NATURAL
    conv_lc_mode: int = LC_NATURAL
    eq_lpf_mode: int = HC_NATURAL
    apply_output_headroom: bool = True  # x kOutputHeadroom when no dither
    agc_block_size: int = 512
    eq_method: str = "auto"


def fused_eligible(cfg: ChainConfig, eq_params: EQParams | None,
                   has_conv: bool) -> bool:
    """Static-config fusion applies when the around-conv chain is LTI and
    single-rate, and the EQ (if active) is a DIAGONAL 2x2 (stereo-only
    bands — M/S bands mix channels, which one IR per channel can't)."""
    if not has_conv or cfg.conv_bypassed or cfg.soft_clip_enabled:
        return False
    if cfg.wet_dry_mix < 1.0:
        return False
    if resolve_oversampling_factor(cfg.oversampling_factor,
                                   cfg.sample_rate) != 1:
        return False
    if cfg.eq_bypassed or eq_params is None:
        return True
    if eq_params.agc_enabled or float(eq_params.saturation) > 0.0:
        return False
    from .eq import band_active_mask, STEREO
    active = band_active_mask(eq_params)
    return all(int(eq_params.modes[b]) == STEREO
               for b in range(len(active)) if active[b])


def fused_prefilter_ir(cfg: ChainConfig, eq_params: EQParams | None,
                       eps: float = 1e-10, spec=None, dc_passes: int = 2):
    """Host-f64 impulse response of the folded LTI stages: dc_in(3 Hz) *
    [EQ] * output_filter * dc_out(3 Hz) * [HC/LC spectrum-filter curve,
    applied linearly when `spec` is given].  Returns (tail,) float64.

    dc_passes: how many 3 Hz DC-blocker passes to fold (2 = input AND
    output blocker; 1 = input only)."""
    from ..ops.scan_iir import _biquad_pole_radius
    from .output_filter import output_filter_coeffs, IDENTITY
    sr = cfg.sample_rate

    # truncation length from the slowest pole
    radii = [1.0 - a for a in dc_blocker_alphas(sr, 3.0)] * 2
    ofc = output_filter_coeffs(sr)
    eq_active = (not cfg.eq_bypassed) and eq_params is not None
    conv_is_last = not eq_active or cfg.order == EQ_THEN_CONVOLVER
    if conv_is_last:
        stages = [ofc["hc"][cfg.conv_hc_mode][0],
                  ofc["hc"][cfg.conv_hc_mode][1],
                  ofc["lc"][cfg.conv_lc_mode]]
    else:
        stages = [ofc["hpf"], ofc["lp"][cfg.eq_lpf_mode][0],
                  ofc["lp"][cfg.eq_lpf_mode][1]]
    for c in stages:
        if tuple(c) != IDENTITY:
            radii.append(_biquad_pole_radius(c[3], c[4]))
    if eq_active:
        from .eq import _eq_ring_tail_samples
        eq_tail = _eq_ring_tail_samples(eq_params, sr, eps)
    else:
        eq_tail = 0
    rmax = min(max(radii), 1.0 - 1e-12)
    tail = max(int(np.ceil(np.log(eps) / np.log(rmax))), eq_tail, 256)
    m = next_pow2(2 * tail)
    w = 2.0 * np.pi * np.arange(m // 2 + 1) / m
    z = np.exp(1j * w)

    # dc blockers: per one-pole stage H(z) = (1-a)(z-1)/(z-(1-a))
    H = np.ones(m // 2 + 1, complex)
    for _ in range(dc_passes):
        for a in dc_blocker_alphas(sr, 3.0):
            H *= (1.0 - a) * (z - 1.0) / (z - (1.0 - a))
    # output filter biquads
    for c in stages:
        if tuple(c) != IDENTITY:
            b0, b1, b2, a1, a2 = c
            H *= (b0 * z * z + b1 * z + b2) / (z * z + a1 * z + a2)
    # EQ (diagonal): h11 of the 2x2 band-matrix response
    if eq_active:
        from .eq import _band_matrix_response
        freqs = np.arange(m // 2 + 1) * (sr / m)
        h11, _h12, _h21, _h22 = _band_matrix_response(eq_params, sr, freqs)
        H *= h11
    if spec is not None:
        # the NUC HC/LC curve, applied LINEARLY on this grid (the folded
        # NUC is prepared unfiltered)
        from .nuc import spectrum_filter_gain
        H *= spectrum_filter_gain(m, spec)
    return np.fft.irfft(H, n=m)[:tail]


def _sanitize_and_trim(x, cfg: ChainConfig):
    """Input stage (InputBitDepthTransform.h:32-100): NaN -> 0, |x| <
    1e-20 flush, clamp +-1 (Inf survives to the clamp); then the scalar
    pre-gains.  Clamping first gives the same result in fewer passes: the
    clamp keeps NaN, and a NaN fails the >= test."""
    x = x.clamp(-1.0, 1.0)
    x = torch.where(x.abs() >= 1e-20, x, 0.0)
    # trim applies only on the EQ->conv order, as in the staged chain
    pre = cfg.input_headroom_gain * (
        cfg.convolver_input_trim_gain
        if cfg.order != CONVOLVER_THEN_EQ else 1.0)
    return x * pre if pre != 1.0 else x


def process_chain_fused(x, cfg: ChainConfig, conv_state: StereoConvolverState,
                        frame_mac="auto"):
    """The collapsed run-time chain: sanitize -> scalar gains -> NUC ->
    scalar gains, on x (..., 2, N) with time last, for a state from
    `prepare_folded_convolver`.  `frame_mac` passes through to
    `uniform_partitioned_conv` ("plain" = the plain frame steps on any
    device)."""
    x = _sanitize_and_trim(x, cfg)
    y = convolver_process(x, conv_state, 1.0, frame_mac)
    post = cfg.output_makeup_gain * (K_OUTPUT_HEADROOM
                                     if cfg.apply_output_headroom else 1.0)
    if post != 1.0:
        y = y * post
    return y


def throughput_partition_size(ir_len: int) -> int:
    """Partition size for the offline single-layer throughput plan: one
    uniform layer (every extra layer is an extra pass over the signal),
    p = next_pow2(ir_len / 64), at least 1024, capped at 32768 (the JAX
    package's f32 cap; its f64 cap waits for the f64 tier).  The optimum
    was chosen on a TPU; where it lies on the H100 is not measured yet."""
    p = next_pow2(max(1024, ir_len // 64))
    return min(p, 32768)


def prepare_folded_convolver(ir, block_size: int, spec, cfg: ChainConfig,
                             eq_params: EQParams | None, eps: float = 1e-10,
                             dtype=torch.float32, partition="auto",
                             dc_passes: int = 2,
                             fold_spectrum_curve: bool = True,
                             device="cuda") -> StereoConvolverState:
    """Fold the LTI prefilter (dc blockers, EQ, output filter, HC/LC
    curve) into the IR on the host in f64, then prepare a single-layer
    uniform NUC of the combined response, with spectra in `dtype` on
    `device`.

    The layer gains of the ORIGINAL IR's plan are baked into the IR first
    (h_eff[n] = h[n] * gain(layer of n)), then h_eff is convolved with the
    prefilter g:  NUC(h) = h_eff * x  =>  g * NUC(h) = (g * h_eff) * x.

    partition: "auto" (`throughput_partition_size`) or an int partition
    size.  AIR tail mode (per-layer damping) cannot fold and raises."""
    from .nuc import nuc_prepare_uniform, plan_layers
    if partition != "auto" and not isinstance(partition, int):
        raise ValueError(f"partition {partition!r}: this port takes 'auto' "
                         "or an int (the 3-layer and fused2 plans are not "
                         "ported yet)")
    ir = np.asarray(ir, np.float64)
    if ir.ndim == 1:
        ir = np.stack([ir, ir])
    base = plan_layers(ir.shape[-1], block_size, spec)
    if any(lp.damping is not None for lp in base.layers):
        raise ValueError("AIR tail mode (per-layer damping) cannot be "
                         "folded into the IR")
    h_eff = ir.copy()
    for lp in base.layers:
        if lp.gain != 1.0:
            h_eff[:, lp.offset:lp.offset + lp.length] *= lp.gain
    g = fused_prefilter_ir(cfg, eq_params, eps,
                           spec=spec if fold_spectrum_curve else None,
                           dc_passes=dc_passes)
    m = next_pow2(ir.shape[-1] + g.shape[0] - 1)
    combined = np.fft.irfft(np.fft.rfft(h_eff, m) * np.fft.rfft(g, m),
                            m)[:, :ir.shape[-1] + g.shape[0] - 1]
    if partition == "auto":
        partition = throughput_partition_size(combined.shape[-1])
    cj = torch.as_tensor(combined).to(dtype)
    return StereoConvolverState(
        left=nuc_prepare_uniform(cj[0], int(partition), block_size, device),
        right=nuc_prepare_uniform(cj[1], int(partition), block_size, device))


class FoldedChain(nn.Module):
    """The prepared folded chain: static config plus the stereo convolver
    (its partition spectra are buffers).  forward(x) runs
    `process_chain_fused` on x (..., 2, N)."""

    def __init__(self, cfg: ChainConfig, conv_state: StereoConvolverState):
        super().__init__()
        self.cfg = cfg
        self.convolver = StereoConvolver(conv_state)

    def forward(self, x, frame_mac="auto"):
        return process_chain_fused(x, self.cfg, self.convolver.state,
                                   frame_mac)


def prepare_semi_folded_convolver(ir, block_size: int, spec, cfg: ChainConfig,
                                  eq_params: EQParams | None,
                                  eps: float = 1e-10, dtype=torch.float32,
                                  partition="auto",
                                  fold_spectrum_curve: bool = True,
                                  device="cuda") -> StereoConvolverState:
    """Partial fold for soft-clip chains: the LTI prefix (input DC
    blocker, EQ, convolver with layer gains, output filter, HC/LC curve)
    folds into the IR (one DC-blocker pass, the input one); the nonlinear
    suffix stays staged (`process_chain_semi_fused`)."""
    if not cfg.soft_clip_enabled:
        raise ValueError("use prepare_folded_convolver when soft clip is "
                         "off (the full fold is strictly better)")
    if cfg.wet_dry_mix < 1.0:
        raise ValueError("wet/dry mixing does not fold")
    lin_cfg = ChainConfig(**{**cfg.__dict__, "soft_clip_enabled": False})
    return prepare_folded_convolver(ir, block_size, spec, lin_cfg, eq_params,
                                    eps, dtype, partition, dc_passes=1,
                                    fold_spectrum_curve=fold_spectrum_curve,
                                    device=device)


def process_chain_semi_fused(x, cfg: ChainConfig,
                             conv_state: StereoConvolverState,
                             frame_mac="auto"):
    """Run time for `prepare_semi_folded_convolver`: sanitize -> scalar
    pre-gains -> folded NUC (dc_in + EQ + conv + output filter) -> makeup
    -> local 2x soft clip -> output DC blocker -> headroom, the staged
    chain's order (the soft clip and the output DC blocker do not commute
    with the fold).  `frame_mac` passes through to the convolution."""
    if resolve_oversampling_factor(cfg.oversampling_factor,
                                   cfg.sample_rate) > 1:
        raise ValueError("semi-fused chain is single-rate (oversampled "
                         "soft-clip configs run staged)")
    x = _sanitize_and_trim(x, cfg)
    y = convolver_process(x, conv_state, 1.0, frame_mac)
    if cfg.output_makeup_gain != 1.0:
        y = y * cfg.output_makeup_gain
    y = soft_clip_local2x(y, *soft_clip_params(cfg.saturation_amount))
    y, _ = dc_block(y, cfg.sample_rate, 3.0)
    if cfg.apply_output_headroom:
        y = y * K_OUTPUT_HEADROOM
    return y


class SemiFoldedChain(nn.Module):
    """The prepared semi-folded chain: static config plus the stereo
    convolver (its partition spectra are buffers).  forward(x) runs
    `process_chain_semi_fused` on x (..., 2, N)."""

    def __init__(self, cfg: ChainConfig, conv_state: StereoConvolverState):
        super().__init__()
        self.cfg = cfg
        self.convolver = StereoConvolver(conv_state)

    def forward(self, x, frame_mac="auto"):
        return process_chain_semi_fused(x, self.cfg, self.convolver.state,
                                        frame_mac)
