"""The chains (counterpart of convopeq_tpu/models/chain.py): the staged
chain and the folded ones.

The staged chain (`process_chain`, `StagedChain`; JAX :95-184, :776-789)
runs every stage as a signal pass on the device, in the reference order:
sanitize -> input headroom -> input DC blocker (3 Hz) -> [oversampling:
the up cascade (ops/oversample.py), then the 1 Hz DC blocker at the
processing rate] -> EQ and convolver in `cfg.order` (the trim gain
before the convolver on the EQ->conv order; the EQ's AGC block
`agc_block_size` x os_factor) -> output filter (HC + LC when the
convolver is last, else HPF + LP) -> makeup -> soft clip (the local 2x
form at 1x, the plain clip at the processing rate when oversampled) ->
[the down cascade] -> output DC blocker -> output headroom.  It is the
general chain: EQ saturation, AGC, mid/side or single-channel bands,
the parallel band structure and the soft clip all run as such.

When every stage around the convolver is LTI (no soft clip, no AGC, no
oversampling, wet-only mix, EQ bands all-stereo or bypassed), the input
and output DC blockers, the EQ response, the output filter and the HC/LC
curve fold at rebuild time (host NumPy f64), either

- into the IR itself (`prepare_folded_convolver`): the run-time chain is
  sanitize -> the NUC per channel -> scalar gains; or
- into one separate prefilter (`prepare_fused_prefilter`), run as its own
  uniform partitioned convolution ahead of the untouched 3-layer NUC
  (`process_chain_fused(prefilter=)`, `PrefilterChain`).

See the JAX module's block comment for why the fold is exact (layer gains
are baked into the IR before the fold; the spectrum-filtered NUC does not
commute, so the folded NUC is prepared unfiltered and the HC/LC curve
goes into the prefilter).

`prepare_folded_convolver` plans the folded IR as one uniform layer
("auto" or an int partition) or as the reference's 3-layer plan with
unit gains (None).  The JAX package's two-level "fused2" plan is not
ported: on the H100 it lost to the single uniform layer by 30-40% in
every run (PERF.md).

Which form of each kernel runs is `ops/dispatch.py`'s: inside
`dispatch.plain()` every chain here runs its plain path (the plain frame
steps, the plain soft clip, the DC blockers and the output filter in
their FFT form), the f64 reference on the card.

`prepare_folded_convolver_oversampled` (JAX :598-775) folds the whole
oversampled linear chain into one base-rate IR by the polyphase identity
(`_os_composite_taps`): the run-time chain is again
`process_chain_fused`.  It is how bench config3 rides the frame kernels
(`config3.py`).

The semi-fold for soft-clip chains (`prepare_semi_folded_convolver`,
`process_chain_semi_fused`, `SemiFoldedChain`; JAX :538-595): the LTI
prefix (input DC blocker, EQ, convolver, output filter, HC/LC curve)
folds into the IR; the nonlinear suffix (makeup -> local 2x soft clip ->
output DC blocker -> headroom) runs staged in the reference order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.dc_blocker import dc_block, dc_blocker_alphas
from ..ops.frame_conv_kernels import MAX_PART
from ..ops.partitioned_conv import partition_spectra, uniform_partitioned_conv
from ..ops.oversample import (PRESET_IIR_LIKE, _stage_full_response,
                              make_stages, oversample_down, oversample_up)
from ..ops.softclip import soft_clip, soft_clip_local2x, soft_clip_params
from ..runtime.telemetry import setup_span, span
from ..utils.dsputil import K_OUTPUT_HEADROOM, next_pow2
from .convolver import (StereoConvolver, StereoConvolverState,
                        convolver_process, stereo_prepare)
from .eq import EQParams, eq_process
from .gain_planner import CONVOLVER_THEN_EQ, EQ_THEN_CONVOLVER
from .output_filter import HC_NATURAL, LC_NATURAL, output_filter_process

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


def process_chain(x, cfg: ChainConfig, eq_params: EQParams | None = None,
                  conv_state: StereoConvolverState | None = None,
                  mix_ramp=None):
    """Run the staged chain on x (..., 2, N), time last, on x's device.

    mix_ramp: optional per-sample wet/dry mix (N x os_factor,) at the
    processing rate, which overrides cfg.wet_dry_mix (see
    `convolver.linear_mix_ramp`).  Spans (`runtime.telemetry.span`),
    with the folded chains' names where the stage is the same: "chain"
    around "chain.sanitize", "chain.dc_block" (each DC blocker),
    "chain.oversample" (the up and the down cascade), "chain.eq" (the
    bands and the AGC), "chain.conv" (the trim gain, the stereo NUC and
    the wet gain), "chain.output_filter", "chain.post" (each scalar gain
    outside "chain.conv") and "chain.soft_clip"."""
    sr = cfg.sample_rate
    os_factor = resolve_oversampling_factor(cfg.oversampling_factor, sr)
    proc_rate = sr * os_factor
    dev = x.device
    with span("chain", dev):
        with span("chain.sanitize", dev):
            x = _sanitize(x)
        if cfg.input_headroom_gain != 1.0:
            with span("chain.post", dev):
                x = x * cfg.input_headroom_gain
        with span("chain.dc_block", dev):
            x, _ = dc_block(x, sr, 3.0)
        stages = (make_stages(os_factor, cfg.oversampling_preset)
                  if os_factor > 1 else [])
        if stages:
            with span("chain.oversample", dev):
                x = oversample_up(x, stages)
            with span("chain.dc_block", dev):
                x, _ = dc_block(x, proc_rate, 1.0)
        conv_active = (not cfg.conv_bypassed) and conv_state is not None
        eq_active = (not cfg.eq_bypassed) and eq_params is not None

        def run_eq(sig):
            with span("chain.eq", dev):
                return eq_process(sig, eq_params, proc_rate,
                                  block_size=cfg.agc_block_size * os_factor,
                                  method=cfg.eq_method)

        def run_conv(sig, trim=1.0):
            with span("chain.conv", dev):
                if abs(trim - 1.0) > 1e-12:
                    sig = sig * trim
                return convolver_process(sig, conv_state, cfg.wet_dry_mix,
                                         mix_ramp)

        if cfg.order == CONVOLVER_THEN_EQ:
            if conv_active:
                x = run_conv(x)
            if eq_active:
                x = run_eq(x)
        else:
            if eq_active:
                x = run_eq(x)
            if conv_active:
                x = run_conv(x, cfg.convolver_input_trim_gain)
        if conv_active or eq_active:
            conv_is_last = conv_active and (
                not eq_active or cfg.order == EQ_THEN_CONVOLVER)
            with span("chain.output_filter", dev):
                x = output_filter_process(x, proc_rate, conv_is_last,
                                          cfg.conv_hc_mode, cfg.conv_lc_mode,
                                          cfg.eq_lpf_mode)
        if cfg.output_makeup_gain != 1.0:
            with span("chain.post", dev):
                x = x * cfg.output_makeup_gain
        if cfg.soft_clip_enabled:
            clip = soft_clip if stages else soft_clip_local2x
            with span("chain.soft_clip", dev):
                x = clip(x, *soft_clip_params(cfg.saturation_amount))
        if stages:
            with span("chain.oversample", dev):
                x = oversample_down(x, stages)
        with span("chain.dc_block", dev):
            x, _ = dc_block(x, sr, 3.0)
        if cfg.apply_output_headroom:
            with span("chain.post", dev):
                x = x * K_OUTPUT_HEADROOM
    return x


class StagedChain(nn.Module):
    """The prepared staged chain (the counterpart of `build_chain`): the
    static config, the EQ parameters (or None) and the stereo convolver
    (or None; its partition spectra are buffers).  forward(x) runs
    `process_chain` on x (..., 2, N)."""

    def __init__(self, cfg: ChainConfig, eq_params: EQParams | None = None,
                 conv_state: StereoConvolverState | None = None):
        super().__init__()
        self.cfg = cfg
        self.eq_params = eq_params
        self.convolver = (None if conv_state is None
                          else StereoConvolver(conv_state))

    def forward(self, x, mix_ramp=None):
        return process_chain(
            x, self.cfg, self.eq_params,
            None if self.convolver is None else self.convolver.state,
            mix_ramp)


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


def _sanitize(x):
    """Input stage (InputBitDepthTransform.h:32-100): NaN -> 0, |x| <
    1e-20 flush, clamp +-1 (Inf survives to the clamp).  Clamping first
    gives the same result in fewer passes: the clamp keeps NaN, and a NaN
    fails the >= test."""
    x = x.clamp(-1.0, 1.0)
    return torch.where(x.abs() >= 1e-20, x, 0.0)


def _sanitize_and_trim(x, cfg: ChainConfig):
    """`_sanitize`, then the scalar pre-gains of the folded chains."""
    x = _sanitize(x)
    # trim applies only on the EQ->conv order, as in the staged chain
    pre = cfg.input_headroom_gain * (
        cfg.convolver_input_trim_gain
        if cfg.order != CONVOLVER_THEN_EQ else 1.0)
    return x * pre if pre != 1.0 else x


def prepare_fused_prefilter(cfg: ChainConfig, eq_params: EQParams | None,
                            eps: float = 1e-10, dtype=torch.float32,
                            part_size: int = 8192, spec=None,
                            ir_len: int = 10 ** 6, block_size: int = 512,
                            device="cuda"):
    """Partition spectra of the folded prefilter: (Hg, part_size), Hg
    (P, part_size+1) complex in `dtype`'s precision on `device`.

    Pass the FilterSpec as `spec` to fold the HC/LC curve in (and prepare
    the NUC with apply_spectrum_filter=False).  AIR tail mode (per-layer
    damping) does not fold: the caller's layer plan, probed at `ir_len`
    and `block_size`, must carry no damping."""
    if spec is not None:
        from .nuc import plan_layers
        probe = plan_layers(ir_len, block_size, spec)
        if any(lp.damping is not None for lp in probe.layers):
            raise ValueError("AIR tail mode (per-layer damping) cannot be "
                             "folded into a global prefilter")
    g = fused_prefilter_ir(cfg, eq_params, eps, spec=spec)
    Hg = partition_spectra(torch.as_tensor(g).to(dtype), part_size,
                           dtype=dtype, device=device)
    return Hg, part_size


def process_chain_fused(x, cfg: ChainConfig, conv_state: StereoConvolverState,
                        prefilter=None):
    """The collapsed run-time chain: sanitize -> scalar gains ->
    [prefilter conv] -> NUC -> scalar gains, on x (..., 2, N) with time
    last.  With a `prefilter` (Hg, part_size) from
    `prepare_fused_prefilter`, the NUC is the normal `stereo_prepare`
    state; without one, a state from `prepare_folded_convolver`, which
    bakes the prefilter into the IR.  Spans (`runtime.telemetry.span`): "chain" around
    "chain.sanitize", "chain.conv" and "chain.post"."""
    dev = x.device
    with span("chain", dev):
        with span("chain.sanitize", dev):
            x = _sanitize_and_trim(x, cfg)
        if prefilter is not None:
            Hg, pg = prefilter
            x = uniform_partitioned_conv(x, Hg, pg)
        with span("chain.conv", dev):
            y = convolver_process(x, conv_state, 1.0)
        post = cfg.output_makeup_gain * (K_OUTPUT_HEADROOM
                                         if cfg.apply_output_headroom
                                         else 1.0)
        if post != 1.0:
            with span("chain.post", dev):
                y = y * post
    return y


def throughput_partition_size(ir_len: int, f64: bool = False) -> int:
    """Partition size for the offline single-layer throughput plan: one
    uniform layer (every extra layer is an extra pass over the signal),
    p = next_pow2(ir_len / 64), at least 1024, capped at 32768 in f32 and
    at 65536 in f64 (`f64=True`), the caps of the JAX package's f32 path
    and of its f64 path without the TPU's dd kernels.  On the H100 the
    1M-tap headline ran fastest at p = 32768 in f32 and at p = 65536 in
    f64, where the MAC costs more beside the transforms (PERF.md, the
    partition sweeps of `python -m convopeq_tpu_torch.sweep partition`)."""
    p = next_pow2(max(1024, ir_len // 64))
    return min(p, MAX_PART if f64 else 32768)


@setup_span("setup.fold")
def prepare_folded_convolver(ir, block_size: int, spec, cfg: ChainConfig,
                             eq_params: EQParams | None, eps: float = 1e-10,
                             dtype=torch.float32, partition="auto",
                             dc_passes: int = 2,
                             fold_spectrum_curve: bool = True,
                             device="cuda") -> StereoConvolverState:
    """Fold the LTI prefilter (dc blockers, EQ, output filter, HC/LC
    curve) into the IR on the host in f64, then prepare a NUC of the
    combined response, with spectra in `dtype` on `device`.

    The layer gains of the ORIGINAL IR's plan are baked into the IR first
    (h_eff[n] = h[n] * gain(layer of n)), then h_eff is convolved with the
    prefilter g:  NUC(h) = h_eff * x  =>  g * NUC(h) = (g * h_eff) * x.

    partition: "auto" (`throughput_partition_size`) or an int partition
    size for one uniform layer; None for the reference's 3-layer plan
    with unit gains.  Every choice computes the same linear
    convolution.  AIR tail mode (per-layer damping)
    cannot fold and raises."""
    from .nuc import nuc_prepare_uniform, plan_layers
    if not (partition in ("auto", None) or isinstance(partition, int)):
        raise ValueError(f"partition {partition!r}: 'auto', None or an int")
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
    cj = torch.as_tensor(combined).to(dtype)
    if partition is None:
        return stereo_prepare(cj, block_size, spec,
                              apply_spectrum_filter=False,
                              unit_layer_gains=True, device=device)
    if partition == "auto":
        partition = throughput_partition_size(
            combined.shape[-1], f64=(dtype == torch.float64))
    return StereoConvolverState(
        left=nuc_prepare_uniform(cj[0], int(partition), block_size, device),
        right=nuc_prepare_uniform(cj[1], int(partition), block_size, device))


def _os_composite_taps(stages, for_up: bool) -> np.ndarray:
    """Dense taps of the whole up (or down) halfband cascade at the final
    processing rate, by the noble identity: each stage's polyphase-merged
    filter (`_stage_full_response`) is zero-stuffed to the final rate and
    the results convolve.  Up cascade (stage order 0..k): G = g_k *
    stuff2(g_{k-1}) * stuff4(g_{k-2}) ...; the down cascade (applied
    reversed) has the same structure with the decimator taps."""
    G = np.ones(1, np.float64)
    for i, st in enumerate(stages):
        g = _stage_full_response(st, for_up)
        stuff = 2 ** (len(stages) - 1 - i)
        if stuff > 1:
            gs = np.zeros((len(g) - 1) * stuff + 1, np.float64)
            gs[::stuff] = g
            g = gs
        G = np.convolve(G, g)
    return G


def prepare_folded_convolver_oversampled(
        ir_hf, block_size: int, spec, cfg: ChainConfig,
        eq_params: EQParams | None, eps: float = 1e-10,
        dtype=torch.float32, partition="auto",
        fold_spectrum_curve: bool = True,
        device="cuda") -> StereoConvolverState:
    """Fold the whole oversampled linear chain into one base-rate IR, on
    the host in f64, and prepare it with spectra in `dtype` on `device`.

    The staged chain at os_factor L > 1 is, for a static linear config
    (soft clip off, wet only, AGC off, diagonal EQ), the LTI cascade
    up-FIRs -> dc_os (1 Hz) -> [EQ] -> conv (the IR at the processing
    rate) -> output filter -> down-FIRs between the base-rate input and
    output DC blockers.  Upsample by L -> LTI -> decimate by L is exactly
    LTI at the base rate (the polyphase identity): with the composite
    interpolator G_u and decimator G_d at the processing rate,

        h_eq[n] = (G_d * h_hf_chain * G_u)[L n],

    with no approximation beyond the eps pole-tail truncation of the
    base-rate fold.  The run time is `process_chain_fused`.  The
    oversampler's FIR group delay sits inside h_eq as its leading zeros,
    as in the staged chain's output.

    ir_hf: the IR at the processing rate (`ir.resample.resample_ir`).
    The layer gains of the high-rate plan (block block_size x L) are
    baked in; AIR damping cannot fold and raises.  The HC/LC curve folds
    linearly (as in `prepare_folded_convolver`); fold_spectrum_curve=False
    pairs with a staged NUC prepared apply_spectrum_filter=False for an
    exact comparison.  partition: "auto" (`throughput_partition_size`),
    an int partition size for one uniform layer, or None for the
    reference's 3-layer plan with unit gains.  At L == 1 this is
    `prepare_folded_convolver`."""
    from ..ops.scan_iir import _biquad_pole_radius
    from .eq import (STEREO, _band_matrix_response, _eq_ring_tail_samples,
                     band_active_mask)
    from .nuc import nuc_prepare_uniform, plan_layers, spectrum_filter_gain
    from .output_filter import IDENTITY, output_filter_coeffs
    if not (partition in ("auto", None) or isinstance(partition, int)):
        raise ValueError(f"partition {partition!r}: 'auto', None or an int")
    sr = cfg.sample_rate
    L = resolve_oversampling_factor(cfg.oversampling_factor, sr)
    if L == 1:
        return prepare_folded_convolver(
            ir_hf, block_size, spec, cfg, eq_params, eps, dtype, partition,
            fold_spectrum_curve=fold_spectrum_curve, device=device)
    if cfg.soft_clip_enabled:
        raise ValueError("soft clip is nonlinear; the OS chain cannot fold")
    if cfg.wet_dry_mix < 1.0:
        raise ValueError("wet/dry mixing does not fold (the dry path "
                         "bypasses the convolver)")
    proc = sr * L
    ir_hf = np.asarray(ir_hf, np.float64)
    if ir_hf.ndim == 1:
        ir_hf = np.stack([ir_hf, ir_hf])
    base = plan_layers(ir_hf.shape[-1], block_size * L, spec)
    if any(lp.damping is not None for lp in base.layers):
        raise ValueError("AIR tail mode (per-layer damping) cannot be "
                         "folded into the IR")
    h_eff = ir_hf.copy()
    for lp in base.layers:
        if lp.gain != 1.0:
            h_eff[:, lp.offset:lp.offset + lp.length] *= lp.gain

    # the high-rate section: G_u * dc_os * [EQ] * h_eff * output filter *
    # [HC/LC curve] * G_d, all on one processing-rate DFT grid
    stages = make_stages(L, cfg.oversampling_preset)
    g_up = _os_composite_taps(stages, True)
    g_dn = _os_composite_taps(stages, False)
    eq_active = (not cfg.eq_bypassed) and eq_params is not None
    if eq_active:
        if eq_params.agc_enabled or float(eq_params.saturation) > 0.0:
            raise ValueError("AGC / saturated EQ is not LTI; cannot fold")
        active = band_active_mask(eq_params)
        if not all(int(eq_params.modes[b]) == STEREO
                   for b in range(len(active)) if active[b]):
            raise ValueError("M/S EQ bands mix channels; one IR per "
                             "channel cannot fold them")
    # truncation: the slowest pole among the 1 Hz oversampled DC
    # blockers, the output-filter biquads and the EQ ring tail
    radii = [1.0 - a for a in dc_blocker_alphas(proc, 1.0)]
    ofc = output_filter_coeffs(proc)
    conv_is_last = not eq_active or cfg.order == EQ_THEN_CONVOLVER
    if conv_is_last:
        stages_of = [ofc["hc"][cfg.conv_hc_mode][0],
                     ofc["hc"][cfg.conv_hc_mode][1],
                     ofc["lc"][cfg.conv_lc_mode]]
    else:
        stages_of = [ofc["hpf"], ofc["lp"][cfg.eq_lpf_mode][0],
                     ofc["lp"][cfg.eq_lpf_mode][1]]
    stages_of = [c for c in stages_of if tuple(c) != IDENTITY]
    radii += [_biquad_pole_radius(c[3], c[4]) for c in stages_of]
    eq_tail = _eq_ring_tail_samples(eq_params, proc, eps) if eq_active else 0
    rmax = min(max(radii), 1.0 - 1e-12)
    tail_hf = max(int(np.ceil(np.log(eps) / np.log(rmax))), eq_tail, 256)
    total_hf = ir_hf.shape[-1] + len(g_up) + len(g_dn) + tail_hf
    m = next_pow2(total_hf)
    z = np.exp(1j * 2.0 * np.pi * np.arange(m // 2 + 1) / m)
    H = np.fft.rfft(g_up, m) * np.fft.rfft(g_dn, m)
    for a in dc_blocker_alphas(proc, 1.0):
        H *= (1.0 - a) * (z - 1.0) / (z - (1.0 - a))
    for b0, b1, b2, a1, a2 in stages_of:
        H *= (b0 * z * z + b1 * z + b2) / (z * z + a1 * z + a2)
    if eq_active:
        freqs = np.arange(m // 2 + 1) * (proc / m)
        H = H * _band_matrix_response(eq_params, proc, freqs)[0]
    if spec is not None and fold_spectrum_curve:
        H = H * spectrum_filter_gain(m, spec)
    h_hf = np.fft.irfft(np.fft.rfft(h_eff, m) * H, m)[:, :total_hf]
    h_dec = h_hf[:, ::L]                       # the polyphase identity

    # the base-rate section: the input and output 3 Hz DC blockers
    alphas_b = dc_blocker_alphas(sr, 3.0)
    tail_b = max(int(np.ceil(np.log(eps) / np.log(min(
        1.0 - a for a in alphas_b)))), 256)
    nb = h_dec.shape[-1] + tail_b
    mb = next_pow2(nb)
    zb = np.exp(1j * 2.0 * np.pi * np.arange(mb // 2 + 1) / mb)
    Hb = np.ones(mb // 2 + 1, complex)
    for _ in range(2):
        for a in alphas_b:
            Hb *= (1.0 - a) * (zb - 1.0) / (zb - (1.0 - a))
    combined = np.fft.irfft(np.fft.rfft(h_dec, mb) * Hb, mb)[:, :nb]
    cj = torch.as_tensor(combined).to(dtype)
    if partition is None:
        return stereo_prepare(cj, block_size, spec,
                              apply_spectrum_filter=False,
                              unit_layer_gains=True, device=device)
    if partition == "auto":
        partition = throughput_partition_size(
            combined.shape[-1], f64=(dtype == torch.float64))
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

    def forward(self, x):
        return process_chain_fused(x, self.cfg, self.convolver.state)


class PrefilterChain(nn.Module):
    """The fused chain with a separate prefilter: static config, the
    folded prefilter's partition spectra (a buffer) and the stereo
    convolver (the 3-layer NUC of `stereo_prepare`).  forward(x) runs
    `process_chain_fused(prefilter=)` on x (..., 2, N)."""

    def __init__(self, cfg: ChainConfig, prefilter,
                 conv_state: StereoConvolverState):
        super().__init__()
        self.cfg = cfg
        Hg, self.prefilter_part = prefilter
        self.register_buffer("prefilter_spectra", Hg)
        self.convolver = StereoConvolver(conv_state)

    def forward(self, x):
        return process_chain_fused(
            x, self.cfg, self.convolver.state,
            (self.prefilter_spectra, self.prefilter_part))


@setup_span("setup.fold")
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
                             conv_state: StereoConvolverState):
    """Run time for `prepare_semi_folded_convolver`: sanitize -> scalar
    pre-gains -> folded NUC (dc_in + EQ + conv + output filter) -> makeup
    -> local 2x soft clip -> output DC blocker -> headroom, the staged
    chain's order (the soft clip and the output DC blocker do not commute
    with the fold).  Spans: "chain" around "chain.sanitize", "chain.conv", "chain.post"
    (each scalar gain), "chain.soft_clip" and "chain.dc_block"."""
    if resolve_oversampling_factor(cfg.oversampling_factor,
                                   cfg.sample_rate) > 1:
        raise ValueError("semi-fused chain is single-rate (oversampled "
                         "soft-clip configs run staged)")
    dev = x.device
    with span("chain", dev):
        with span("chain.sanitize", dev):
            x = _sanitize_and_trim(x, cfg)
        with span("chain.conv", dev):
            y = convolver_process(x, conv_state, 1.0)
        if cfg.output_makeup_gain != 1.0:
            with span("chain.post", dev):
                y = y * cfg.output_makeup_gain
        with span("chain.soft_clip", dev):
            y = soft_clip_local2x(y, *soft_clip_params(cfg.saturation_amount))
        with span("chain.dc_block", dev):
            y, _ = dc_block(y, cfg.sample_rate, 3.0)
        if cfg.apply_output_headroom:
            with span("chain.post", dev):
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

    def forward(self, x):
        return process_chain_semi_fused(x, self.cfg, self.convolver.state)
