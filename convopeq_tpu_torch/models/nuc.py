"""Non-Uniform Partitioned Convolution (NUC) — layer plans and the uniform
single-layer form (counterpart of convopeq_tpu/models/nuc.py).

Ported here: the layer sizing of SetImpulse (`plan_layers`,
MKLNonUniformConvolver.cpp:624-768), the HC/LC spectrum-filter curve
(`spectrum_filter_gain`, cpp:336-440), the single-layer throughput
preparation (`nuc_prepare_uniform`) and `nuc_convolve` with every layer
delivered at its exact offset and gain (the JAX package's
tail_delivery="exact").  The 3-layer `nuc_prepare` with its direct head
and air-absorption damping, and the reference's tail-delivery schedule,
are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.partitioned_conv import partition_spectra, uniform_partitioned_conv
from ..utils.dsputil import next_pow2

K_L0_MAX_PARTS = 32   # MKLNonUniformConvolver.h:392
K_L1_MAX_PARTS = 64   # MKLNonUniformConvolver.h:393
K_MAX_DIRECT_TAPS = 32  # cpp:689

# HCMode / LCMode (src/OutputFilter.h:9-16)
HC_SHARP, HC_NATURAL, HC_SOFT = 0, 1, 2
LC_NATURAL, LC_SOFT = 0, 1
# tail modes (FilterSpec, MKLNonUniformConvolver.h:129)
TAIL_AIR_ABSORPTION, TAIL_CONTOUR, TAIL_BYPASS = 0, 1, 2


@dataclass
class FilterSpec:
    """Mirrors the reference FilterSpec (MKLNonUniformConvolver.h:123-133)."""
    sample_rate: float = 48000.0
    hc_mode: int = HC_NATURAL
    lc_mode: int = LC_NATURAL
    tail_mode: int = TAIL_CONTOUR
    tail_enabled: bool = True
    tail_start_seconds: float = 0.085
    tail_strength: float = 1.0
    tail_l1l2_multiplier: int = 8


@dataclass(frozen=True)
class NUCLayerPlan:
    offset: int        # IR offset of this layer's segment
    length: int        # segment length in samples
    part_size: int
    num_parts: int     # ceil(length / part_size)
    gain: float        # m_tailLayerGain for this layer
    damping: float | None  # air-absorption damping coeff (None = off)


@dataclass(frozen=True)
class NUCPlan:
    """Host-side layer layout (the SetImpulse sizing logic, cpp:738-768)."""
    layers: tuple
    direct_taps: int
    latency: int
    block_size: int
    ir_len: int

    @property
    def num_layers(self):
        return len(self.layers)


def plan_layers(ir_len: int, block_size: int, spec: FilterSpec,
                enable_direct_head: bool = False) -> NUCPlan:
    """Layer sizing — exact parity with SetImpulse (cpp:624-768, 1062-1075)."""
    tail_mode = int(np.clip(spec.tail_mode, 0, 2))
    tail_enabled = (tail_mode != TAIL_BYPASS) and spec.tail_enabled
    sr = spec.sample_rate
    tail_start = float(np.clip(spec.tail_start_seconds, 0.01, 0.80))
    user_strength = float(np.clip(spec.tail_strength, 0.0, 2.0))
    mult = int(np.clip(spec.tail_l1l2_multiplier, 2, 16))
    strength01 = min(max(user_strength * 0.5, 0.0), 1.0)

    if not tail_enabled:
        l1_gain = l2_gain = 0.0
    elif tail_mode == TAIL_AIR_ABSORPTION:
        tail_start = float(np.clip(max(tail_start, 0.055), 0.01, 0.80))
        mult = int(np.clip(max(mult, 6), 2, 16))
        strength = float(np.clip(user_strength, 0.0, 2.0))
        l1_gain = float(np.clip(strength * (0.95 - 0.25 * strength01), 0.0, 2.0))
        l2_gain = float(np.clip(strength * (0.80 - 0.45 * strength01), 0.0, 2.0))
    elif tail_mode == TAIL_CONTOUR:
        tail_start = float(np.clip(max(tail_start, 0.12), 0.01, 0.80))
        strength = float(np.clip(max(user_strength, 1.25), 0.0, 2.0))
        mult = int(np.clip(max(mult, 8), 2, 16))
        l1_gain = float(np.clip(strength * (1.05 + 0.20 * strength01), 0.0, 2.0))
        l2_gain = float(np.clip(strength * (0.82 + 0.12 * strength01), 0.0, 2.0))
    else:
        l1_gain = l2_gain = 0.0

    l0_part = next_pow2(max(block_size, 64))
    l1_part = l0_part * mult
    l2_part = l1_part * mult

    l0_max_len = K_L0_MAX_PARTS * l0_part
    l0_by_tail = int(round(tail_start * sr))
    l0_target = int(np.clip(l0_by_tail, l0_part, l0_max_len))
    l0_len = min(ir_len, l0_target if tail_enabled else l0_max_len)

    l1_len = max(0, min(ir_len - l0_len, K_L1_MAX_PARTS * l1_part)) if tail_enabled else 0
    l2_len = max(0, ir_len - l0_len - l1_len) if tail_enabled else 0

    # Air-absorption HF damping coefficients (cpp:1063-1072)
    if tail_enabled and tail_mode == TAIL_AIR_ABSORPTION:
        start_norm = float(np.clip(tail_start / 0.085, 0.65, 1.55))
        damping_base = (0.35 + 1.10 * strength01) * start_norm
        dampings = [None, damping_base * 1.0, damping_base * 1.6]
    else:
        dampings = [None, None, None]

    cfg = [(0, l0_len, l0_part, 1.0, dampings[0]),
           (l0_len, l1_len, l1_part, l1_gain, dampings[1]),
           (l0_len + l1_len, l2_len, l2_part, l2_gain, dampings[2])]
    layers = tuple(NUCLayerPlan(offset=o, length=ln, part_size=p,
                                num_parts=-(-ln // p), gain=g, damping=d)
                   for (o, ln, p, g, d) in cfg if ln > 0)

    direct_part = next_pow2(max(block_size, 64))
    direct_taps = (min(ir_len, min(direct_part, K_MAX_DIRECT_TAPS))
                   if enable_direct_head else 0)

    return NUCPlan(layers=layers, direct_taps=direct_taps,
                   latency=l0_part, block_size=block_size, ir_len=ir_len)


def spectrum_filter_gain(fft_size: int, spec: FilterSpec) -> np.ndarray:
    """HC/LC gain curve on one layer's FFT grid (applySpectrumFilter,
    cpp:336-440).  Host NumPy (exact libm)."""
    fs = spec.sample_rate
    nyq = fs * 0.5
    n = fft_size
    half = n // 2
    csize = half + 1
    gain = np.ones(csize)

    hc_start = 18000.0 if fs <= 48000.0 else 22000.0
    k_start = int(round(hc_start * n / fs))
    k_end = min(half, int(round(nyq * n / fs)))
    k = np.arange(csize)
    in_roll = (k > k_start) & (k <= k_end)
    x = (k - k_start) / max(1, (k_end - k_start))
    if spec.hc_mode == HC_SHARP:
        roll = 1.0 / np.sqrt(1.0 + np.power(x, 8.0))
    elif spec.hc_mode == HC_NATURAL:
        roll = 0.5 * (1.0 + np.cos(np.pi * x))
    else:
        roll = np.exp(-4.60517 * x * x)
    gain = np.where(in_roll, roll, gain)

    lc_end_f = 6.0 if spec.lc_mode == LC_SOFT else 8.0
    lc_start_f = 15.0 if spec.lc_mode == LC_SOFT else 18.0
    k_lc_end = int(round(lc_end_f * n / fs))
    k_lc_start = int(round(lc_start_f * n / fs))
    gain = np.where(k <= k_lc_end, 0.0, gain)
    ramp_zone = (k > k_lc_end) & (k < k_lc_start)
    xr = (k - k_lc_end) / max(1, k_lc_start - k_lc_end)
    g_lc = 0.5 * (1.0 - np.cos(np.pi * xr))
    gain = np.where(ramp_zone, gain * g_lc, gain)
    return gain


@dataclass
class NUCState:
    """Prepared NUC instance: plan + per-layer partition spectra
    ((num_parts, p+1) complex tensors on the device that runs it)."""
    plan: NUCPlan
    layer_spectra: list


def nuc_prepare_uniform(ir, part_size: int, block_size: int = 512,
                        device="cuda") -> NUCState:
    """Single-layer uniform plan: plain exact partitioned convolution.

    The offline throughput plan (models/chain.py::throughput_partition_size):
    one uniform layer, unit gain, no spectrum filter — for callers that have
    already baked every gain/filter into `ir` itself (the folded
    static-config mode).  `ir` is a host tensor; its dtype is the
    spectra's working precision."""
    ir = torch.as_tensor(ir)
    n = int(ir.shape[-1])
    nparts = -(-n // part_size)
    plan = NUCPlan(
        layers=(NUCLayerPlan(offset=0, length=n, part_size=part_size,
                             num_parts=nparts, gain=1.0, damping=None),),
        direct_taps=0, latency=part_size, block_size=block_size, ir_len=n)
    H = partition_spectra(ir, part_size, nparts, dtype=ir.dtype,
                          device=device)
    return NUCState(plan=plan, layer_spectra=[H])


def nuc_convolve(x, state: NUCState, frame_mac="auto"):
    """Offline NUC convolution of x (..., N) -> (..., N).

    Layer li contributes  gain_li * OS_conv(x, H_li)[n - offset_li]
    (every layer at its exact convolution offset).  `frame_mac` passes
    through to `uniform_partitioned_conv`."""
    if state.plan.direct_taps:
        raise NotImplementedError("the direct head is not ported yet")
    n = x.shape[-1]
    y = None
    for lp, H in zip(state.plan.layers, state.layer_spectra):
        yl = uniform_partitioned_conv(x, H, lp.part_size, frame_mac)
        if lp.offset > 0:
            yl = F.pad(yl, (lp.offset, 0))[..., :n]
        if lp.gain != 1.0:
            yl = lp.gain * yl
        y = yl if y is None else y + yl
    return torch.zeros_like(x) if y is None else y
