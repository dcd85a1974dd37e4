"""Non-Uniform Partitioned Convolution (NUC) — the 3-layer convolver and
the uniform single-layer form (counterpart of convopeq_tpu/models/nuc.py).

- Layer sizing of SetImpulse (`plan_layers`, MKLNonUniformConvolver.cpp:
  624-768): L0 of <= 32 partitions at nextPow2(max(block, 64)), L1 of
  <= 64 at L0 x mult, L2 at L1 x mult for the rest, with the contour
  gains of the tail mode.
- `nuc_prepare`: per-layer partition spectra, scaled by `scale`, with the
  HC/LC spectrum filter (`spectrum_filter_gain`, cpp:336-440) and, in
  air-absorption mode, each tail layer's HF damping
  (`air_absorption_gain`, cpp:1062-1100), applied to the spectra (per
  partition, circular, as the reference does); the <= 32-tap direct head
  (cpp:693-733) is cut out of the FFT path and kept in the time domain.
- `nuc_prepare_uniform`: the single-layer throughput plan.
- `nuc_convolve`: every layer at its exact offset and gain
  (tail_delivery="exact"), or on the reference's amortized tail-delivery
  schedule (`tail_delivery_map`, tail_delivery="reference"), plus the
  direct head at zero delay.

Rebuild-time work (plans, spectra, gain curves) is host NumPy / CPU
torch in the spectra's dtype; the spectra then move to the device that
runs them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
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


def air_absorption_gain(fft_size: int, damping: float) -> np.ndarray:
    """Per-layer HF damping e^{-c x^2}, x = k/(csize-1) (cpp:1080-1090)."""
    csize = fft_size // 2 + 1
    x = np.arange(csize) / max(1, csize - 1)
    return np.exp(-damping * x * x)


@dataclass
class NUCState:
    """Prepared NUC instance: plan, per-layer partition spectra
    ((num_parts, p+1) complex tensors on the device that runs it) and the
    direct head's taps (or None)."""
    plan: NUCPlan
    layer_spectra: list
    direct_ir: torch.Tensor | None = None


def nuc_prepare(ir, block_size: int, spec: FilterSpec | None = None,
                scale: float = 1.0, enable_direct_head: bool = False,
                apply_spectrum_filter: bool = True,
                unit_layer_gains: bool = False, dtype=None,
                device="cuda") -> NUCState:
    """SetImpulse equivalent for one channel: plan the layers, partition
    the IR and precompute the filtered spectra.

    ir: (N,) mono, host array or CPU tensor; its dtype (or `dtype`) is
    the spectra's working precision.  unit_layer_gains=True keeps the
    layer sizing but sets every contour gain to 1.0 (a plain exact
    convolution with `ir`, for callers that bake the gains into the IR).
    """
    if spec is None:
        spec = FilterSpec()
        apply_spectrum_filter = False
    ir = torch.as_tensor(ir).to("cpu")
    if dtype is not None:
        ir = ir.to(dtype)
    plan = plan_layers(int(ir.shape[-1]), block_size, spec,
                       enable_direct_head)
    if unit_layer_gains:
        plan = replace(plan, layers=tuple(replace(lp, gain=1.0)
                                          for lp in plan.layers))
    dev = resolve_device(device)
    direct_ir = None
    ir_fft = ir
    if plan.direct_taps > 0:
        direct_ir = (ir[:plan.direct_taps] * scale).to(dev)
        ir_fft = ir.clone()
        ir_fft[:plan.direct_taps] = 0.0

    spectra = []
    for lp in plan.layers:
        seg = ir_fft[lp.offset:lp.offset + lp.length]
        H = partition_spectra(seg, lp.part_size, lp.num_parts,
                              dtype=ir.dtype, device="cpu")
        gain = np.ones(lp.part_size + 1)
        if scale != 1.0:
            gain = gain * scale
        if apply_spectrum_filter:
            gain = gain * spectrum_filter_gain(2 * lp.part_size, spec)
        if lp.damping is not None:
            gain = gain * air_absorption_gain(2 * lp.part_size, lp.damping)
        spectra.append((H * torch.as_tensor(gain, dtype=ir.dtype)).to(dev))
    return NUCState(plan=plan, layer_spectra=spectra, direct_ir=direct_ir)


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


def tail_delivery_map(part_size: int, block_size: int, num_parts: int,
                      out_delay: int, nblocks: int) -> np.ndarray:
    """Discrete-event model of the reference's B13 tail delivery protocol
    (MKLNonUniformConvolver.cpp:988-1010, 1500-1545, 1659-1689).

    Each tail layer is an overlap-save FDL on its own partition clock
    whose MAC is amortized over callbacks; chunk m (conv output
    [m*P, (m+1)*P) of the layer's segment) is written in callback
    (m+1)*blocksPerPart - 1 + (macCallbacks-1), and Get() reads it back
    with readCursor = max(readCursor, writeCursor - outputDelaySamples).
    Every tail layer so arrives at a constant shift from its exact
    position (e.g. +1408 samples late for a 64-partition L1, 230528
    samples early for the L2 of a 600k-tap IR at block 512).

    Returns an int64 array mapping output sample index -> index into the
    layer's exact convolution, or -1 where the reference delivers nothing
    (warm-up stalls, clamp drops)."""
    part, block = part_size, block_size
    bpp = -(-part // block)                       # blocksPerPart
    ppc = min(num_parts, max(1, -(-num_parts // bpp)))
    macs = -(-num_parts // ppc)                   # callbacks per chunk MAC
    writes = {}
    m = 0
    while True:
        wb = (m + 1) * bpp - 1 + (macs - 1)
        if wb >= nblocks:
            break
        writes[wb] = writes.get(wb, 0) + part
        m += 1
    out = np.full(nblocks * block, -1, dtype=np.int64)
    wc = 0
    rc = 0
    for b in range(nblocks):
        wc += writes.get(b, 0)
        start = max(rc, max(0, wc - out_delay))
        if start + block <= wc:
            out[b * block:(b + 1) * block] = np.arange(start, start + block)
            rc = start + block
    return out


def direct_head(x, taps):
    """y[n] = sum_j taps[j] x[n-j] over the last axis, zero before the
    start: the <= 32-tap head at zero delay.  The JAX package writes it
    as a shift-accumulate that XLA fuses into one pass; eager, that would
    be 2 x 32 passes over the signal, so here the same sum is one
    conv1d (TF32 off on the card)."""
    K = taps.shape[0]
    n = x.shape[-1]
    xp = F.pad(x.reshape(-1, 1, n), (K - 1, 0))
    y = F.conv1d(xp, taps.flip(0).reshape(1, 1, K).to(x.dtype))
    return y.reshape(x.shape)


def nuc_convolve(x, state: NUCState, frame_mac="auto",
                 tail_delivery: str = "exact"):
    """Offline NUC convolution of x (..., N) -> (..., N).

    Layer li contributes  gain_li * OS_conv(x, H_li)[n - offset_li]
    (every layer at its exact convolution offset), and the direct head
    contributes at zero delay.  tail_delivery="reference" delivers the
    tail layers on the reference's amortized schedule
    (`tail_delivery_map`) instead, reproducing the reference binary's
    streamed output sample for sample; samples past the last whole plan
    block then get no tail contribution.  `frame_mac` passes through to
    `uniform_partitioned_conv`."""
    if tail_delivery not in ("exact", "reference"):
        raise ValueError(f"tail_delivery: {tail_delivery!r}")
    n = x.shape[-1]
    y = None
    for li, (lp, H) in enumerate(zip(state.plan.layers, state.layer_spectra)):
        yl = uniform_partitioned_conv(x, H, lp.part_size, frame_mac)
        if tail_delivery == "reference" and li > 0:
            block = state.plan.block_size
            mp = np.full(n, -1, np.int64)
            nb = n // block
            mp[:nb * block] = tail_delivery_map(
                lp.part_size, block, lp.num_parts, lp.offset, nb)
            idx = torch.from_numpy(np.maximum(mp, 0)).to(x.device)
            valid = torch.from_numpy(mp >= 0).to(x.device)
            yl = torch.where(valid, yl.index_select(-1, idx), 0.0)
        elif lp.offset > 0:
            yl = F.pad(yl, (lp.offset, 0))[..., :n]
        if lp.gain != 1.0:
            yl = lp.gain * yl
        y = yl if y is None else y + yl
    if y is None:
        y = torch.zeros_like(x)
    if state.direct_ir is not None:
        y = y + direct_head(x, state.direct_ir)
    return y
