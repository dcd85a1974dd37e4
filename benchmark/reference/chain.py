"""The plain reference of the folded and semi-folded chains: the fold of
the configuration's IR, DC blockers, EQ, output filter and HC/LC curve
into one response a channel (host NumPy f64), and the chain on a signal
in f64 PyTorch on any device, one long FFT convolution a row.

It follows what the configuration states, not how the program runs it:
no partitions, no frames, no kernels.  The fold keeps the program's
stated truncation (the LTI prefilter cut where its slowest pole has
decayed to 1e-10), which is far under the f32 floor.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import coeffs as C

EPS = 1e-10


def prefilter_ir(sr: float, eq: dict | None, spec: dict, chain: dict,
                 dc_passes: int) -> np.ndarray:
    """Impulse response of the folded LTI stages: `dc_passes` passes of
    the 3 Hz DC blocker, the EQ, the output filter (convolver last), the
    HC/LC curve, truncated where the slowest pole falls under EPS."""
    stages = [c for c in C.output_filter_stages(
        sr, True, chain.get("conv_hc_mode", C.HC_NATURAL),
        chain.get("conv_lc_mode", C.LC_NATURAL),
        chain.get("eq_lpf_mode", C.HC_NATURAL)) if tuple(c) != C.IDENTITY]
    radii = [1.0 - a for a in C.dc_blocker_alphas(sr, 3.0)]
    radii += [C.biquad_pole_radius(c[3], c[4]) for c in stages]
    rmax = min(max(radii), 1.0 - 1e-12)
    tail = max(int(np.ceil(np.log(EPS) / np.log(rmax))),
               C.eq_ring_tail(eq, sr, EPS) if eq is not None else 0, 256)
    m = C.next_pow2(2 * tail)
    z = np.exp(1j * 2.0 * np.pi * np.arange(m // 2 + 1) / m)
    H = np.ones(m // 2 + 1, complex)
    for _ in range(dc_passes):
        H = H * C.dc_blocker_response(z, sr, 3.0)
    for b0, b1, b2, a1, a2 in stages:
        H = H * (b0 * z * z + b1 * z + b2) / (z * z + a1 * z + a2)
    if eq is not None:
        H = H * C.eq_response(eq, sr, np.arange(m // 2 + 1) * (sr / m))
    H = H * C.spectrum_filter_gain(m, spec)
    return np.fft.irfft(H, n=m)[:tail]


def folded_ir(ir: np.ndarray, block_size: int, sr: float, eq: dict | None,
              spec: dict, chain: dict, dc_passes: int) -> np.ndarray:
    """(2, len(ir) + tail - 1) f64: the IR with its layer gains baked in,
    convolved with `prefilter_ir`."""
    ir = np.asarray(ir, np.float64)
    h = ir.copy()
    for off, n, g in C.layer_gains(ir.shape[-1], block_size, spec):
        h[:, off:off + n] *= g
    g = prefilter_ir(sr, eq, spec, chain, dc_passes)
    n = ir.shape[-1] + g.shape[0] - 1
    m = C.next_pow2(n)
    return np.fft.irfft(np.fft.rfft(h, m) * np.fft.rfft(g, m), m)[:, :n]


def sanitize(x):
    """The input stage: clamp to +-1, flush |x| < 1e-20 to 0."""
    x = x.clamp(-1.0, 1.0)
    return torch.where(x.abs() >= 1e-20, x, torch.zeros_like(x))


def fft_conv(x, h, n_fft: int | None = None):
    """Rows x (R, N) convolved with h (L,) (same device), first N
    samples, in x's precision through one FFT of next_pow2(N + L - 1)."""
    n = x.shape[-1]
    m = n_fft or C.next_pow2(n + h.shape[-1] - 1)
    return torch.fft.irfft(torch.fft.rfft(x, m) * torch.fft.rfft(h, m),
                           m)[..., :n]


def _fast_tanh_clip(x):
    x = x.clamp(-4.5, 4.5)
    x2 = x * x
    return x * (10395.0 + x2 * (1260.0 + x2 * 21.0)) / (
        10395.0 + x2 * (4725.0 + x2 * (210.0 + x2)))


def soft_clip(x, threshold: float, knee: float, asym: float):
    """The memoryless musical clip (DSPCoreDouble.cpp:107-224)."""
    ax = x.abs()
    sign = torch.where(x > 0.0, 1.0, -1.0).to(x.dtype)
    t = ((ax - (threshold - knee)) / (2.0 * knee)).clamp(0.0, 1.0)
    ks = t * t * (3.0 - 2.0 * t)
    clipped = threshold + knee * _fast_tanh_clip((ax - threshold) / knee)
    y = sign * (ax + (clipped - ax) * ks) * (
        1.0 - asym * (1.0 - sign) * 0.5 * ks)
    return torch.where(ax > threshold - knee, y, x)


def _fir(x, taps):
    """Valid part of y[k] = sum_s taps[s] x[k + len(taps) - 1 - s]."""
    w = torch.as_tensor(taps[::-1].copy(), dtype=x.dtype, device=x.device)
    return F.conv1d(x.unsqueeze(-2), w.reshape(1, 1, -1)).squeeze(-2)


def soft_clip_local2x(x, saturation: float):
    """The local 2x clip: the 31-tap halfband up, the clip, the halfband
    down, zero history, as its polyphase identity
    y[n] = 0.5 clip(0.5 x[n-15]) + sum_r c[r] clip(2 sum_s c[s] x[n-r-s])."""
    c = C.halfband_conv_taps()
    p = C.soft_clip_params(saturation)
    xp = F.pad(x, (30, 0))
    ue = soft_clip(2.0 * _fir(xp, c), *p)
    return 0.5 * soft_clip(0.5 * xp[..., 15:15 + x.shape[-1]], *p) \
        + _fir(ue, c)


def dc_block(x, sr: float, cutoff_hz: float = 3.0):
    """The two-section DC blocker from zero state, by its frequency
    response on a grid long enough that the IIR's wrap-around (its tail
    beyond the grid) is under 1e-17 of the input."""
    n = x.shape[-1]
    a = min(C.dc_blocker_alphas(sr, cutoff_hz))
    m = C.next_pow2(n + int(np.ceil(np.log(1e-17) / np.log1p(-a))))
    z = np.exp(1j * 2.0 * np.pi * np.arange(m // 2 + 1) / m)
    H = torch.as_tensor(C.dc_blocker_response(z, sr, cutoff_hz),
                        device=x.device)
    return torch.fft.irfft(torch.fft.rfft(x, m) * H, m)[..., :n]


def run_chain(x, h, cfg: dict, sr: float, rows: int = 8, rnd=None):
    """The reference chain on x (B, 2, N) in x's precision (f64 for the
    reference), h (2, L) the folded IR on x's device.  Folded: sanitize
    -> gains -> conv -> gains.  Semi-folded (soft clip on): sanitize ->
    gains -> conv -> makeup -> local 2x clip -> 3 Hz DC blocker ->
    headroom.  Rows go `rows` at a time, so the long FFTs fit.  rnd, when
    given, rounds each stage's output (the control's lower precision)."""
    rnd = rnd or (lambda t: t)
    pre = cfg.get("input_headroom_gain", 1.0) * cfg.get(
        "convolver_input_trim_gain", 1.0)
    wet = C.equal_power_sin(1.0) * C.CONVOLUTION_HEADROOM_GAIN
    makeup = cfg.get("output_makeup_gain", 1.0)
    head = C.K_OUTPUT_HEADROOM if cfg.get("apply_output_headroom",
                                          True) else 1.0
    out = torch.empty_like(x)
    for ch in range(2):
        for r0 in range(0, x.shape[0], rows):
            xs = rnd(sanitize(x[r0:r0 + rows, ch]) * pre)
            y = rnd(fft_conv(xs, h[ch]) * wet * makeup)
            if cfg.get("soft_clip_enabled", False):
                y = rnd(dc_block(rnd(soft_clip_local2x(
                    y, cfg.get("saturation_amount", 0.0))), sr))
            out[r0:r0 + rows, ch] = rnd(y * head)
    return out
