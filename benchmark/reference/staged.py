"""The plain reference of the application's staged chain at 1x, the chain
that `ConvoPeqEngine.process` runs before its dither: sanitize -> input
gain -> 3 Hz DC blocker -> the 20-band EQ -> trim gain -> the 3-layer
NUC with its spectrum filter, and the wet gain -> the output filter
(convolver last: the HC and LC biquads) -> makeup gain -> the local 2x
soft clip -> 3 Hz DC blocker.  There is no output headroom: the dither
applies it.  Plain PyTorch on any device, in x's precision (f64 for the
reference), TF32 off.

It follows what the configuration states, not how the program runs it:
no kernels, no partitions kept between calls, and every LTI stage but
the NUC applied by its frequency response on one long grid a row:
- the DC blockers as `chain.dc_block` does (wrap-around under 1e-17);
- the EQ by `coeffs.eq_response` on next_pow2(N + its 1e-10 ring tail)
  points;
- the output filter's biquads by their transfer functions on a grid
  whose wrap-around is under 1e-17 of the input.
The NUC is built from the prepared IR, layer by layer from
`coeffs.layer_gains` (offset, length, contour gain): the layer's segment
cut into partitions of p, each zero-padded to 2p, transformed and
multiplied by `coeffs.spectrum_filter_gain(2p)` (a filter circular per
partition, as ConvoPeq's SetImpulse applies it), then textbook
overlap-save on frames of 2p aligned at the signal's start, Y_j =
sum_k X_{j-k} H_k, the last p samples of each inverse kept, the layer's
output delayed by its offset and scaled by its gain; the wet gain is
`equal_power_sin(1)`.

The IR and the gains come from the configuration alone, through the
plain copies of the application's set-up in `loader.py`: the raw IR
trimmed to its length with the loader's fade and scaled as a first load
scales it, and the auto-gain plan for EQ -> convolver from the EQ's gain
estimates and the prepared IR's frequency-response peak.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import chain as R
from . import coeffs as C
from . import loader as L

EQ_EPS = 1e-10
WRAP_EPS = 1e-17


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def layer_parts(block_size: int, spec: dict):
    """The partition size of each of SetImpulse's three layers
    (MKLNonUniformConvolver.cpp:738-768): nextPow2(max(block, 64)), then
    x the L1/L2 multiplier (at least 8 in contour mode) twice."""
    mult = int(np.clip(spec.get("tail_l1l2_multiplier", 8), 2, 16))
    if int(np.clip(spec.get("tail_mode", C.TAIL_CONTOUR), 0, 2)) == \
            C.TAIL_CONTOUR:
        mult = max(mult, 8)
    p0 = C.next_pow2(max(block_size, 64))
    return p0, p0 * mult, p0 * mult * mult


def nuc_layers(ir: np.ndarray, block_size: int, spec: dict, device,
               dtype=torch.float64):
    """[(offset, p, gain, H (P, p+1))] of one channel's NUC: H the
    spectrum-filtered partition spectra in `dtype`'s complex type on
    `device`."""
    ir = np.asarray(ir, np.float64)
    out = []
    parts = layer_parts(block_size, spec)
    for (off, n, g), p in zip(C.layer_gains(ir.shape[-1], block_size, spec),
                              parts):
        P = -(-n // p)
        seg = np.zeros(P * p)
        seg[:n] = ir[off:off + n]
        H = np.fft.rfft(np.pad(seg.reshape(P, p), ((0, 0), (0, p))), axis=-1)
        H = H * C.spectrum_filter_gain(2 * p, spec)
        out.append((off, p, g, torch.as_tensor(H).to(device,
                                                     _complex_of(dtype))))
    return out


def overlap_save(x, H, p: int):
    """x (R, N) through one layer's partitions H (P, p+1): frames j of
    [x block j-1 | x block j] (zero before the start), Y_j = sum_{k <= j}
    X_{j-k} H_k, the last p samples of each frame's inverse."""
    n = x.shape[-1]
    K = -(-n // p)
    xb = F.pad(x, (p, K * p - n)).unfold(-1, 2 * p, p)      # (R, K, 2p)
    X = torch.fft.rfft(xb, dim=-1)
    Y = torch.zeros_like(X)
    for k in range(min(H.shape[0], K)):
        Y[..., k:, :] += X[..., :K - k, :] * H[k]
    y = torch.fft.irfft(Y, n=2 * p, dim=-1)[..., p:]
    return y.reshape(x.shape[:-1] + (K * p,))[..., :n]


def nuc(x, layers):
    """x (R, N) through one channel's NUC from `nuc_layers`: each layer
    convolves the whole signal, then is delayed by its offset."""
    n = x.shape[-1]
    y = torch.zeros_like(x)
    for off, p, g, H in layers:
        if off < n:
            y[..., off:] += g * overlap_save(x, H, p)[..., :n - off]
    return y


def _grid(m: int) -> np.ndarray:
    """The m-point grid's frequencies up to Nyquist, in cycles a
    sample."""
    return np.arange(m // 2 + 1) / m


def dc_block_response(n: int, sr: float):
    """(H, m): the 3 Hz DC blocker on a grid long enough for N = n
    samples that its wrap-around is under 1e-17, as `chain.dc_block`."""
    a = min(C.dc_blocker_alphas(sr, 3.0))
    m = C.next_pow2(n + int(np.ceil(np.log(WRAP_EPS) / np.log1p(-a))))
    return C.dc_blocker_response(np.exp(2j * np.pi * _grid(m)), sr, 3.0), m


def eq_response(n: int, eq_params: dict, sr: float):
    """(H, m): the EQ's bands (all stereo, serial) on next_pow2(n + their
    1e-10 ring tail) points."""
    m = C.next_pow2(n + C.eq_ring_tail(eq_params, sr, EQ_EPS))
    return C.eq_response(eq_params, sr, _grid(m) * sr), m


def output_filter_response(n: int, sr: float, chain: dict):
    """(H, m): the output filter with the convolver last, the two HC
    lowpasses and the LC highpass of `chain`'s modes, on a grid whose
    wrap-around is under 1e-17 of the input."""
    stages = [c for c in C.output_filter_stages(
        sr, True, chain.get("conv_hc_mode", C.HC_NATURAL),
        chain.get("conv_lc_mode", C.LC_NATURAL),
        chain.get("eq_lpf_mode", C.HC_NATURAL)) if tuple(c) != C.IDENTITY]
    r = min(max(C.biquad_pole_radius(c[3], c[4]) for c in stages),
            1.0 - 1e-12)
    m = C.next_pow2(n + int(np.ceil(np.log(WRAP_EPS) / np.log(r))))
    z = np.exp(2j * np.pi * _grid(m))
    H = np.ones(z.shape, complex)
    for b0, b1, b2, a1, a2 in stages:
        H = H * (b0 * z * z + b1 * z + b2) / (z * z + a1 * z + a2)
    return H, m


def through(x, H, m: int):
    """x (R, N) through the response H (m // 2 + 1 bins: NumPy, or a
    tensor of x's complex type on its device), first N samples."""
    H = torch.as_tensor(H).to(x.device, _complex_of(x.dtype))
    return torch.fft.irfft(torch.fft.rfft(x, m) * H, m)[..., :x.shape[-1]]


class StagedReference:
    """The reference chain of one configuration on `device`: the raw IR
    (C, L) prepared as the loader prepares it (`ir_round`, when given,
    rounds the prepared IR: the control's lower precision), the gains
    planned from it, its NUC layers built once, f64 or `dtype`."""

    def __init__(self, cfg: dict, ir: np.ndarray, device,
                 dtype=torch.float64, ir_round=None):
        self.sr = float(cfg["sample_rate"])
        self.chain = cfg["chain"]
        self.eq = C.eq_params(cfg["eq_gains_db"])
        ir = np.atleast_2d(np.asarray(ir, np.float64))
        prepared, peak_db = L.prepare_ir(ir, self.sr, ir.shape[-1] / self.sr)
        if prepared.shape[0] == 1:
            prepared = np.repeat(prepared, 2, axis=0)
        if ir_round is not None:
            prepared = ir_round(torch.as_tensor(prepared)).double().numpy()
        spec = {"sample_rate": self.sr, **cfg.get("filter_spec", {})}
        self.layers = [nuc_layers(prepared[ch], int(cfg["block_size"]),
                                  spec, device, dtype) for ch in range(2)]
        self.g_in, self.g_makeup, self.g_trim = L.auto_gain_eq_conv(
            self.eq, self.sr, peak_db) if self.chain.get("auto_gain") \
            else (1.0, 1.0, 1.0)
        self.wet = C.equal_power_sin(1.0) * C.CONVOLUTION_HEADROOM_GAIN
        self.clip = self.chain.get("saturation_amount", 0.0) \
            if self.chain.get("soft_clip_enabled", False) else None
        self._responses = {}

    def _response(self, x, name: str, make):
        """A stage's (H, m) for x's length, on x's device in its complex
        type, made once (the host responses of a long grid take
        seconds)."""
        key = (name, x.shape[-1], x.dtype, x.device)
        if key not in self._responses:
            H, m = make(x.shape[-1])
            self._responses[key] = (torch.as_tensor(H).to(
                x.device, _complex_of(x.dtype)), m)
        return self._responses[key]

    def __call__(self, x, rnd=None):
        """x (B, 2, N) -> the chain's output y (B, 2, N) in x's type;
        rnd, when given, rounds each stage's output (the control's lower
        precision)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rnd = rnd or (lambda t: t)
        sr = self.sr
        dc = self._response(x, "dc", lambda n: dc_block_response(n, sr))
        eq = self._response(x, "eq",
                            lambda n: eq_response(n, self.eq, sr))
        of = self._response(x, "output_filter",
                            lambda n: output_filter_response(n, sr,
                                                             self.chain))
        out = torch.empty_like(x)
        for ch in range(2):
            v = rnd(R.sanitize(x[:, ch]) * self.g_in)
            v = rnd(through(v, *dc))
            v = rnd(through(v, *eq) * self.g_trim)
            v = rnd(nuc(v, self.layers[ch]) * self.wet)
            v = rnd(through(v, *of) * self.g_makeup)
            if self.clip is not None:
                v = rnd(R.soft_clip_local2x(v, self.clip))
            out[:, ch] = rnd(through(v, *dc))
        return out
