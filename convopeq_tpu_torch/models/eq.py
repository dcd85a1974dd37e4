"""20-band parametric EQ (counterpart of convopeq_tpu/models/eq.py).

Host part (NumPy f64): parameters, the band-activity rule, the 2x2
band-matrix response and the ring-tail length that the folded chain
bakes into the IR.

Signal part, x (..., 2, N) with time last, on x's device:
- `eq_process_bands(method="scan")`, and "auto" with saturation > 0: the
  band cascade, each active band one `svf_process` (serial in band
  order, or parallel: out = src + sum_b (band_b(src) - src)), mid/side
  and single-channel bands as in the reference.
- `eq_process_bands(method="fft")`, and "auto" with saturation 0:
  `eq_process_bands_fft`, the combined 2x2 response applied as one
  convolution, zero-padded by the ring tail of the active bands
  (`_eq_ring_tail_samples`, eps 1e-10).  Its route:
  - f32 on a CUDA tensor with N >= 4 x tail: `_eq_fft_blocked`, the
    truncated 2x2 impulse response through `uniform_partitioned_conv`
    (p = next_pow2(tail / 4) clipped to [1024, 8192]; eq20 at 48 kHz:
    tail 7,903, p = 2048, P = 4, the fused kernel), as the JAX package
    does on its accelerator;
  - f32 otherwise (a CPU tensor, or a short one): one rfft/irfft over
    next_pow2(N + tail) with the response evaluated in complex64;
  - f64: the same with the host f64 response (torch.fft D2Z / Z2D), the
    JAX package's CPU exactness route.  Its accelerator reroute of f64 to
    the scan exists because the TPU has no f64 FFT, and is not ported.
- `agc_apply`: the block-rate AGC, its envelope recurrence a loop over
  the N / block_size blocks on the device.
The responses and the blocked route's partition spectra depend only on
the parameters and the size: they are cached by content (what XLA
constant-folds in the JAX package's compiled chain).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import svf as svf_ops
from ..ops.svf import svf_coeffs, svf_process
from ..utils.dsputil import device_constants, next_pow2

NUM_BANDS = 20
# Channel modes (EQProcessor.h: enum class EQChannelMode)
STEREO, LEFT, RIGHT, MID, SIDE = 0, 1, 2, 3, 4
# Structures (EQProcessor.h: enum class FilterStructure)
SERIAL, PARALLEL = 0, 1

# Default band frequencies (EQProcessor.h:158-163)
DEFAULT_FREQS = np.array([
    25.0, 40.0, 63.0, 100.0, 160.0,
    250.0, 400.0, 630.0, 1000.0, 1600.0,
    2500.0, 4000.0, 6300.0, 10000.0, 11000.0,
    12500.0, 14000.0, 16500.0, 18000.0, 19500.0,
])
DEFAULT_Q = 0.707

# AGC constants (EQProcessor.h:166-171, Processing.cpp:343-446)
AGC_ATTACK_TIME_SEC = 0.2
AGC_RELEASE_TIME_SEC = 2.0
AGC_SMOOTH_TIME_SEC = 0.2
AGC_MIN_GAIN = 0.06
AGC_MAX_GAIN = 16.0
AGC_MAX_ENV = 1000.0
AGC_MIN_ENV = 1e-6
AGC_DEAD_ZONE_RATIO = 1.059
AGC_DENORM = 1.0e-20


@dataclass
class EQParams:
    """Full EQ parameter set (mirrors the reference EQState snapshot)."""
    band_types: np.ndarray = field(
        default_factory=lambda: np.full(NUM_BANDS, svf_ops.PEAKING, np.int32))
    freqs: np.ndarray = field(default_factory=lambda: DEFAULT_FREQS.copy())
    gains_db: np.ndarray = field(default_factory=lambda: np.zeros(NUM_BANDS))
    qs: np.ndarray = field(default_factory=lambda: np.full(NUM_BANDS, DEFAULT_Q))
    modes: np.ndarray = field(default_factory=lambda: np.zeros(NUM_BANDS, np.int32))
    enabled: np.ndarray = field(default_factory=lambda: np.ones(NUM_BANDS, bool))
    structure: int = SERIAL
    saturation: float = 0.0
    agc_enabled: bool = False

    def set_band(self, i, band_type=None, freq=None, gain_db=None, q=None,
                 mode=None, enabled=None):
        if band_type is not None:
            self.band_types[i] = band_type
        if freq is not None:
            self.freqs[i] = freq
        if gain_db is not None:
            self.gains_db[i] = gain_db
        if q is not None:
            self.qs[i] = q
        if mode is not None:
            self.modes[i] = mode
        if enabled is not None:
            self.enabled[i] = enabled
        return self

    def config_key(self):
        """Hashable content key (the reference's EQCoeffCache paramsHash,
        EQProcessor.h:121-138)."""
        return (self.band_types.tobytes(), self.freqs.tobytes(),
                self.gains_db.tobytes(), self.qs.tobytes(),
                self.modes.tobytes(), self.enabled.tobytes(),
                self.structure, float(self.saturation), bool(self.agc_enabled))


def band_active_mask(params: EQParams) -> np.ndarray:
    """createBandNode activity rule (EQProcessor.Coefficients.cpp:35-53).

    The gain skip compares the float32 band gain against 0.01f.
    """
    types = np.asarray(params.band_types)
    gains_f32 = np.abs(np.asarray(params.gains_db, np.float32))
    not_passband = (types != svf_ops.LOW_PASS) & (types != svf_ops.HIGH_PASS)
    tiny_gain = gains_f32 < np.float32(0.01)
    return np.asarray(params.enabled, bool) & ~(not_passband & tiny_gain)


def _band_matrix_response(params: EQParams, sample_rate, freqs):
    """2x2 complex MIMO response of the active bands at `freqs` (host f64).

    Every channel mode is a 2x2 LTI map on (L, R):
      Stereo: diag(H, H); Left: diag(H, 1); Right: diag(1, H);
      Mid:  [[(H+1)/2, (H-1)/2], [(H-1)/2, (H+1)/2]]
      Side: [[(H+1)/2, (1-H)/2], [(1-H)/2, (H+1)/2]]
    Serial structure = ordered matrix product; Parallel = I + sum(T_b - I).
    Returns (h11, h12, h21, h22) complex128 arrays.
    """
    from ..engine.eq_analysis import svf_to_biquad, biquad_response
    active = band_active_mask(params)
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    nf = len(freqs)
    eye = (np.ones(nf, complex), np.zeros(nf, complex),
           np.zeros(nf, complex), np.ones(nf, complex))

    def band_T(b):
        bq = svf_to_biquad(*(float(c[b]) for c in coeffs))
        H = biquad_response(bq, freqs, sample_rate)
        mode = int(params.modes[b])
        one = np.ones(nf, complex)
        if mode == STEREO:
            return (H, 0 * H, 0 * H, H)
        if mode == LEFT:
            return (H, 0 * H, 0 * H, one)
        if mode == RIGHT:
            return (one, 0 * H, 0 * H, H)
        if mode == MID:
            return ((H + 1) / 2, (H - 1) / 2, (H - 1) / 2, (H + 1) / 2)
        return ((H + 1) / 2, (1 - H) / 2, (1 - H) / 2, (H + 1) / 2)  # SIDE

    def mat_mul(a, b):
        a11, a12, a21, a22 = a
        b11, b12, b21, b22 = b
        return (a11 * b11 + a12 * b21, a11 * b12 + a12 * b22,
                a21 * b11 + a22 * b21, a21 * b12 + a22 * b22)

    if params.structure == SERIAL:
        T = eye
        for b in range(NUM_BANDS):
            if active[b]:
                T = mat_mul(band_T(b), T)   # band applied after T
        return T
    acc = [np.zeros(nf, complex) for _ in range(4)]
    for b in range(NUM_BANDS):
        if not active[b]:
            continue
        Tb = band_T(b)
        for i in range(4):
            acc[i] = acc[i] + (Tb[i] - eye[i])
    return tuple(eye[i] + acc[i] for i in range(4))


def _eq_ring_tail_samples(params: EQParams, sample_rate, eps=1e-10):
    """Padding needed so truncated IIR ringing is below eps: from the max
    pole radius of the active bands (host-side, static)."""
    active = band_active_mask(params)
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    max_r = 0.0
    for b in range(NUM_BANDS):
        if not active[b]:
            continue
        A = np.array([[2 * coeffs[0][b] - 1.0, -2 * coeffs[1][b]],
                      [2 * coeffs[1][b], 1.0 - 2 * coeffs[2][b]]])
        r = float(np.max(np.abs(np.linalg.eigvals(A))))
        max_r = max(max_r, min(r, 1.0 - 1e-12))
    if max_r <= 0.0:
        return 0
    return int(np.ceil(np.log(eps) / np.log(max_r)))


_CACHE: dict = {}
_AGC_ALPHAS: OrderedDict = OrderedDict()
_CACHE_SIZE = 8


def _cached(key, make):
    """make() once for each key; the oldest entry goes past _CACHE_SIZE."""
    if key not in _CACHE:
        if len(_CACHE) >= _CACHE_SIZE:
            del _CACHE[next(iter(_CACHE))]
        _CACHE[key] = make()
    return _CACHE[key]


def _band_apply(L, R, coeffs_b, mode: int, saturation: float):
    """Apply one band of static `mode` and return (L_out, R_out).  Only
    the channel filters the mode needs run; a stereo band runs L and R as
    one batch with the SSE2 tanh form, the others the scalar form."""
    if mode == STEREO:
        f, _ = svf_process(torch.stack([L, R], dim=-2), coeffs_b,
                           saturation=saturation, simd_tanh=True)
        return f[..., 0, :], f[..., 1, :]
    if mode == LEFT:
        f, _ = svf_process(L, coeffs_b, saturation=saturation, simd_tanh=False)
        return f, R
    if mode == RIGHT:
        f, _ = svf_process(R, coeffs_b, saturation=saturation, simd_tanh=False)
        return L, f
    if mode == MID:
        m = (L + R) * 0.5
        s = (L - R) * 0.5
        fm, _ = svf_process(m, coeffs_b, saturation=saturation,
                            simd_tanh=False)
        return fm + s, fm - s
    if mode == SIDE:
        m = (L + R) * 0.5
        s = (L - R) * 0.5
        fs, _ = svf_process(s, coeffs_b, saturation=saturation,
                            simd_tanh=False)
        return m + fs, m - fs
    raise ValueError(f"bad channel mode {mode}")


def _band_matrix_response_device(params: EQParams, sample_rate, m, csize,
                                 cdt, device):
    """The 2x2 band-response matrix at the csize bins of an m-point grid,
    evaluated on `device` in `cdt`: the biquad coefficients and the bin
    angles are host f64, the per-bin polynomials and the band products
    run on the device.  Returns (h11, h12, h21, h22)."""
    from ..engine.eq_analysis import svf_to_biquad
    active = band_active_mask(params)
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    w = 2.0 * np.pi * np.arange(csize) / m
    z = torch.as_tensor(np.exp(1j * w), device=device).to(cdt)
    z2 = z * z
    one = torch.ones((csize,), dtype=cdt, device=device)
    zero = torch.zeros((csize,), dtype=cdt, device=device)

    def band_T(b):
        b0, b1, b2, a0, a1, a2 = svf_to_biquad(*(float(c[b]) for c in coeffs))
        H = (b0 * z2 + b1 * z + b2) / (a0 * z2 + a1 * z + a2)
        mode = int(params.modes[b])
        if mode == STEREO:
            return (H, zero, zero, H)
        if mode == LEFT:
            return (H, zero, zero, one)
        if mode == RIGHT:
            return (one, zero, zero, H)
        hp = (H + 1.0) * 0.5
        hm = (H - 1.0) * 0.5
        if mode == MID:
            return (hp, hm, hm, hp)
        return (hp, -hm, -hm, hp)   # SIDE

    eye = (one, zero, zero, one)
    if params.structure == SERIAL:
        T = eye
        for b in range(NUM_BANDS):
            if active[b]:
                Tb = band_T(b)
                T = (Tb[0] * T[0] + Tb[1] * T[2], Tb[0] * T[1] + Tb[1] * T[3],
                     Tb[2] * T[0] + Tb[3] * T[2], Tb[2] * T[1] + Tb[3] * T[3])
        return T
    acc = [zero, zero, zero, zero]
    for b in range(NUM_BANDS):
        if active[b]:
            Tb = band_T(b)
            acc = [acc[i] + (Tb[i] - eye[i]) for i in range(4)]
    return tuple(eye[i] + acc[i] for i in range(4))


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def eq_process_bands_fft(x, params: EQParams, sample_rate, eps=1e-10):
    """Frequency-domain EQ: the combined 2x2 band response as one
    convolution (saturation must be 0; the +-100 output clamp is not
    applied).  Equal to the scan cascade up to the truncated ringing
    tail (bounded by `eps`) and rounding.  Routes: see the module
    docstring."""
    n = x.shape[-1]
    pad = _eq_ring_tail_samples(params, sample_rate, eps)
    if pad == 0:
        return x                     # no active band: the identity
    if (x.dtype != torch.float64 and x.device.type == "cuda"
            and n >= 4 * pad):
        return _eq_fft_blocked(x, params, sample_rate, pad)
    m = next_pow2(n + pad)
    csize = m // 2 + 1
    cdt = _complex_of(x.dtype)
    key = ("response", params.config_key(), float(sample_rate), m, cdt,
           str(x.device))
    if x.dtype == torch.float64:
        # the exactness route: the host f64 response
        def make():
            freqs = np.arange(csize) * (sample_rate / m)
            return tuple(torch.as_tensor(h, device=x.device) for h in
                         _band_matrix_response(params, sample_rate, freqs))
    else:
        def make():
            return _band_matrix_response_device(params, sample_rate, m,
                                                csize, cdt, x.device)
    h11, h12, h21, h22 = _cached(key, make)
    X = torch.fft.rfft(x, n=m, dim=-1)
    XL = X[..., 0, :]
    XR = X[..., 1, :]
    Y = torch.stack([h11 * XL + h12 * XR, h21 * XL + h22 * XR], dim=-2)
    return torch.fft.irfft(Y, n=m, dim=-1)[..., :n].to(x.dtype)


def _eq_block_size(tail: int) -> int:
    """The blocked EQ convolution's partition size for a ring tail."""
    return int(np.clip(next_pow2(max(tail // 4, 1)), 1024, 8192))


def eq_fft_blocking(params: EQParams, sample_rate, eps=1e-10):
    """(p, P): the partition size and count that `_eq_fft_blocked` runs
    the bands' response at, truncated to their eps ring tail."""
    tail = _eq_ring_tail_samples(params, sample_rate, eps)
    p = _eq_block_size(tail)
    return p, -(-tail // p)


def _eq_fft_blocked(x, params: EQParams, sample_rate, tail: int):
    """Blocked EQ convolution: the 2x2 impulse response truncated to
    `tail` taps (sampled on a 2 tail grid, so its circular aliasing is
    below the same eps as the truncation) through
    `uniform_partitioned_conv`.  All active bands stereo: one response
    convolves both channels; otherwise four convolutions."""
    from ..ops.partitioned_conv import (partition_spectra,
                                        uniform_partitioned_conv)
    n = x.shape[-1]
    m = next_pow2(2 * tail)
    active = band_active_mask(params)
    diag_only = all(int(params.modes[b]) == STEREO
                    for b in range(NUM_BANDS) if active[b])
    p = _eq_block_size(tail)

    def make():
        resp = _band_matrix_response_device(params, sample_rate, m,
                                            m // 2 + 1,
                                            _complex_of(x.dtype), x.device)
        return [partition_spectra(torch.fft.irfft(h, n=m)[:tail].to(x.dtype),
                                  p, dtype=x.dtype, device=x.device)
                for h in (resp[:1] if diag_only else resp)]

    H = _cached(("blocked", params.config_key(), float(sample_rate), tail,
                 x.dtype, str(x.device)), make)
    if diag_only:
        return uniform_partitioned_conv(x, H[0], p)
    xL = x[..., 0, :]
    xR = x[..., 1, :]
    yL = (uniform_partitioned_conv(xL, H[0], p)
          + uniform_partitioned_conv(xR, H[1], p))
    yR = (uniform_partitioned_conv(xL, H[2], p)
          + uniform_partitioned_conv(xR, H[3], p))
    return torch.stack([yL, yR], dim=-2)


def eq_process_bands(x, params: EQParams, sample_rate, method: str = "auto"):
    """Run the band filters (no AGC) on x (..., 2, N).  method: "scan"
    (the band cascade, the reference's semantics), "fft" (the combined
    response, linear bands only) or "auto" (fft when saturation == 0,
    else scan)."""
    sat = float(params.saturation)
    if method == "auto":
        method = "scan" if sat > 0.0 else "fft"
    if method == "fft":
        if sat > 0.0:
            raise ValueError("fft EQ path requires saturation == 0")
        return eq_process_bands_fft(x, params, sample_rate)
    if method != "scan":
        raise ValueError(f"method {method!r}: 'scan', 'fft' or 'auto'")
    L = x[..., 0, :]
    R = x[..., 1, :]
    active = band_active_mask(params)
    coeffs = svf_coeffs(params.band_types, params.freqs, params.gains_db,
                        params.qs, sample_rate)
    bands = [(tuple(float(c[b]) for c in coeffs), int(params.modes[b]))
             for b in range(NUM_BANDS) if active[b]]
    if params.structure == SERIAL:
        for cb, mode in bands:
            L, R = _band_apply(L, R, cb, mode, sat)
    else:
        accL = torch.zeros_like(L)
        accR = torch.zeros_like(R)
        for cb, mode in bands:
            Lb, Rb = _band_apply(L, R, cb, mode, sat)
            accL = accL + (Lb - L)
            accR = accR + (Rb - R)
        L, R = L + accL, R + accR
    return torch.stack([L, R], dim=-2)


def _agc_gain_target(env_in, env_out):
    """calculateAGCGain (EQProcessor.Processing.cpp:343-360)."""
    ratio = env_in / env_out.clamp(min=AGC_MIN_ENV)
    in_dead_zone = ((ratio > 1.0 / AGC_DEAD_ZONE_RATIO)
                    & (ratio < AGC_DEAD_ZONE_RATIO))
    target = ratio.clamp(AGC_MIN_GAIN, AGC_MAX_GAIN)
    target = torch.where(in_dead_zone, 1.0, target)
    return torch.where(env_out < AGC_MIN_ENV, 1.0, target)


def agc_apply(x_pre, x_post, sample_rate, block_size, state0=None,
              return_state=False):
    """Block-rate AGC over the whole signal (processAGC semantics).

    x_pre: the EQ input (..., 2, N), the input RMS envelope's source;
    x_post: the banded signal (..., 2, N), the output envelope's source,
    which the per-sample gain ramp multiplies.  N must be a multiple of
    block_size.  Returns y, or (y, final state (..., 3) [env_in, env_out,
    gain]) with return_state=True; state0 resumes such a state."""
    dt = x_post.dtype
    n = x_post.shape[-1]
    nb = n // block_size
    if nb * block_size != n:
        raise ValueError(f"signal length {n} is not a multiple of the "
                         f"block size {block_size}")

    def block_rms_max(sig):
        blocks = sig.reshape(sig.shape[:-1] + (nb, block_size))
        return (blocks * blocks).mean(dim=-1).sqrt().amax(dim=-2)

    in_rms = block_rms_max(x_pre).clamp(max=AGC_MAX_ENV)    # (..., nb)
    out_rms = block_rms_max(x_post).clamp(max=AGC_MAX_ENV)
    # blockAlpha = 1 - exp(-N / (sr T)) (EQProcessor.Core.cpp:776-778)
    aA, aR = device_constants(
        _AGC_ALPHAS, (block_size, float(sample_rate)),
        lambda: tuple(1.0 - np.exp(-block_size / (sample_rate * t))
                      for t in (AGC_ATTACK_TIME_SEC, AGC_RELEASE_TIME_SEC)),
        dt, x_post.device)
    aS = 1.0 - np.exp(-block_size / (sample_rate * AGC_SMOOTH_TIME_SEC))
    batch = in_rms.shape[:-1]
    if state0 is None:
        env_in = torch.zeros(batch, dtype=dt, device=x_post.device)
        env_out = torch.zeros_like(env_in)
        gain = torch.ones_like(env_in)
    else:
        state0 = torch.as_tensor(state0, dtype=dt, device=x_post.device)
        env_in, env_out, gain = state0[..., 0], state0[..., 1], state0[..., 2]
    g0, g1 = [], []
    for b in range(nb):
        rin, rout = in_rms[..., b], out_rms[..., b]
        ain = torch.where(rin > env_in, aA, aR)
        aout = torch.where(rout > env_out, aA, aR)
        env_in = env_in * (1.0 - ain) + rin * ain
        env_out = env_out * (1.0 - aout) + rout * aout
        env_in = torch.where(env_in < AGC_DENORM, 0.0, env_in)
        env_out = torch.where(env_out < AGC_DENORM, 0.0, env_out)
        target = _agc_gain_target(env_in, env_out)
        g0.append(gain)
        gain = gain * (1.0 - aS) + target * aS
        g1.append(gain)
    g0 = torch.stack(g0, dim=-1)                             # (..., nb)
    g1 = torch.stack(g1, dim=-1)
    # per-sample ramp gain_n = g0 + n (g1 - g0) / block_size (applyGainRamp)
    ramp = torch.arange(block_size, dtype=dt, device=x_post.device) \
        / block_size
    gains = g0.unsqueeze(-1) + (g1 - g0).unsqueeze(-1) * ramp
    y = x_post * gains.reshape(batch + (n,)).unsqueeze(-2)
    if return_state:
        return y, torch.stack([env_in, env_out, gain], dim=-1)
    return y


def eq_process(x, params: EQParams, sample_rate, block_size=512,
               method: str = "scan"):
    """The full EQ on x (..., 2, N): the bands, then the AGC when enabled
    (at `block_size`, the reference's callback block rate)."""
    y = eq_process_bands(x, params, sample_rate, method=method)
    if params.agc_enabled:
        y = agc_apply(x, y, sample_rate, block_size)
    return y
