"""Dither / noise-shaping engines (counterpart of
convopeq_tpu/models/dither.py): the four reference shapers, their tables
and their deterministic RNGs.

- PsychoacousticDither (src/PsychoacousticDither.h): 12th-order
  error-feedback shaper with TPDF dither added before quantization.
- FixedNoiseShaper / Fixed15TapNoiseShaper (src/FixedNoiseShaper.h,
  src/Fixed15TapNoiseShaper.h): 4th / 16th-order error feedback with the
  fullscale clamp and the +-2 LSB error clamp.
- LatticeNoiseShaper (src/LatticeNoiseShaper.h): 9th-order lattice ladder
  on learned reflection coefficients (|k| <= 0.85).

The shapers here are the plain versions: loops over time of elementwise
tensor ops, batched over rows, with the state in and out
(`ops.quantize_kernels.error_feedback_quantize_plain`), except
`lattice_dither`, which dispatches by device as `apply_dither` does (the
learner's population simulation runs through it).  `apply_dither`
sends a CUDA tensor to the hand-written quantizer kernel (stateful calls
too: the kernel takes and returns the carry) and a CPU tensor to the
plain version.  The two are bit-identical.

`lattice_dither` takes its ladder without a default: the JAX package's
`lattice_dither` defaults to "reference" (which rails) and its
`apply_dither` to "fir".

Not ported: the LSB-residual route and CONVOPEQ_DITHER_BACKEND, which
exist because f64 on the TPU is emulated; the card runs the f64 loop
natively through the same kernel.

Rounding is half to even (torch.round, rint), matching SSE4.1
_MM_FROUND_TO_NEAREST_INT.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quantize_kernels import (error_feedback_quantize,
                                    error_feedback_quantize_plain)
from ..runtime.telemetry import span
from ..utils.dsputil import K_OUTPUT_HEADROOM

# Noise shaper types (AudioEngine NoiseShaperType)
PSYCHOACOUSTIC, FIXED4, FIXED15, ADAPTIVE9 = 0, 1, 2, 3

NS_ORDER_PSYCHO = 12
NS_ORDER_FIXED4 = 4
NS_ORDER_FIXED15 = 16
NS_ORDER_LATTICE = 9

# kCoeffTable (src/PsychoacousticDither.h:192-250): [SR band][bit preset][12]
PSYCHO_COEFF_TABLE = np.array([
    [[2.93, -5.06, 6.97, -7.66, 7.11, -5.63, 3.96, -2.18, 0.80, -0.24, 0.10, -0.04],
     [2.49, -4.30, 5.92, -6.51, 6.05, -4.79, 3.37, -1.86, 0.68, -0.20, 0.08, -0.03],
     [2.04, -3.52, 4.85, -5.34, 4.95, -3.92, 2.76, -1.52, 0.56, -0.17, 0.07, -0.03]],
    [[2.85, -4.92, 6.78, -7.45, 6.92, -5.48, 3.85, -2.12, 0.78, -0.23, 0.09, -0.04],
     [2.42, -4.18, 5.75, -6.32, 5.87, -4.65, 3.27, -1.80, 0.66, -0.20, 0.08, -0.03],
     [1.98, -3.42, 4.71, -5.18, 4.81, -3.81, 2.68, -1.47, 0.54, -0.16, 0.06, -0.03]],
    [[3.28, -5.66, 7.80, -8.57, 7.96, -6.30, 4.43, -2.44, 0.90, -0.27, 0.11, -0.05],
     [2.78, -4.80, 6.61, -7.26, 6.75, -5.34, 3.75, -2.07, 0.76, -0.23, 0.09, -0.04],
     [2.28, -3.94, 5.42, -5.95, 5.53, -4.38, 3.08, -1.69, 0.62, -0.19, 0.07, -0.03]],
    [[3.71, -6.40, 8.82, -9.69, 9.00, -7.12, 5.01, -2.76, 1.02, -0.31, 0.12, -0.05],
     [3.15, -5.44, 7.50, -8.24, 7.65, -6.05, 4.25, -2.34, 0.86, -0.26, 0.10, -0.04],
     [2.58, -4.46, 6.15, -6.75, 6.27, -4.96, 3.48, -1.92, 0.70, -0.21, 0.08, -0.03]],
    [[4.12, -7.10, 9.78, -10.75, 9.98, -7.89, 5.55, -3.06, 1.13, -0.34, 0.14, -0.06],
     [3.49, -6.03, 8.31, -9.13, 8.47, -6.70, 4.71, -2.59, 0.95, -0.29, 0.11, -0.05],
     [2.86, -4.94, 6.81, -7.48, 6.94, -5.49, 3.86, -2.12, 0.78, -0.23, 0.09, -0.04]],
    [[4.48, -7.73, 10.64, -11.70, 10.86, -8.59, 6.04, -3.33, 1.23, -0.37, 0.15, -0.06],
     [3.80, -6.56, 9.04, -9.93, 9.22, -7.29, 5.13, -2.82, 1.04, -0.31, 0.12, -0.05],
     [3.11, -5.37, 7.41, -8.13, 7.55, -5.97, 4.20, -2.31, 0.85, -0.26, 0.10, -0.04]],
])

# FixedNoiseShaper presets (src/FixedNoiseShaper.h:298-314)
FIXED4_PRESET_RATES = np.array([44100.0, 48000.0, 88200.0, 96000.0, 176400.0,
                                192000.0, 352800.0, 384000.0, 705600.0, 768000.0])
FIXED4_PRESETS = np.array([
    [0.394958, 0.319775, 0.145569, 0.139697],
    [0.460000, 0.280000, 0.170000, 0.090000],
    [0.727810, 0.189547, 0.125028, -0.042385],
    [0.742333, 0.185474, 0.106133, -0.033940],
    [0.775904, 0.126967, 0.043467, 0.053661],
    [0.774132, 0.117440, 0.047291, 0.061137],
    [0.724647, 0.094403, 0.113208, 0.067743],
    [0.714605, 0.097798, 0.124553, 0.063045],
    [0.635851, 0.161114, 0.194506, 0.008529],
    [0.624827, 0.174509, 0.201424, -0.000760],
])

# Fixed15TapNoiseShaper default (src/Fixed15TapNoiseShaper.h:466; ORDER=16,
# the 16th coefficient is zero)
FIXED15_DEFAULT = np.array([2.172009, -2.313034, 2.092949, -1.698718,
                            1.304487, -0.946581, 0.645299, -0.415598,
                            0.251068, -0.141026, 0.072650, -0.033120,
                            0.012821, -0.004274, 0.001068, 0.0])

# Fixed15TapNoiseShaper COEFF_PRESETS (src/Fixed15TapNoiseShaper.h:352-374):
# prepare() interpolates these by sample rate over FIXED4_PRESET_RATES
# (same grid); the 48 kHz row equals FIXED15_DEFAULT.
FIXED15_PRESETS = np.array([
    [2.157553, -2.356649, 2.179194, -1.802605, 1.429476, -1.073975,
     0.775233, -0.535496, 0.360294, -0.229526, 0.143225, -0.081483,
     0.045992, -0.021109, 0.009877, 0.0],
    [2.172009, -2.313034, 2.092949, -1.698718, 1.304487, -0.946581,
     0.645299, -0.415598, 0.251068, -0.141026, 0.072650, -0.033120,
     0.012821, -0.004274, 0.001068, 0.0],
    [1.458665, -1.271063, 1.372588, -1.257752, 1.186326, -1.042666,
     0.931875, -0.787020, 0.671068, -0.541164, 0.438950, -0.333234,
     0.250772, -0.174640, 0.097295, 0.0],
    [1.366976, -1.123204, 1.234291, -1.119397, 1.063887, -0.931030,
     0.838107, -0.707665, 0.608977, -0.492384, 0.404256, -0.308827,
     0.236248, -0.167088, 0.096853, 0.0],
    [0.892356, -0.425055, 0.645737, -0.531778, 0.565511, -0.483687,
     0.474500, -0.404025, 0.379228, -0.317474, 0.286683, -0.233505,
     0.199702, -0.166141, 0.117948, 0.0],
    [0.842437, -0.356337, 0.593464, -0.477529, 0.519248, -0.440863,
     0.438827, -0.372969, 0.354221, -0.297057, 0.271334, -0.222591,
     0.192842, -0.164283, 0.119255, 0.0],
    [0.576947, -0.000943, 0.355358, -0.225398, 0.306449, -0.241465,
     0.271718, -0.228634, 0.237327, -0.205281, 0.201703, -0.179310,
     0.166143, -0.176849, 0.142236, 0.0],
    [0.550200, 0.035746, 0.334748, -0.202925, 0.287573, -0.223403,
     0.255932, -0.214959, 0.225551, -0.196308, 0.194281, -0.175339,
     0.163224, -0.180050, 0.145728, 0.0],
    [0.403358, 0.274330, 0.229984, -0.085257, 0.190310, -0.131467,
     0.169688, -0.142598, 0.154703, -0.144947, 0.142117, -0.148598,
     0.132904, -0.195545, 0.151017, 0.0],
    [0.390229, 0.306061, 0.221612, -0.075413, 0.182734, -0.125438,
     0.162912, -0.138648, 0.149015, -0.142960, 0.137870, -0.149116,
     0.130580, -0.202133, 0.152692, 0.0],
])

LATTICE_COEFF_LIMIT = 0.85       # clampCoeff (LatticeNoiseShaper.h:116)
LATTICE_STATE_LIMIT = 2.0        # kLatticeStateLimit (advanceState)
ERROR_CLAMP_FACTOR = 2.0         # error clamp +-2*scale


def psycho_sr_band(sample_rate: float) -> int:
    """SR band select (PsychoacousticDither.h:253-258)."""
    for band, limit in enumerate([46050.0, 72000.0, 144000.0, 264600.0, 529200.0]):
        if sample_rate < limit:
            return band
    return 5


def psycho_coeffs(sample_rate: float, bit_depth: int) -> np.ndarray:
    bp = 0 if bit_depth <= 16 else 1 if bit_depth <= 24 else 2
    return PSYCHO_COEFF_TABLE[psycho_sr_band(sample_rate)][bp].copy()


def _preset_interp(sample_rate: float, presets: np.ndarray) -> np.ndarray:
    """selectPresetWithInterpolation (FixedNoiseShaper.h:316-340 /
    Fixed15TapNoiseShaper.h:372-398 — same logic, same rate grid)."""
    r = FIXED4_PRESET_RATES
    if sample_rate <= r[0]:
        return presets[0].copy()
    if sample_rate >= r[-1]:
        return presets[-1].copy()
    i = int(np.searchsorted(r, sample_rate, side="right")) - 1
    t = (sample_rate - r[i]) / (r[i + 1] - r[i])
    return (1.0 - t) * presets[i] + t * presets[i + 1]


def fixed4_coeffs(sample_rate: float) -> np.ndarray:
    return _preset_interp(sample_rate, FIXED4_PRESETS)


def fixed15_coeffs(sample_rate: float) -> np.ndarray:
    """The reference's prepare() selects from COEFF_PRESETS, not the
    member default (Fixed15TapNoiseShaper.h:88-107)."""
    return _preset_interp(sample_rate, FIXED15_PRESETS)


def quant_scales(bit_depth: int):
    scale = 1.0 / (2.0 ** (bit_depth - 1))
    inv_scale = 2.0 ** (bit_depth - 1)
    return scale, inv_scale


# ---------------------------------------------------------------------------
# RNG
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


class Xoshiro256pp:
    """Exact transcription of the reference Xoshiro256++ (python ints)."""

    def __init__(self, s):
        self.s = [int(v) & _M64 for v in s]

    @staticmethod
    def _rotl(x, k):
        return ((x << k) | (x >> (64 - k))) & _M64

    def next_u64(self):
        s = self.s
        result = (self._rotl((s[0] + s[3]) & _M64, 23) + s[0]) & _M64
        t = (s[1] << 17) & _M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = self._rotl(s[3], 45)
        return result

    def uniform(self):
        return (self.next_u64() >> 11) * (1.0 / 9007199254740992.0)


# Reference per-channel seeds (FixedNoiseShaper.h / LatticeNoiseShaper.h)
XOSHIRO_SEEDS = [
    (0x123456789ABCDEF0, 0xFEDCBA9876543210, 0x0123456789ABCDEF, 0xEFCDAB8967452301),
    (0x89ABCDEF01234567, 0x76543210FEDCBA98, 0xABCDEF0123456789, 0x67452301EFCDAB89),
]


def xoshiro_uniforms(n: int, channel: int = 0, seeds=None) -> np.ndarray:
    """Uniform stream from the reference's Xoshiro256++; `seeds` overrides
    the per-channel constant seeds (e.g. fixed15_xoshiro_seeds)."""
    if seeds is None:
        seeds = XOSHIRO_SEEDS[channel % len(XOSHIRO_SEEDS)]
    rng = Xoshiro256pp(seeds)
    return np.array([rng.uniform() for _ in range(n)])


def _splitmix64(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return state, z ^ (z >> 31)


def fixed15_xoshiro_seeds(sample_rate: float, bit_depth: int,
                          channel: int = 0):
    """Fixed15TapNoiseShaper::initializeRandomStates
    (Fixed15TapNoiseShaper.h:407-427): splitmix64 stream seeded from
    bit_cast(sampleRate) ^ (bits<<32) ^ const, decorrelated per channel."""
    import struct
    seed = struct.unpack("<Q", struct.pack("<d", float(sample_rate)))[0]
    seed ^= (int(bit_depth) & _M64) << 32
    seed &= _M64
    seed ^= 0xD1B54A32D192ED03
    stream = seed ^ ((0x9E3779B97F4A7C15 * (channel + 1)) & _M64)
    s = []
    for _ in range(4):
        stream, v = _splitmix64(stream)
        s.append(v)
    if (s[0] | s[1] | s[2] | s[3]) == 0:
        s[0] = 1
    return tuple(s)


def psycho_fallback_uniforms(n: int, channel: int,
                             base_seed: int) -> np.ndarray:
    """The PsychoacousticDither deterministic non-MKL RNG: the ctor
    seeds a SplitMix64 from `base_seed` and draws one 64-bit seed per
    channel 0..7 (PsychoacousticDither.h:122-137); the per-channel
    fallback state is seed ^ 0xd1b54a32d192ed03, stepped by xorshift64
    (12/25/27) with a Marsaglia multiplier and a 53-bit mantissa map
    (PsychoacousticDither.h:477-489).  Bit-exact vs the reference
    binary (tests/ref_harness/dump_shapers.cpp psycho_* vectors)."""
    stream = int(base_seed) & _M64
    seed_ch = 0
    for _ in range(channel + 1):
        stream, seed_ch = _splitmix64(stream)
    x = (seed_ch ^ 0xD1B54A32D192ED03) & _M64
    out = np.empty(n, np.float64)
    mul = 2685821657736338717
    inv53 = 1.0 / 9007199254740992.0
    for i in range(n):
        x ^= x >> 12
        x = (x ^ (x << 25)) & _M64
        x ^= x >> 27
        z = (x * mul) & _M64
        out[i] = float(z >> 11) * inv53
    return out


def tpdf_from_uniforms(u):
    """TPDF in [-1, 1]: (u1-0.5)+(u2-0.5); u shape (..., N, 2)."""
    return (u[..., 0] - 0.5) + (u[..., 1] - 0.5)


# ---------------------------------------------------------------------------
# Shapers (plain loops over time, batch over the leading dims)
# ---------------------------------------------------------------------------

def _run(quantize, x, uniforms, coeffs, bit_depth: int, headroom: float,
         mode: str, state, return_state: bool):
    """Flatten (..., N) to rows, quantize, restore the shapes."""
    x = torch.as_tensor(x)
    if bit_depth <= 0:
        out = x * headroom
        return (out, state) if return_state else out
    batch, n = x.shape[:-1], x.shape[-1]
    coeffs = np.asarray(coeffs, np.float64)
    order = coeffs.shape[-1]
    if coeffs.ndim > 1:      # per-row coefficients: one row a signal row
        coeffs = coeffs.reshape((-1, order))
    u = torch.as_tensor(uniforms).to(x.device, x.dtype).reshape((-1, n, 2))
    s = None if state is None else \
        torch.as_tensor(state).to(x.device, x.dtype).reshape((-1, order))
    scale, _ = quant_scales(bit_depth)
    with span("dither.quantize", x.device):
        q, s_out = quantize(x.reshape((-1, n)), u, coeffs, scale, headroom,
                            mode, s)
    q = q.reshape(x.shape)
    return (q, s_out.reshape(batch + (order,))) if return_state else q


def lattice_coeffs(reflection_coeffs) -> np.ndarray:
    """clampCoeff (LatticeNoiseShaper.h:116): NaN -> 0, |k| <= 0.85."""
    k = np.nan_to_num(np.asarray(reflection_coeffs, np.float64))
    return np.clip(k, -LATTICE_COEFF_LIMIT, LATTICE_COEFF_LIMIT)


def psycho_dither(x, uniforms, sample_rate: float, bit_depth: int,
                  headroom: float = K_OUTPUT_HEADROOM,
                  state=None, return_state: bool = False):
    """PsychoacousticDither.processStereoBlock (PsychoacousticDither.h:280+).
    x (..., N); uniforms (..., N, 2) in [0, 1); state (..., 12)."""
    return _run(error_feedback_quantize_plain, x, uniforms,
                psycho_coeffs(sample_rate, bit_depth), bit_depth, headroom,
                "psycho", state, return_state)


def fixed_shaper_dither(x, uniforms, coeffs, bit_depth: int,
                        headroom: float = K_OUTPUT_HEADROOM,
                        range_clamp: bool = False,
                        state=None, return_state: bool = False):
    """FixedNoiseShaper / Fixed15TapNoiseShaper processSample loop:
    y = x*headroom - sum c_i e_i; q = quantize(y); e0 = clamp(q-y, 2 scale).
    range_clamp=True adds Fixed15Tap's post-round integer-range clamp."""
    return _run(error_feedback_quantize_plain, x, uniforms,
                np.asarray(coeffs, np.float64), bit_depth, headroom,
                "fixed15" if range_clamp else "fixed", state, return_state)


def lattice_dither(x, uniforms, reflection_coeffs, bit_depth: int,
                   headroom: float = K_OUTPUT_HEADROOM,
                   state=None, return_state: bool = False, *, ladder: str):
    """LatticeNoiseShaper (LatticeNoiseShaper.h:229-295).

    ladder: "reference" reproduces the reference's advanceState bit for
    bit, including the store that makes its states drift into the +-2
    clamp; "fir" stores the previous stage's backward output (the
    textbook analysis ladder): every state is a finite response of the
    last <= 9 clamped errors, bounded by prod(1+|k_j|) * 2 LSB.

    reflection_coeffs: (9,) shared, or (..., 9) with x's batch shape, one
    coefficient set a signal row (the learner's population: the JAX
    package's vmap over candidates).  A CUDA tensor runs the quantizer
    kernel (its per-row form for per-row coefficients), a CPU tensor the
    plain version."""
    if ladder not in ("reference", "fir"):
        raise ValueError(f"ladder {ladder!r}")
    return _run(error_feedback_quantize, x, uniforms,
                lattice_coeffs(reflection_coeffs), bit_depth, headroom,
                "lattice_fir" if ladder == "fir" else "lattice", state,
                return_state)


def dither_state_init(x_batch_shape, shaper_type: int,
                      dtype=torch.float64, device="cuda"):
    """Zero shaper carry for block streaming: (batch..., order)."""
    order = {PSYCHOACOUSTIC: NS_ORDER_PSYCHO, FIXED4: NS_ORDER_FIXED4,
             FIXED15: NS_ORDER_FIXED15,
             ADAPTIVE9: NS_ORDER_LATTICE}[int(shaper_type)]
    return torch.zeros(tuple(x_batch_shape) + (order,), dtype=dtype,
                       device=resolve_device(device))


def shaper_mode(shaper_type: int, sample_rate: float, bit_depth: int,
                adaptive_coeffs=None, lattice_ladder: str = "fir"):
    """(coefficients, quantizer mode) of a shaper type."""
    if shaper_type == PSYCHOACOUSTIC:
        return psycho_coeffs(sample_rate, bit_depth), "psycho"
    if shaper_type == FIXED4:
        return fixed4_coeffs(sample_rate), "fixed"
    if shaper_type == FIXED15:
        return fixed15_coeffs(sample_rate), "fixed15"
    if shaper_type == ADAPTIVE9:
        if lattice_ladder not in ("reference", "fir"):
            raise ValueError(f"ladder {lattice_ladder!r}")
        k = np.zeros(NS_ORDER_LATTICE) if adaptive_coeffs is None \
            else adaptive_coeffs
        return (lattice_coeffs(k),
                "lattice_fir" if lattice_ladder == "fir" else "lattice")
    raise ValueError(f"unknown shaper type {shaper_type}")


def apply_dither(x, shaper_type: int, sample_rate: float, bit_depth: int,
                 uniforms=None, generator=None, adaptive_coeffs=None,
                 headroom: float = K_OUTPUT_HEADROOM,
                 state=None, return_state: bool = False,
                 lattice_ladder: str = "fir"):
    """Dither dispatch (DSPCoreDouble.cpp:644-653).  x: (..., N).

    uniforms: (..., N, 2) in [0, 1); drawn from `generator` on x's device
    when omitted.  bit_depth <= 0 disables quantization (headroom only).
    A CUDA tensor runs the quantizer kernel, a CPU tensor its plain
    version; both take and return the shaper carry (state (..., order)).
    Spans: "dither" around "dither.quantize"."""
    x = torch.as_tensor(x)
    with span("dither", x.device):
        if bit_depth <= 0:
            out = x * headroom
            return (out, state) if return_state else out
        coeffs, mode = shaper_mode(shaper_type, sample_rate, bit_depth,
                                   adaptive_coeffs, lattice_ladder)
        if uniforms is None:
            uniforms = torch.rand(x.shape + (2,), generator=generator,
                                  dtype=x.dtype, device=x.device)
        return _run(error_feedback_quantize, x, uniforms, coeffs,
                    bit_depth, headroom, mode, state, return_state)
