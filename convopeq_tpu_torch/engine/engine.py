"""ConvoPeqEngine — the user-facing engine (counterpart of
convopeq_tpu/engine/engine.py; the AudioEngine-equivalent API).

The reference's engine surface (src/audioengine/AudioEngine.h): IR load
with phase and tail modes, the 20-band EQ parameters, processing order,
oversampling factor, soft clip, wet/dry, auto gain, dither, the latency
breakdown and full-state save and load.  A parameter change gives a new
static config whose chain is cached by a content key (the analog of
RuntimeBuilder -> publishWorld); a structural change between two
`process` calls is crossfaded.

IR load pipeline (the LoaderThread stages, ConvolverProcessor.
LoaderThread.cpp:392-413): LoadIR -> Trim (target length + 2% tail
fade, peak-latency centroid estimate) -> Transform (resample / minimum /
mixed phase) -> energy scale (1/sqrt(max channel energy) x -6 dB, clamp
and jump protection) -> Build (the NUC partition spectra, on the
engine's device) -> publish.  Everything before Build is host NumPy f64.

How the port differs from the JAX package:
- The dtype and the device are explicit: `dtype` (torch.float32 by
  default, or torch.float64, native on the card) and `device` ("cuda" by
  default: a CPU run must be asked for; "cuda" raises without a card).
- The chain cache holds Python callables of `process_chain` (the JAX
  package's jitted closures), each with a snapshot of the EQ parameters
  it was built from; a published chain keeps its own convolver state, so
  a later crossfade runs the old chain as it was.
- `process(x, generator=None, uniforms=None, return_chain_output=False)`:
  the dither's TPDF uniforms (..., N, 2) are passed in or drawn from
  `generator`; with neither, from a generator seeded 0 each call (the JAX
  package's default key PRNGKey(0): a deterministic default, not the
  same numbers).  return_chain_output=True also returns the chain's
  output, the signal the dither quantizes.
- `process_streaming` draws each block's uniforms from one torch
  Generator the engine owns, seeded 0 at construction (the JAX package's
  fold_in(key, block) of one key).  The streaming state is updated in
  place (runtime/streaming.py).
- Live learning (`start_learning`, `stop_learning`): the capture ring is
  the native SPSC ring (utils/native.py; a failed build raises, there is
  no Python stand-in), the learner's population simulation runs on the
  engine's device on a CUDA stream of its own, so the card runs the
  learner's quantizer launches beside the stream's blocks, and a block's
  fence waits on the stream's own work only.
"""
from __future__ import annotations

import copy
import json
import threading
import time
from dataclasses import asdict, dataclass, field, replace

import numpy as np
import torch

from ..convert import banks_from_dict
from ..device import resolve_device
from ..ir.analyzer import estimate_max_frequency_gain, ir_peak_gain_db
from ..ir.phase import minimum_phase, mixed_phase_allpass, mixed_phase_fallback
from ..ir.resample import resample_ir
from ..models.chain import (ChainConfig, process_chain,
                            resolve_oversampling_factor)
from ..models.convolver import StereoConvolverState, stereo_prepare
from ..models.dither import apply_dither, dither_state_init
from ..models.eq import EQParams
from ..models.gain_planner import AutoGainPlan, PlannerInput, plan
from ..models.learner import AdaptiveCoefficientBanks
from ..models.nuc import FilterSpec
from ..ops.oversample import make_stages
from ..runtime.crossfade import (CrossfadeState, classify_transition,
                                 crossfade_blocks, crossfade_mix,
                                 fade_time_for)
from ..runtime.streaming import StreamingChain
from ..runtime.telemetry import (RuntimeHealthMonitor, RuntimePolicyEngine,
                                 StageTimer, TelemetryRecorder, XrunDetector,
                                 setup_span)
from ..utils.dsputil import K_OUTPUT_HEADROOM, next_pow2
from ..utils.wavio import read_wav
from .cache import LRUCache, MixedPhaseDiskCache, content_hash
from .eq_analysis import estimate_planner_gain_db, max_active_q

# PhaseMode (src/ConvolverProcessor.h:117)
PHASE_AS_IS, PHASE_MINIMUM, PHASE_MIXED = 0, 1, 2

IR_LENGTH_DEFAULT_SEC = 1.0        # ConvolverProcessor.h:172
MIXED_F1_DEFAULT_HZ = 200.0        # :175
MIXED_F2_DEFAULT_HZ = 1000.0       # :178
ENERGY_SCALE_MARGIN = 0.5011872336272722   # -6 dB (IRConverter.cpp:36)


@dataclass
class LatencyBreakdown:
    """ConvolverProcessor.h:421-437 + the engine's OS/softclip model
    (AudioEngine.Processing.Latency.cpp:22-124)."""
    algorithm_latency_samples: int = 0
    ir_peak_latency_samples: int = 0
    oversampling_latency_samples: int = 0
    softclip_latency_samples: int = 0

    @property
    def total_latency_samples(self) -> int:
        return (self.algorithm_latency_samples + self.ir_peak_latency_samples
                + self.oversampling_latency_samples
                + self.softclip_latency_samples)


def estimate_peak_latency(ir: np.ndarray) -> int:
    """Energy-centroid peak latency (LoaderThread.cpp:149-205): centroid of
    the energy up to the 99.9% cumulative cutoff, max over channels."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    n = ir.shape[-1]
    if n <= 0:
        return 0
    max_centroid = 0.0
    for ch in range(ir.shape[0]):
        e = ir[ch] * ir[ch]
        total = e.sum()
        if total < 1e-12:
            continue
        csum = np.cumsum(e)
        cutoff = int(np.searchsorted(csum, total * 0.999))
        cutoff = min(cutoff, n - 1)
        se = e[:cutoff + 1].sum()
        sw = (np.arange(cutoff + 1) * e[:cutoff + 1]).sum()
        centroid = sw / se if se > 0.0 else 0.0
        max_centroid = max(max_centroid, centroid)
    return int(np.clip(np.floor(max_centroid + 0.5), 0, n - 1))


def energy_scale(ir: np.ndarray) -> float:
    """computeEnergyScale (IRConverter.cpp:17-38)."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    max_energy = 0.0
    for ch in range(ir.shape[0]):
        e = float(np.dot(ir[ch], ir[ch]))
        if np.isfinite(e) and e > 1e-18:
            max_energy = max(max_energy, e)
    if not (max_energy > 1e-18) or not np.isfinite(max_energy):
        return 1.0
    return (1.0 / np.sqrt(max_energy)) * ENERGY_SCALE_MARGIN


def compute_ir_scale(ir: np.ndarray, current_ir: np.ndarray | None = None,
                     current_scale: float = 1.0) -> float:
    """computeScaleFactor's three stages (IRConverter.cpp:173-196): energy
    normalization (-6 dB margin), then clamp protection (effective peak
    <= 0.5, effective RMS <= 0.25, frequency-response peak <= 1.41), then,
    given the previous IR, the current-IR jump protection
    (IRConverter.cpp:124-168; `jump_protection_clamp`)."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    scale = energy_scale(ir)
    if scale <= 0.0 or not np.isfinite(scale):
        return 1.0
    peak = float(np.abs(ir).max()) if ir.size else 0.0
    rms = float(np.sqrt(np.mean(ir * ir))) if ir.size else 0.0
    if peak * scale > 0.5:
        scale *= 0.5 / (peak * scale)
    if rms * scale > 0.25:
        scale *= 0.25 / (rms * scale)
    freq_peak = estimate_max_frequency_gain(ir * scale)
    if freq_peak > 1.41:
        scale *= 1.41 / freq_peak

    if current_ir is not None:
        cur = np.atleast_2d(np.asarray(current_ir, np.float64))
        if cur.size:
            cur_peak = float(np.abs(cur).max()) * abs(current_scale)
            cur_rms = float(np.sqrt(np.mean(cur * cur))) * abs(current_scale)
            scale *= jump_protection_clamp(peak * scale, rms * scale,
                                           cur_peak, cur_rms)
    return scale


def jump_protection_clamp(new_peak: float, new_rms: float,
                          cur_peak: float, cur_rms: float) -> float:
    """Current-IR jump protection ratio (IRConverter.cpp:148-168): 1.0
    unless the new effective level exceeds BOTH 4x the current level and
    the absolute floor (0.5 peak / 0.25 RMS).  The floors equal the clamp
    protection's ceilings, so in `compute_ir_scale` this is a backstop,
    as in the reference."""
    peak_jump = cur_peak > 1e-9 and new_peak > cur_peak * 4.0 \
        and new_peak > 0.5
    rms_jump = cur_rms > 1e-9 and new_rms > cur_rms * 4.0 and new_rms > 0.25
    if not (peak_jump or rms_jump):
        return 1.0
    clamp = np.inf
    if new_peak > 1e-12 and cur_peak > 1e-12:
        clamp = min(clamp, cur_peak * 4.0 / new_peak)
    if new_rms > 1e-12 and cur_rms > 1e-12:
        clamp = min(clamp, cur_rms * 4.0 / new_rms)
    if np.isfinite(clamp) and 0.0 < clamp < 1.0:
        return float(clamp)
    return 1.0


def trim_ir(ir: np.ndarray, sample_rate: float, target_length: int):
    """Trim stage (LoaderThread.cpp:619-641): cut/zero-pad to target length
    with a 2% raised fade-out (min 256 samples, max 80 ms)."""
    ir = np.atleast_2d(np.asarray(ir, np.float64))
    n = ir.shape[-1]
    out = np.zeros(ir.shape[:-1] + (target_length,))
    copy_n = min(target_length, n)
    out[..., :copy_n] = ir[..., :copy_n]
    min_fade = 256
    max_fade = max(min_fade, int(round(sample_rate * 0.080)))
    fade = int(round(copy_n * 0.02))
    fade = int(np.clip(fade, min_fade, max_fade))
    fade = max(0, min(fade, copy_n - 1))
    if fade > 0:
        ramp = 1.0 - np.arange(fade) / fade   # juce applyGainRamp 1.0 -> 0.0
        out[..., copy_n - fade:copy_n] *= ramp
    return out


@dataclass
class StreamCarry:
    """Per-stream carry returned by `process_streaming`: the chain's state,
    the dither shaper's carry and the stream's block counter."""
    chain: object
    dither: object = None
    block: int = 0


@dataclass
class EngineState:
    """Serializable full engine configuration (the preset-XML analog,
    AudioEngine.StateIO.cpp)."""
    chain: dict = field(default_factory=dict)
    eq: dict = field(default_factory=dict)
    ir: dict = field(default_factory=dict)
    auto_gain_enabled: bool = False
    dither_type: int = 0
    dither_bit_depth: int = 0
    learning_mode: int = 0
    adaptive_banks: dict = field(default_factory=dict)


class ConvoPeqEngine:
    """Offline and block-streaming ConvoPeq-equivalent processor on one
    device."""

    def __init__(self, sample_rate: float = 48000.0, block_size: int = 512,
                 dtype=torch.float32, device="cuda",
                 mixed_phase_cache_dir=None):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype}: torch.float32 or float64")
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.dtype = dtype
        self.eq_params = EQParams()
        self.config = ChainConfig(sample_rate=self.sample_rate)
        self.auto_gain_enabled = False
        self.dither_type = 0
        self.dither_bit_depth = 0          # 0 = no quantization
        # learned adaptive-shaper coefficient banks (DeviceSettings
        # adaptiveCoeff persistence analog; 180 banks)
        self.adaptive_banks = AdaptiveCoefficientBanks()
        self.learning_mode = 0             # LearningMode (bank axis)
        self.phase_mode = PHASE_AS_IS
        self.target_ir_seconds = IR_LENGTH_DEFAULT_SEC
        self.mixed_f1 = MIXED_F1_DEFAULT_HZ
        self.mixed_f2 = MIXED_F2_DEFAULT_HZ
        self.filter_spec = FilterSpec(sample_rate=self.sample_rate)
        self.enable_direct_head = False
        self.apply_spectrum_filter = True

        self._conv_state: StereoConvolverState | None = None
        self._ir_raw: np.ndarray | None = None
        self._ir_prepared: np.ndarray | None = None
        self._ir_peak_latency = 0
        self._ir_freq_peak_db = 0.0
        self._ir_scale = 1.0
        self._prepared_cache = LRUCache()
        self._chain_cache = LRUCache(max_entries=8)
        self._mp_cache = MixedPhaseDiskCache(mixed_phase_cache_dir)
        self._ir_generation = 0          # bumped per distinct IR load
        self._ir_content_key = None      # prepared-cache key of current IR
        self._upgrade_lock = threading.RLock()
        # which mixed-phase design each channel of the last mixed load
        # took: "allpass", "fallback" or "cache"
        self.mixed_phase_branches: list[str] = []

        # the transition plane: crossfades, health and policy
        self.crossfade_enabled = True
        self.telemetry = TelemetryRecorder()
        self.health_monitor = RuntimeHealthMonitor()
        self.policy = RuntimePolicyEngine()
        self._xrun: XrunDetector | None = None
        self._published = None           # last processed offline chain
        self._pending_mix_ramp = None    # old mix value awaiting smoothing
        self.mix_smoothing_time_sec = 0.1  # SMOOTHING_TIME_DEFAULT_SEC
        self._streaming = None
        self._streaming_key = None
        self._streaming_snapshot = None
        self._fade = None                # in-flight streaming crossfade
        self.last_stream_walls: list[float] = []
        self._stream_generator = torch.Generator(
            device=self.device).manual_seed(0)
        self._learner = None             # live NoiseShaperLearner session
        self._learn_ring = None
        self._learn_thread = None
        self._learn_stop = None
        self._learn_gens = 1

    # ------------------------------------------------------------------ IR
    @setup_span("setup.load")
    def load_impulse_response(self, ir, ir_sample_rate=None,
                              phase_mode=None, target_seconds=None):
        """Full loader pipeline.  ir: path or (C, N)/(N,) array.  Its
        host seconds add to the set-up span "setup.load"."""
        if isinstance(ir, (str, bytes)) or hasattr(ir, "__fspath__"):
            wav = read_wav(ir)
            ir = wav.samples
            ir_sample_rate = float(wav.sample_rate)
        ir = np.atleast_2d(np.asarray(ir, np.float64))
        if ir_sample_rate is None:
            ir_sample_rate = self.sample_rate
        if self._ir_raw is None or self._ir_raw.shape != ir.shape \
                or not np.array_equal(self._ir_raw, ir):
            # a different IR invalidates in-flight progressive upgrades
            self._ir_generation += 1
        if phase_mode is not None:
            self.phase_mode = phase_mode
        if target_seconds is not None:
            self.target_ir_seconds = float(target_seconds)

        key = content_hash(ir, ir_sample_rate, self.sample_rate,
                           self.phase_mode, self.target_ir_seconds,
                           self.mixed_f1, self.mixed_f2, self.block_size,
                           self.filter_spec, self.enable_direct_head,
                           self.apply_spectrum_filter)
        cached = self._prepared_cache.get(key)
        if cached is not None:
            (self._conv_state, self._ir_prepared, self._ir_peak_latency,
             self._ir_freq_peak_db, self._ir_scale) = cached
            self._ir_raw = ir
            self._ir_content_key = key
            return self

        # Transform: resample
        if ir_sample_rate != self.sample_rate:
            ir = resample_ir(ir, ir_sample_rate, self.sample_rate)

        # Trim
        target_len = int(round(self.target_ir_seconds * self.sample_rate))
        trimmed = trim_ir(ir, self.sample_rate, target_len)

        # Phase transform
        if self.phase_mode == PHASE_MINIMUM:
            trimmed = minimum_phase(trimmed)
        elif self.phase_mode == PHASE_MIXED:
            trimmed = self._mixed_phase(trimmed)

        # Analysis + energy scale with clamp protection; the previously
        # loaded (already-scaled) IR feeds the jump-protection clamp
        scale = compute_ir_scale(trimmed, current_ir=self._ir_prepared,
                                 current_scale=1.0)
        self._ir_peak_latency = estimate_peak_latency(trimmed)
        self._ir_freq_peak_db = ir_peak_gain_db(trimmed * scale)
        self._ir_scale = scale

        # Build (SetImpulse per channel; a mono IR serves both channels)
        ir_t = torch.as_tensor(trimmed, dtype=self.dtype)
        self._conv_state = stereo_prepare(
            ir_t[0] if ir_t.shape[0] == 1 else ir_t, self.block_size,
            self.filter_spec, scale=scale,
            enable_direct_head=self.enable_direct_head,
            apply_spectrum_filter=self.apply_spectrum_filter,
            device=self.device)
        self._ir_prepared = trimmed * scale
        self._ir_raw = ir
        self._prepared_cache.put(key, (self._conv_state, self._ir_prepared,
                                       self._ir_peak_latency,
                                       self._ir_freq_peak_db, self._ir_scale))
        self._ir_content_key = key
        return self

    def _mixed_phase(self, trimmed):
        """Mixed phase per channel: the allpass design, or the spectral
        blend where its magnitude gate rejects it; cached on disk."""
        mp_key = self._mp_cache.make_key(trimmed, self.sample_rate, "mixed",
                                         self.mixed_f1, self.mixed_f2)
        cached_mp = self._mp_cache.load(mp_key)
        if cached_mp is not None and cached_mp.shape == trimmed.shape:
            self.mixed_phase_branches = ["cache"] * trimmed.shape[0]
            return cached_mp
        minp = minimum_phase(trimmed)
        chans, branches = [], []
        for ch in range(trimmed.shape[0]):
            m = mixed_phase_allpass(trimmed[ch], minp[ch], self.sample_rate,
                                    self.mixed_f1, self.mixed_f2,
                                    num_sections=8, freq_points=64,
                                    generations=24, population=16)
            branches.append("allpass" if m is not None else "fallback")
            if m is None:
                m = mixed_phase_fallback(trimmed[ch], minp[ch],
                                         self.sample_rate, self.mixed_f1,
                                         self.mixed_f2)
            chans.append(m)
        mixed = np.stack(chans)
        self._mp_cache.store(mp_key, mixed)
        self.mixed_phase_branches = branches
        return mixed

    # ------------------------------------------------------------- config
    def set_eq_band(self, i, **kw):
        self.eq_params.set_band(i, **kw)
        return self

    def set_eq(self, params: EQParams):
        self.eq_params = params
        return self

    def set_processing_order(self, order: int):
        self.config = replace(self.config, order=order)
        return self

    def set_oversampling(self, factor: int, preset: int | None = None):
        kw = {"oversampling_factor": factor}
        if preset is not None:
            kw["oversampling_preset"] = preset
        self.config = replace(self.config, **kw)
        return self

    def set_soft_clip(self, enabled: bool, saturation: float | None = None):
        kw = {"soft_clip_enabled": enabled}
        if saturation is not None:
            kw["saturation_amount"] = float(saturation)
        self.config = replace(self.config, **kw)
        return self

    def set_wet_dry_mix(self, mix: float):
        """Change the wet/dry mix.  The next process() call smooths the
        change per sample over mix_smoothing_time_sec through the
        equal-power curve — the reference's mixSmoother
        (ConvolverProcessor.Runtime.cpp:601-603, a LinearRamp over
        smoothingTimeSec, default 0.1 s)."""
        old = self.config.wet_dry_mix
        if isinstance(self._pending_mix_ramp, tuple):
            # mid-ramp retarget: start from the value actually reached
            old = self._pending_mix_ramp[0]
        mix = float(mix)
        if mix != old:
            self._pending_mix_ramp = old
        self.config = replace(self.config, wet_dry_mix=mix)
        return self

    def set_mix_smoothing_time(self, seconds: float):
        """smoothingTimeSec, clamped to the reference's [0.01, 0.5] s
        (ConvolverProcessor.h:167-169)."""
        self.mix_smoothing_time_sec = float(np.clip(seconds, 0.01, 0.5))
        return self

    def set_bypass(self, eq: bool | None = None, conv: bool | None = None):
        kw = {}
        if eq is not None:
            kw["eq_bypassed"] = eq
        if conv is not None:
            kw["conv_bypassed"] = conv
        self.config = replace(self.config, **kw)
        return self

    def set_auto_gain(self, enabled: bool):
        self.auto_gain_enabled = bool(enabled)
        return self

    def set_dither(self, shaper_type: int, bit_depth: int):
        self.dither_type = int(shaper_type)
        self.dither_bit_depth = int(bit_depth)
        return self

    # ------------------------------------------------------------ derived
    def auto_gain_plan(self) -> AutoGainPlan:
        """AutoGainPlanner evaluation from the current EQ and IR analysis."""
        os_factor = resolve_oversampling_factor(
            self.config.oversampling_factor, self.sample_rate)
        proc_rate = self.sample_rate * os_factor
        # eqMaxGainDb = max(measured, upperBound) — the reference's
        # 'Builder collapse' (AudioEngine.RebuildDispatch.cpp:694)
        inp = PlannerInput(
            eq_max_gain_db=estimate_planner_gain_db(self.eq_params, proc_rate),
            eq_max_q=max_active_q(self.eq_params),
            ir_freq_peak_gain_db=self._ir_freq_peak_db,
        )
        return plan(self.auto_gain_enabled, self.config.order,
                    self.config.eq_bypassed,
                    self.config.conv_bypassed or self._conv_state is None, inp)

    def latency_breakdown(self) -> LatencyBreakdown:
        """AudioEngine.Processing.Latency.cpp model: OS FIR group delay per
        stage referred to base rate, NUC algorithm latency, IR peak
        latency, soft-clip local 2x OS (15 base samples)."""
        lb = LatencyBreakdown()
        os_factor = resolve_oversampling_factor(
            self.config.oversampling_factor, self.sample_rate)
        if os_factor > 1:
            total = 0.0
            for i, st in enumerate(make_stages(
                    os_factor, self.config.oversampling_preset)):
                # the engine counts (taps-1)/2 per stage at base rate
                # (Latency.cpp:22-23)
                total += st.center_tap / (2 ** i)
            lb.oversampling_latency_samples = int(round(total))
        if self._conv_state is not None and not self.config.conv_bypassed:
            lb.algorithm_latency_samples = next_pow2(max(self.block_size, 64))
            lb.ir_peak_latency_samples = self._ir_peak_latency
        if self.config.soft_clip_enabled and os_factor == 1:
            lb.softclip_latency_samples = 15   # Latency.cpp:104-107
        return lb

    # ------------------------------------------------------------ process
    def _chain_key(self, strip_mix: bool = False):
        # the IR's identity is the prepared-cache content key, stable over
        # the IR's life.  strip_mix=True leaves the wet/dry mix out: two
        # configs compare equal iff they differ ONLY in mix (the
        # pure-mix-change test the crossfade skip needs)
        ir_key = None if self._conv_state is None else self._ir_content_key
        cfg_repr = repr(replace(self.config, wet_dry_mix=-1.0)) \
            if strip_mix else repr(self.config)
        return (self.eq_params.config_key(),
                cfg_repr, self.auto_gain_enabled,
                self.dither_type, self.dither_bit_depth, ir_key)

    def nuc_layer_shapes(self) -> list[tuple[int, int, int]]:
        """[(partition size, partitions, offset)] of the loaded IR's NUC
        layers, one channel's (both channels share the plan)."""
        if self._conv_state is None:
            return []
        return [(lp.part_size, lp.num_parts, lp.offset)
                for lp in self._conv_state.left.plan.layers]

    def _forward_horizon(self) -> int:
        """How many samples beyond n the chain output at n can depend on:
        the largest NUC partition (circular per-partition spectrum
        filtering) plus the delay-compensated OS/soft-clip FIR spans."""
        h = 4096                         # OS cascade + soft-clip FIR cover
        if self._conv_state is not None:
            for st in (self._conv_state.left, self._conv_state.right):
                for lp in st.plan.layers:
                    h = max(h, 2 * lp.part_size)
        return h

    def _transition_snapshot(self) -> dict:
        """The dspProjection fields CrossfadeAuthority classifies on
        (runtime/crossfade.classify_transition keys)."""
        return {
            "conv_bypassed": self.config.conv_bypassed,
            "oversampling_factor": self.config.oversampling_factor,
            "conv_hc_mode": self.config.conv_hc_mode,
            "conv_lc_mode": self.config.conv_lc_mode,
            "phase_mode": self.phase_mode,
            "tail_mode": self.filter_spec.tail_mode,
            "enable_direct_head": self.enable_direct_head,
            "target_ir_seconds": self.target_ir_seconds,
        }

    def _effective_config(self) -> ChainConfig:
        cfg = self.config
        if self.auto_gain_enabled:
            g_in, g_mk, g_trim = self.auto_gain_plan().linear()
            cfg = replace(cfg, input_headroom_gain=g_in,
                          output_makeup_gain=g_mk,
                          convolver_input_trim_gain=g_trim)
        if self.dither_bit_depth > 0:
            # headroom is applied inside the dither quantizer
            cfg = replace(cfg, apply_output_headroom=False)
        return cfg

    def _chain_fn(self, cfg: ChainConfig, ramp: bool):
        """The chain as a callable: (x) without a convolver, (x, conv) or
        with a ramp (x, conv, mix_ramp); the EQ parameters snapshotted."""
        eqp = copy.deepcopy(self.eq_params)
        if self._conv_state is None:
            return lambda v: process_chain(v, cfg, eqp, None)
        if ramp:
            return lambda v, c, m: process_chain(v, cfg, eqp, c, mix_ramp=m)
        return lambda v, c: process_chain(v, cfg, eqp, c)

    def _mix_ramp(self, cfg: ChainConfig, n: int):
        """The per-sample mix of a pending change over this call's n
        samples (at the processing rate), or None; a buffer shorter than
        the smoothing window carries (value reached, steps left) into the
        next call, on the same linear trajectory."""
        pend = self._pending_mix_ramp
        if pend is None:
            return None
        if self._conv_state is None or cfg.conv_bypassed:
            self._pending_mix_ramp = None
            return None
        os_f = resolve_oversampling_factor(cfg.oversampling_factor,
                                           self.sample_rate)
        n_proc = n * os_f
        if isinstance(pend, tuple):
            old_m, steps = pend
        else:
            old_m = float(pend)
            steps = max(1, int(self.sample_rate * os_f
                               * self.mix_smoothing_time_sec + 0.5))
        new_m = float(cfg.wet_dry_mix)
        k = np.arange(n_proc) + 1.0       # LinearRamp: advance first
        ramp = np.where(k >= steps, new_m,
                        old_m + (new_m - old_m) / steps * k)
        self._pending_mix_ramp = (float(ramp[-1]), steps - n_proc) \
            if n_proc < steps else None
        return torch.as_tensor(ramp, dtype=self.dtype, device=self.device)

    def process(self, x, generator=None, uniforms=None,
                return_chain_output: bool = False):
        """Process (..., 2, N) audio through the full chain on the engine's
        device; returns a tensor there, or with return_chain_output=True
        the pair (y, q): y the chain's output, which the dither quantizes,
        and q the output (y itself when the dither is off).

        A structural config change since the previous call is crossfaded:
        the OLD chain runs over the fade window (plus its forward horizon)
        and the new output fades in over it (the offline form of the
        reference's runLatencyAlignedCrossfadeMixLoop, CrossfadeRuntime.h).
        Dither quantization follows the mix, as in the reference's output
        stage: uniforms (..., N, 2) in [0, 1), else drawn from
        `generator`, else from a generator seeded 0."""
        x = torch.as_tensor(x).to(self.device, self.dtype)
        cfg = self._effective_config()
        cache_key = self._chain_key()
        snap = self._transition_snapshot()
        mix_key = self._chain_key(strip_mix=True)
        mix_ramp = self._mix_ramp(cfg, x.shape[-1])

        trace_key = (cache_key, "mixramp") if mix_ramp is not None \
            else cache_key
        fn = self._chain_cache.get(trace_key)
        if fn is None:
            fn = self._chain_fn(cfg, mix_ramp is not None)
            self._chain_cache.put(trace_key, fn)
        with StageTimer(self.telemetry, "process", self.device):
            if self._conv_state is None:
                y = fn(x)
            elif mix_ramp is not None:
                y = fn(x, self._conv_state, mix_ramp)
            else:
                y = fn(x, self._conv_state)

        prev = self._published
        structural = (self.crossfade_enabled and prev is not None
                      and prev["key"] != cache_key)
        if structural and not (mix_ramp is not None
                               and prev.get("mix_key") == mix_key):
            # (a pure mix change is carried by the per-sample smoother: a
            # crossfade on top would double-fade)
            triggers = classify_transition(prev["snapshot"], snap) \
                or ("default",)
            ft = fade_time_for(triggers)
            fade_n = min(int(round(ft * self.sample_rate)), x.shape[-1])
            if fade_n > 1:
                # the old chain runs over the fade window plus its forward
                # dependence horizon: a bare prefix would diverge near its
                # end (the NUC spectrum filter is circular per partition)
                xp = x[..., :min(fade_n + prev["margin"], x.shape[-1])]
                old_fn, old_conv = prev["fn"], prev["conv"]
                y_old = old_fn(xp) if old_conv is None else old_fn(xp,
                                                                   old_conv)
                new_hic = bool(cfg.apply_output_headroom)
                if prev["headroom_in_chain"] != new_hic:
                    # the dither setting flipped between the two chains:
                    # reconcile the -1 dB output-headroom convention
                    y_old = y_old * (K_OUTPUT_HEADROOM if new_hic
                                     else 1.0 / K_OUTPUT_HEADROOM)
                mixed = crossfade_mix(y_old[..., :fade_n], y[..., :fade_n],
                                      self.sample_rate, ft)
                y = torch.cat([mixed, y[..., fade_n:]], dim=-1)
                self.telemetry.push("crossfade", triggers=list(triggers),
                                    fade_ms=ft * 1e3, path="offline")
        # the published chain is the PLAIN one (a later crossfade calls it
        # as the old chain without a ramp)
        pub_fn = fn
        if mix_ramp is not None:
            pub_fn = self._chain_cache.get(cache_key)
            if pub_fn is None:
                pub_fn = self._chain_fn(cfg, False)
                self._chain_cache.put(cache_key, pub_fn)
        self._published = {"key": cache_key, "fn": pub_fn,
                           "conv": self._conv_state, "snapshot": snap,
                           "mix_key": mix_key,
                           "headroom_in_chain":
                               bool(cfg.apply_output_headroom),
                           "margin": self._forward_horizon()}

        q = y
        if self.dither_bit_depth > 0:
            if uniforms is None and generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            q = apply_dither(y, self.dither_type, self.sample_rate,
                             self.dither_bit_depth, uniforms=uniforms,
                             generator=generator,
                             adaptive_coeffs=self._adaptive_coeffs())
        return (y, q) if return_chain_output else q

    def _adaptive_coeffs(self):
        return self.adaptive_banks.get(self.sample_rate,
                                       self.dither_bit_depth,
                                       self.learning_mode)

    def streaming_chain(self, folded: bool = False, fdl_dtype=None,
                        partition: int | None = None) -> StreamingChain:
        """The block-at-a-time serving chain of the current config
        (runtime/streaming.py) on the engine's device.  Oversampled
        configs run the convolver at the processing rate, so the base-rate
        block is plan.latency / os_factor.

        folded=True: the LTI stages baked into the IR at build time
        (`StreamingChain.folded_from_ir`), so the step is sanitize -> NUC
        -> scalar gains; needs a fused-eligible config and a loaded IR.
        fdl_dtype (torch.float16) stores the delay line's spectra in half
        precision.  partition (folded only): the bigblock windowed tier, a
        single layer whose partition is the serving window."""
        cfg = self._effective_config()
        eqp = self.eq_params if not cfg.eq_bypassed else None
        if partition is not None and not folded:
            raise ValueError("partition (the bigblock tier) requires "
                             "folded=True")
        if folded:
            if self._ir_prepared is None:
                raise ValueError("folded streaming needs a loaded IR")
            return StreamingChain.folded_from_ir(
                cfg, eqp, torch.as_tensor(self._ir_prepared,
                                          dtype=self.dtype),
                self.filter_spec, block_size=self.block_size,
                dtype=self.dtype, fdl_dtype=fdl_dtype, partition=partition,
                device=self.device)
        left = self._conv_state.left if self._conv_state is not None else None
        right = self._conv_state.right if self._conv_state is not None \
            else None
        return StreamingChain(cfg, eqp, left, right, dtype=self.dtype,
                              fdl_dtype=fdl_dtype, device=self.device)

    def process_streaming(self, x, state=None, folded: bool = False):
        """Stream (..., 2, N) through the serving chain block by block.

        Returns (y, StreamCarry); pass the carry back to continue the
        stream (the audio-callback usage).  folded=True streams through
        `streaming_chain(folded=True)` (the LTI stages baked into the IR;
        a fused-eligible config only).  `last_stream_walls` holds each
        block's wall seconds of the call.  A config change mid-stream
        keeps the OLD chain and the caller's state for the fade window,
        starts the new chain from fresh state and mixes with the linear
        fade-in ramp; every block is timed against the 1.5 x block-period
        xrun threshold (fenced by a synchronize on the card), and the
        health monitor and policy ladder tick on it."""
        x = torch.as_tensor(x).to(self.device, self.dtype)
        key = (self._chain_key(), bool(folded))
        sc = self._streaming
        if sc is None:
            sc = self.streaming_chain(folded=folded)
            self._streaming = sc
            self._streaming_key = key
            self._streaming_snapshot = self._transition_snapshot()
        carry = state if isinstance(state, StreamCarry) else \
            (StreamCarry(chain=state) if state is not None else None)
        if key != self._streaming_key:
            new_sc = self.streaming_chain(folded=folded)
            snap = self._transition_snapshot()
            if (self.crossfade_enabled and carry is not None
                    and new_sc.block_size == sc.block_size):
                triggers = classify_transition(self._streaming_snapshot,
                                               snap) or ("default",)
                ft = fade_time_for(triggers)
                fade_n = max(1, int(round(ft * self.sample_rate)))
                # the OLD chain's headroom convention, for the mix
                self._fade = {"sc": sc, "state": carry.chain,
                              "headroom_in_chain":
                                  bool(sc.cfg.apply_output_headroom),
                              "cf": CrossfadeState(fade_samples=fade_n)}
                self.telemetry.push("crossfade", triggers=list(triggers),
                                    fade_ms=ft * 1e3, path="streaming")
                carry = None     # new chain starts from fresh state
            else:
                self._fade = None
            sc = new_sc
            self._streaming = sc
            self._streaming_key = key
            self._streaming_snapshot = snap

        bs = sc.block_size
        if self._xrun is None or self._xrun.period_s != bs / self.sample_rate:
            self._xrun = XrunDetector(self.sample_rate, bs)

        dithering = self.dither_bit_depth > 0
        if carry is None:
            chain_state = sc.init_state(tuple(x.shape[:-2]))
            dither_state, block_ctr = None, 0
        else:
            chain_state = carry.chain
            dither_state, block_ctr = carry.dither, carry.block
        if dithering and dither_state is None:
            # the shaper carry lives for the stream (DSPCoreDouble.cpp:582)
            # and rides the returned carry
            dither_state = dither_state_init(x.shape[:-1], self.dither_type,
                                             self.dtype, self.device)
            block_ctr = 0
        new_headroom_in_chain = bool(sc.cfg.apply_output_headroom)
        nb = x.shape[-1] // bs
        outs = []
        self.last_stream_walls = []
        warmed = getattr(sc, "_xrun_warmed", False)
        for k in range(nb):
            blk = x[..., k * bs:(k + 1) * bs]
            t0 = time.perf_counter()
            chain_state, y = sc.step(chain_state, blk)
            fade = self._fade
            if fade is not None:
                fade["state"], y_old = fade["sc"].step(fade["state"], blk)
                if fade["headroom_in_chain"] != new_headroom_in_chain:
                    adj = K_OUTPUT_HEADROOM if new_headroom_in_chain \
                        else 1.0 / K_OUTPUT_HEADROOM
                    y_old = y_old * adj
                fade["cf"], y = crossfade_blocks(
                    fade["cf"], y_old, y, self.sample_rate)
                if not fade["cf"].active:
                    self._fade = None
            y_pre_dither = y
            if dithering:
                # dither after the mix, as offline; the block's TPDF
                # uniforms from the engine's stream generator
                u = torch.rand(y.shape + (2,),
                               generator=self._stream_generator,
                               dtype=y.dtype, device=y.device)
                y, dither_state = apply_dither(
                    y, self.dither_type, self.sample_rate,
                    self.dither_bit_depth, uniforms=u,
                    adaptive_coeffs=self._adaptive_coeffs(),
                    state=dither_state, return_state=True)
                block_ctr += 1
            if y.is_cuda:
                # this stream's work only: a live learner's launches run
                # on a stream of their own
                torch.cuda.current_stream(y.device).synchronize()
            dt = time.perf_counter() - t0
            self.last_stream_walls.append(dt)
            if not warmed:
                # the first block after a (re)build pays the kernels'
                # build and first launches: counted, never as an xrun
                warmed = True
                sc._xrun_warmed = True
                self._xrun.record_step(0.0, count_xrun=False)
            elif self._xrun.record_step(dt):
                self.telemetry.push("xrun", duration_us=dt * 1e6,
                                    block=int(k))
            ring = self._learn_ring
            if ring is not None and ring.writable >= 2 * bs:
                # live capture for the adaptive-shaper learner: the first
                # stream, pre-dither (the reference pushes the audio
                # entering the shaper into its LockFreeRingBuffer,
                # AudioEngine.Learning.cpp).  Outside the timed region,
                # and only when the ring has room: a full ring costs no
                # device-to-host copy
                blk0 = y_pre_dither.reshape(
                    (-1,) + tuple(y_pre_dither.shape[-2:]))[0]
                ring.push(blk0.T.reshape(-1).to("cpu", torch.float64)
                          .numpy())
            outs.append(y)
        health = self.health_monitor.tick(self._xrun.xruns, self._xrun.steps)
        self.policy.evaluate(health)
        out_carry = StreamCarry(chain=chain_state, dither=dither_state,
                                block=block_ctr)
        if not outs:
            return x[..., :0], out_carry
        return torch.cat(outs, dim=-1), out_carry

    def progressive_upgrade(self, target_block_size: int,
                            background: bool = False, on_step=None):
        """ProgressiveUpgradeThread analog (ProgressiveUpgradeThread.cpp):
        step the convolver block/partition size up through the reference's
        ladder {1024, 2048, 4096} (filtered to (current, target]), each
        step re-preparing via the prepared-state cache.

        background=True runs the ladder on a worker thread that cancels
        itself if the engine loads a different IR (generation check) or
        `cancel()` is called; returns the started ProgressiveUpgrader.
        Synchronous mode runs the ladder inline and returns the engine."""
        if self._ir_raw is None:
            raise RuntimeError("no IR loaded")
        upgrader = ProgressiveUpgrader(self, int(target_block_size), on_step)
        if background:
            upgrader.start()
            return upgrader
        upgrader.run()
        return self

    def _upgrade_step(self, block_size: int):
        """One publish: re-prepare the loaded IR at `block_size` (on the
        engine's device, whichever thread runs it) and adopt it."""
        with self._upgrade_lock:
            self.block_size = int(block_size)
            self.load_impulse_response(self._ir_raw, self.sample_rate)

    def start_learning(self, mode: int | None = None,
                       generations_per_feed: int = 1, workers: int = 2,
                       ring_samples: int = 1 << 20):
        """Start the live adaptive-shaper learning session
        (AudioEngine.Learning.cpp + NoiseShaperLearner.h): blocks
        streamed through `process_streaming` are captured pre-dither into
        the native SPSC ring, a daemon worker runs CMA-ES generations on
        K_FFT_LENGTH windows under the 3-phase schedule, and each improved
        coefficient set is published into `adaptive_banks`: the ADAPTIVE9
        dither picks it up on its next block (the RCU-handoff analog).
        Idempotent while a session runs."""
        from ..models.learner import NoiseShaperLearner
        from ..utils.native import NativeRing
        if self._learn_thread is not None:
            return self
        if mode is not None:
            self.learning_mode = int(mode)
        bits = self.dither_bit_depth if self.dither_bit_depth > 0 else 16
        self._learn_ring = NativeRing(ring_samples)
        self._learner = NoiseShaperLearner(
            self.sample_rate, bits, self.learning_mode, workers=workers,
            device=self.device)
        self._learn_gens = max(1, int(generations_per_feed))
        self._learn_stop = threading.Event()
        t = threading.Thread(target=self._learning_loop,
                             name="NoiseShaperLearning", daemon=True)
        self._learn_thread = t
        t.start()
        return self

    def stop_learning(self, timeout: float = 120.0):
        """Stop the learning worker; returns the final LearnedState (None
        if learning never ran).  The learned banks stay published in
        `adaptive_banks` and persist through save_state / load_state."""
        if self._learn_thread is None:
            return self._learner.state() if self._learner else None
        self._learn_stop.set()
        self._learn_thread.join(timeout=timeout)
        if self._learn_thread.is_alive():
            # the worker is mid-feed; keep the session registered so a
            # new start_learning cannot attach a second consumer to the
            # single-consumer ring: callers can retry stop_learning
            self.telemetry.push("learning_stop_timeout",
                                timeout_s=float(timeout))
            return self._learner.state()
        self._learn_thread = None
        self._learn_ring = None
        return self._learner.state()

    def _learning_loop(self):
        """The worker: drain the ring, feed K_FFT_LENGTH windows to the
        learner, publish each finite best into `adaptive_banks`."""
        from ..models.learner import K_FFT_LENGTH
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        need = 2 * K_FFT_LENGTH                 # interleaved stereo
        pending = []
        have = 0
        while not self._learn_stop.is_set():
            avail = self._learn_ring.readable
            if avail >= 2:
                chunk = self._learn_ring.pop(avail - (avail % 2))
                if chunk is not None:
                    pending.append(chunk)
                    have += chunk.size
            if have < need:
                time.sleep(1e-3)
                continue
            inter = np.concatenate(pending)
            pending, have = [], 0
            audio = inter.reshape(-1, 2).T       # (2, N)
            try:
                if stream is None:
                    state = self._learner.feed(audio, self._learn_gens)
                else:
                    with torch.cuda.stream(stream):
                        state = self._learner.feed(audio, self._learn_gens)
            except Exception as e:
                self.telemetry.push("learning_error", error=repr(e))
                continue
            if state.best_coefficients is not None and \
                    np.isfinite(state.best_score):
                self.adaptive_banks.store_state(
                    state, self.sample_rate, self._learner.bit_depth,
                    self.learning_mode)
                self.telemetry.push(
                    "learning", generation=state.generations,
                    score=state.best_score, phase=self._learner.phase)

    def telemetry_report(self) -> dict:
        """Telemetry stats, current health and policy, xrun counters."""
        rep = {
            "health": int(self.health_monitor.health),
            "policy_level": int(self.policy.level),
            "policy_actions": list(self.policy.actions),
            "stage_stats": self.telemetry.stage_stats,
        }
        if self._xrun is not None:
            rep["xruns"] = self._xrun.xruns
            rep["steps"] = self._xrun.steps
        return rep

    def export_evidence_dir(self, directory) -> dict:
        """Write the structured audit artifact set (ISREvidenceExporter
        analog: one JSON artifact a live subsystem, plus a sha256
        manifest; see runtime/evidence.py).  Returns the manifest."""
        from ..runtime.evidence import EvidenceExporter
        return EvidenceExporter(self).export(directory)

    # ------------------------------------------------------------ state IO
    def save_state(self) -> str:
        """The full configuration as JSON (preset analog), in the JAX
        package's format."""
        st = EngineState(
            chain=asdict(self.config),
            eq={
                "band_types": self.eq_params.band_types.tolist(),
                "freqs": self.eq_params.freqs.tolist(),
                "gains_db": self.eq_params.gains_db.tolist(),
                "qs": self.eq_params.qs.tolist(),
                "modes": self.eq_params.modes.tolist(),
                "enabled": self.eq_params.enabled.tolist(),
                "structure": self.eq_params.structure,
                "saturation": self.eq_params.saturation,
                "agc_enabled": self.eq_params.agc_enabled,
            },
            ir={
                "phase_mode": self.phase_mode,
                "target_seconds": self.target_ir_seconds,
                "mixed_f1": self.mixed_f1,
                "mixed_f2": self.mixed_f2,
                "tail_mode": self.filter_spec.tail_mode,
                "tail_enabled": self.filter_spec.tail_enabled,
                "tail_start_seconds": self.filter_spec.tail_start_seconds,
                "tail_strength": self.filter_spec.tail_strength,
                "tail_l1l2_multiplier": self.filter_spec.tail_l1l2_multiplier,
                "hc_mode": self.filter_spec.hc_mode,
                "lc_mode": self.filter_spec.lc_mode,
                "enable_direct_head": self.enable_direct_head,
            },
            auto_gain_enabled=self.auto_gain_enabled,
            dither_type=self.dither_type,
            dither_bit_depth=self.dither_bit_depth,
            learning_mode=self.learning_mode,
            adaptive_banks=self.adaptive_banks.to_dict(),
        )
        return json.dumps(asdict(st), indent=2)

    def load_state(self, text: str):
        """Staged state restore (AudioEngine.StateIO.cpp load order); reads
        the JAX package's `save_state` JSON as well."""
        st = json.loads(text)
        self.config = ChainConfig(**st["chain"])
        eq = st["eq"]
        self.eq_params = EQParams(
            band_types=np.asarray(eq["band_types"], np.int32),
            freqs=np.asarray(eq["freqs"], np.float64),
            gains_db=np.asarray(eq["gains_db"], np.float64),
            qs=np.asarray(eq["qs"], np.float64),
            modes=np.asarray(eq["modes"], np.int32),
            enabled=np.asarray(eq["enabled"], bool),
            structure=eq["structure"], saturation=eq["saturation"],
            agc_enabled=eq["agc_enabled"])
        iri = st["ir"]
        self.phase_mode = iri["phase_mode"]
        self.target_ir_seconds = iri["target_seconds"]
        self.mixed_f1 = iri["mixed_f1"]
        self.mixed_f2 = iri["mixed_f2"]
        self.filter_spec = FilterSpec(
            sample_rate=self.sample_rate, hc_mode=iri["hc_mode"],
            lc_mode=iri["lc_mode"], tail_mode=iri["tail_mode"],
            tail_enabled=iri["tail_enabled"],
            tail_start_seconds=iri["tail_start_seconds"],
            tail_strength=iri["tail_strength"],
            tail_l1l2_multiplier=iri["tail_l1l2_multiplier"])
        self.enable_direct_head = iri["enable_direct_head"]
        self.auto_gain_enabled = st["auto_gain_enabled"]
        self.dither_type = st["dither_type"]
        self.dither_bit_depth = st["dither_bit_depth"]
        self.learning_mode = st.get("learning_mode", 0)
        self.adaptive_banks = banks_from_dict(st.get("adaptive_banks", {}))
        return self


class ProgressiveUpgrader(threading.Thread):
    """ProgressiveUpgradeThread analog (ProgressiveUpgradeThread.cpp):
    steps the prepared convolver up through the reference's ladder
    {1024, 2048, 4096} on a daemon worker, publishing each step via the
    engine's prepared-state cache.  Each step validates the IR generation
    (a new IR load cancels in-flight upgrades, cpp:60-64) and the
    explicit cancel flag (cpp:53-57)."""

    STEP_TABLE = (1024, 2048, 4096)

    def __init__(self, engine: ConvoPeqEngine, target_block_size: int,
                 on_step=None):
        super().__init__(name="ConvolverProgressiveUpgrade", daemon=True)
        self.engine = engine
        self.on_step = on_step
        self.steps = [s for s in self.STEP_TABLE
                      if engine.block_size < s <= target_block_size]
        self.generation = engine._ir_generation
        self._cancelled = threading.Event()
        self.completed_steps: list[int] = []

    def cancel(self):
        self._cancelled.set()

    def _generation_valid(self) -> bool:
        return (not self._cancelled.is_set()
                and self.engine._ir_generation == self.generation)

    def run(self):
        for step in self.steps:
            if not self._generation_valid():
                return
            self.engine._upgrade_step(step)
            if not self._generation_valid():
                return
            self.completed_steps.append(step)
            if self.on_step is not None:
                self.on_step(step)
