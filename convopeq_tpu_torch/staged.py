"""bench.py bench_all's staged lines on the card: the staged chain
(`models/chain.process_chain`) at 1x, and config3's at 4x, in f32
through the kernels, each line with an f64 twin.

    python -m convopeq_tpu_torch.staged [--profile]

prints one JSON line for each line of LINE_NAMES, then config3_staged,
and the "_f64" twins:
the realtime factor at RTF_SHAPE (median of 3 calls after a warm-up,
each fenced by torch.cuda.synchronize(), and the spread), the peak
device memory of the timed calls, the relative RMS at FIDELITY_SHAPE
against the port's f64 plain path on the same card and input
(`frame_mac="plain"`: cuFFT D2Z / Z2D through torch.fft and the plain
MAC; the f64 EQ and output filter have no kernel), its limit, the
kernel launches of the fidelity run, and the card's name and power
limit.  With --profile, after each line, the device time of one call by
kernel (`headline.profile_call`).

The lines (bench.py:160-252, 48 kHz; the IRs drawn from
np.random.default_rng(0) in bench_all's order, the draws of its input
signal and of config3's IR included, so that the IRs are bench_all's):

- config1: the 20-band EQ alone (gains linspace(-4, 4, 20), Q 0.707);
  the convolver bypassed.  f32 on the card: the blocked EQ, `fused_conv`
  at p = 2048, P = 4.
- config2: the "64k-tap" uniform convolver (`stereo_prepare`, tail mode
  bypass, no spectrum filter); the EQ bypassed.  With the tail bypassed
  the reference's plan keeps one layer, 512 x 32: the first 16,384 taps.
- config4: the 1M-tap stereo IR as the reference's 3-layer NUC (512 x
  12, 4096 x 64, 32768 x 23, spectrum filter on), the EQ bypassed, and
  the analyzer tap (`metering.spectrum_frames`, 4096-point frames) of
  the output inside the timed call, as bench.py's chain4.
- config5_staged: eq20, the 1M-tap NUC and the local 2x soft clip at 0.3,
  staged.  Not parity.py's semi-folded config5.
- config3_staged (`os_lines`): bench config3's EQ->Conv chain
  (`config3.py`: the planner's gains, eq20, the 2 s IR resampled to
  192 kHz) not folded: `process_chain` at oversampling factor 4, the IR
  as a `stereo_prepare` NUC at block 2048 (512 x 4, the reference's
  processing block) with the spectrum filter on, every stage at 192 kHz
  between the halfband cascades.  Users: chains that cannot fold at 4x,
  and the reference engine, which never folds.

Limits: f32 lines 2e-3 relative RMS, the JAX package's f32 bound for the
staged chain (tests/test_precision.py:48-90: the 18 Hz and 20 Hz
output-filter biquads, pole radius 0.998, hold any f32 realization to
~4e-4); the f64 twins 1e-12.  The same biquads set how far under it
the f64 lines sit: on the f64 2x2 route (the JAX package's CPU rule,
which the port follows) they carry ~6e-11 of rounding against the exact
recurrence, and a difference of one ulp in their input, such as the
frame kernels' against cuFFT's, moves their output by ~4e-13 relative
(`ulp_floor`, printed beside each f64 line's fidelity).  config3_staged
keeps both limits: its f32 limit is the larger of 2e-3 and 1.5x the JAX
package's own f32 error for this chain on the CPU, and that is 2e-3
(PERF.md, the f32 floor at 192 kHz: the output filter's 18 Hz high-pass
there, pole radius ~0.9995, holds f32 to ~1e-3); its f64 line sits at
its 1-ulp floor, ~6e-13 at 192 kHz.
"""
from __future__ import annotations

import json
import statistics
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from . import headline
from .device import card_description, resolve_device
from .engine.eq_analysis import estimate_planner_gain_db, max_active_q
from .ir.analyzer import ir_peak_gain_db
from .ir.resample import resample_ir
from .models.chain import ChainConfig, StagedChain
from .models.convolver import stereo_prepare
from .models.eq import EQParams
from .models.gain_planner import (EQ_THEN_CONVOLVER, AutoGainPlan,
                                  PlannerInput, plan)
from .models.metering import spectrum_frames
from .models.nuc import TAIL_BYPASS, FilterSpec
from .ops import frame_conv_kernels as fk
from .ops import fused_conv_kernels as fc
from .ops import quantize_kernels as qk
from .parity import rel_rms

SAMPLE_RATE = 48000.0
LINE_NAMES = ("config1", "config2", "config4", "config5_staged")
FIDELITY_SHAPE = (4, 10.0)        # streams, seconds
RTF_SHAPE = (64, 20.0)
LIMITS = {torch.float32: 2e-3, torch.float64: 1e-12}
BENCH_SECONDS = 20.0              # bench_all's input, drawn before the IRs
BENCH_BATCH = 4


def _bench_draws(with_ir1m: bool = True):
    """(ir64, ir2s, ir1m or None) of bench_all, float64: the same
    generator draws in the same order (its (4, 2, 960000) input, the 64k
    IR, config3's (2, 96000) 2 s IR at 48 kHz, the 1M IR duplicated
    across the pair)."""
    rng = np.random.default_rng(0)
    rng.normal(size=(BENCH_BATCH, 2, int(SAMPLE_RATE * BENCH_SECONDS)))
    ir64 = rng.normal(size=65536) * np.exp(-np.arange(65536) / 10000.0) \
        * 0.05
    ir2s = rng.normal(size=(2, 96000)) * np.exp(-np.arange(96000) / 16000.0) \
        * 0.05
    if not with_ir1m:
        return ir64, ir2s, None
    decay = np.exp(-np.arange(1_000_000) / 100_000.0)
    ir1m = np.stack([rng.normal(size=1_000_000) * decay] * 2) * 0.02
    return ir64, ir2s, ir1m


def bench_irs(ir64_len: int = 65536, ir1m_len: int = 1_000_000):
    """(ir64 (65536,), ir1m (2, 1,000,000)) of bench_all (`_bench_draws`).
    The lengths cut the IRs (tests); the draws stay bench_all's."""
    ir64, _ir2s, ir1m = _bench_draws()
    return ir64[:ir64_len], ir1m[:, :ir1m_len]


def bench_ir3(ir_len: int = 96000) -> np.ndarray:
    """config3's (2, 96000) 2 s reverb IR at 48 kHz (bench.py:207-208),
    float64, from bench_all's draws (`_bench_draws`); the length cuts it
    (tests)."""
    return _bench_draws(with_ir1m=False)[1][:, :ir_len]


def eq20() -> EQParams:
    """bench_all's eq20: the default bands at gains linspace(-4, 4, 20)."""
    p = EQParams()
    p.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    return p


CONFIG3_OS_FACTOR = 4
CONFIG3_RATE = SAMPLE_RATE * CONFIG3_OS_FACTOR     # the processing rate


@dataclass
class Config3Setup:
    """bench config3's host set-up (`config3.py` folds it, `os_lines`
    stages it): the 48 kHz IR, the IR at the processing rate and the
    planner's input."""
    ir: np.ndarray
    ir_hf: np.ndarray
    planner_input: PlannerInput


def config3_setup(ir_len: int = 96000) -> Config3Setup:
    """config3's IR (`bench_ir3`, cut to `ir_len` samples at 48 kHz for
    tests), its resample to 192 kHz and the planner's input, as
    bench.py:207-215."""
    ir = bench_ir3(ir_len)
    pin = PlannerInput(
        eq_max_gain_db=estimate_planner_gain_db(eq20(), CONFIG3_RATE),
        eq_max_q=max_active_q(eq20()),
        ir_freq_peak_gain_db=ir_peak_gain_db(ir))
    return Config3Setup(ir, resample_ir(ir, SAMPLE_RATE, CONFIG3_RATE), pin)


def config3_config(order: int, pin: PlannerInput):
    """(ChainConfig, AutoGainPlan) of config3 in `order`: 48 kHz, 4x
    oversampling, the planner's gains engaged."""
    g = plan(True, order, False, False, pin)
    in_g, mk_g, tr_g = g.linear()
    return ChainConfig(sample_rate=SAMPLE_RATE, order=order,
                       oversampling_factor=CONFIG3_OS_FACTOR,
                       input_headroom_gain=in_g, output_makeup_gain=mk_g,
                       convolver_input_trim_gain=tr_g), g


def planner_db(g: AutoGainPlan) -> dict:
    return {"input": g.input_headroom_db,
            "trim": g.convolver_input_trim_db,
            "makeup": g.output_makeup_db}


@dataclass
class Line:
    """One line in one dtype: its chain (a module whose forward takes
    (x, frame_mac=)), whether the analyzer tap runs on its output, its
    relative-RMS limits by dtype, and fields of its own for its JSON
    line."""
    name: str
    metric: str
    chain: torch.nn.Module
    dtype: torch.dtype
    analyzer: bool = False
    limits: dict = field(default_factory=lambda: LIMITS)
    info: dict = field(default_factory=dict)

    @property
    def limit(self) -> float:
        return self.limits[self.dtype]

    def run(self, x, frame_mac="auto"):
        """The chain's output of x; with the analyzer, (output, frames)."""
        y = self.chain(x, frame_mac=frame_mac)
        return (y, spectrum_frames(y)) if self.analyzer else y

    def output(self, x, frame_mac="auto"):
        out = self.run(x, frame_mac)
        return out[0] if self.analyzer else out


def staged_lines(device="cuda", dtype=torch.float32, ir64_len: int = 65536,
                 ir1m_len: int = 1_000_000) -> dict:
    """{name: Line} of LINE_NAMES in `dtype` (names with "_f64" for
    float64), prepared on `device`; config4 and config5_staged share one
    convolver.  The lengths cut the IRs (tests, rehearsals)."""
    dev = resolve_device(device)
    ir64, ir1m = bench_irs(ir64_len, ir1m_len)
    as_dt = lambda ir: torch.as_tensor(ir).to(dtype)
    conv64 = stereo_prepare(as_dt(ir64), 512,
                            FilterSpec(SAMPLE_RATE, tail_mode=TAIL_BYPASS),
                            apply_spectrum_filter=False, device=dev)
    conv1m = stereo_prepare(as_dt(ir1m), 512, FilterSpec(SAMPLE_RATE),
                            device=dev)
    sr = SAMPLE_RATE
    suffix = "_f64" if dtype == torch.float64 else ""
    kind = "f64" if dtype == torch.float64 else "f32"
    lines = [
        Line("config1", "20-band EQ only", StagedChain(
            ChainConfig(sample_rate=sr, conv_bypassed=True), eq20()), dtype),
        Line("config2", "uniform partitioned conv 64k-tap IR", StagedChain(
            ChainConfig(sample_rate=sr, eq_bypassed=True), None, conv64),
            dtype),
        Line("config4", "NUC 1M-tap stereo IR + analyzer", StagedChain(
            ChainConfig(sample_rate=sr, eq_bypassed=True), None, conv1m),
            dtype, analyzer=True),
        Line("config5_staged", "full chain (EQ+NUC+softclip), staged",
             StagedChain(ChainConfig(sample_rate=sr, soft_clip_enabled=True,
                                     saturation_amount=0.3), eq20(), conv1m),
             dtype),
    ]
    for line in lines:
        line.name += suffix
        line.metric = f"RTF {line.metric} @48kHz, staged, {kind}"
    return {line.name: line for line in lines}


def os_lines(device="cuda", dtype=torch.float32,
             ir3_len: int = 96000) -> dict:
    """{name: Line} of the oversampled line, config3_staged, in `dtype`
    (with "_f64" for float64), prepared on `device`; `ir3_len` cuts
    config3's 48 kHz IR (tests)."""
    dev = resolve_device(device)
    setup = config3_setup(ir3_len)
    cfg, g = config3_config(EQ_THEN_CONVOLVER, setup.planner_input)
    block = cfg.agc_block_size * CONFIG3_OS_FACTOR
    conv = stereo_prepare(torch.as_tensor(setup.ir_hf).to(dtype), block,
                          FilterSpec(CONFIG3_RATE), device=dev)
    f64 = dtype == torch.float64
    line = Line("config3_staged" + ("_f64" if f64 else ""),
                f"RTF config3 EQ->Conv: AutoGainPlanner + 4x OS, 2s IR, "
                f"staged, {'f64' if f64 else 'f32'}",
                StagedChain(cfg, eq20(), conv), dtype,
                info={"planner_db": planner_db(g),
                      "os_factor": CONFIG3_OS_FACTOR,
                      "layers": [[lp.part_size, lp.num_parts]
                                 for lp in conv.left.plan.layers]})
    return {line.name: line}


def signal(batch: int, seconds: float, device="cuda", dtype=torch.float32,
           seed: int = 1):
    """(batch, 2, seconds * 48k) noise x0.25 made on `device` (as
    bench_all's normal x0.25 input)."""
    return headline.headline_input(batch, seconds, device, dtype, seed)


def launch_counts() -> dict:
    return {**fk.launch_counts, **fc.launch_counts, **qk.launch_counts}


def reset_launch_counts() -> None:
    fk.reset_launch_counts()
    fc.reset_launch_counts()
    qk.reset_launch_counts()


def fidelity(line: Line, reference: Line, x) -> tuple:
    """(output, relative RMS against reference's f64 plain path, the
    launches of line's run of x, with the counts set to 0 just before)."""
    reset_launch_counts()
    y = line.output(x)
    torch.cuda.synchronize()
    launches = launch_counts()
    y_ref = reference.output(x.double(), frame_mac="plain")
    return y, rel_rms(y, y_ref), launches


def ulp_floor(line: Line, x, seed: int = 3) -> float:
    """Relative RMS by which line's f64 plain path moves when each input
    sample moves by about one ulp (x (1 + 2^-52 n), n standard normal):
    the f64 chain's own sensitivity, beside which its fidelity is read."""
    x = x.double()
    gen = torch.Generator(device=x.device).manual_seed(seed)
    xp = x * (1.0 + 2.0 ** -52 * torch.randn(x.shape, generator=gen,
                                              device=x.device,
                                              dtype=x.dtype))
    return rel_rms(line.output(xp, frame_mac="plain"),
                   line.output(x, frame_mac="plain"))


def measure_rtf(line: Line, x, reps: int = 3) -> dict:
    """Realtime factor of line.run on x: median of `reps` calls after a
    warm-up, each fenced by torch.cuda.synchronize(); the spread and the
    peak device memory of the calls."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = headline.measure(line.run, x, reps)
    peak = torch.cuda.max_memory_allocated()
    audio = x.shape[0] * x.shape[-1] / SAMPLE_RATE
    return {"rtf": audio / statistics.median(walls),
            "rtf_spread": [audio / max(walls), audio / min(walls)],
            "walls_s": walls, "peak_gib": peak / 2 ** 30}


def report_lines(lines, references: dict, card: str,
                 profile: bool = False) -> None:
    """One JSON line for each of `lines`: its fidelity at FIDELITY_SHAPE
    against the f64 plain path of its "_f64" twin in `references`, then
    its RTF at RTF_SHAPE; with `profile`, the device time of one call by
    kernel after it."""
    for line in lines:
        reference = references[line.name.removesuffix("_f64") + "_f64"]
        x = signal(*FIDELITY_SHAPE, dtype=line.dtype)
        y, rel, launches = fidelity(line, reference, x)
        del x, y
        xt = signal(*RTF_SHAPE, dtype=line.dtype)
        row = measure_rtf(line, xt)
        print(json.dumps({
            "line": line.name, "metric": line.metric, "value": row["rtf"],
            "unit": "x realtime", **row, "batch": RTF_SHAPE[0],
            "seconds": RTF_SHAPE[1], "rel_rms_vs_f64_plain": rel,
            "rel_rms_limit": line.limit, "fidelity_batch": FIDELITY_SHAPE[0],
            "fidelity_seconds": FIDELITY_SHAPE[1], "launches": launches,
            **line.info, "device": card}), flush=True)
        if profile:
            headline.print_profile(line.name, *headline.profile_call(
                lambda: line.run(xt)), card)
        del xt
        torch.cuda.empty_cache()


def main(argv=()):
    """Every line of LINE_NAMES and config3_staged in f32 and in f64 on
    the card."""
    card = card_description()
    lines64 = {**staged_lines("cuda", torch.float64),
               **os_lines("cuda", torch.float64)}
    lines32 = {**staged_lines("cuda", torch.float32),
               **os_lines("cuda", torch.float32)}
    report_lines([*lines32.values(), *lines64.values()], lines64, card,
                 "--profile" in argv)


if __name__ == "__main__":
    main(sys.argv[1:])
