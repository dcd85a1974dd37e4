"""The <=1e-9 tier on the card: the JAX package's f64 parity lines
(counterpart of tools/tpu_parity.py) in native f64, through the f64
frame kernels and the f64 quantizer kernel.

    python -m convopeq_tpu_torch.parity [--profile]

prints one JSON line for each line of LINE_NAMES: its realtime factor (median
of 3 calls after a warm-up, each fenced by torch.cuda.synchronize(), and
the spread), its relative RMS against the port's f64 plain path on the
same card and input, the peak device memory of the timed call, the
batch, and the card's name and power limit.  With --profile, after each
line, the device time of one call by kernel (`headline.profile_call`).

The plain path is the chain run inside `ops.dispatch.plain()`: the
plain frame steps (cuFFT D2Z / Z2D through torch.fft and the plain MAC),
the plain soft clip (cuDNN conv1d and eager elementwise ops) and the DC
blockers in their FFT form (ops/iir_cascade.py `iir_cascade_fft`), an
implementation of its own; the dithered lines quantize its output with the same uniforms
through the quantizer kernel, which is bit-identical to its plain
version.  The JAX package compares against a JAX f64 CPU golden; that
comparison is made on the CPU by tests/test_torch_f64_tier.py.

The lines (48 kHz unless said, fidelity at `fid`, RTF at `rtf`
streams x seconds):

- headline_f64: the folded headline (1M-tap IR, 20-band EQ), one layer
  p = 32768 x 33; 4 x 10 s, 64 x 60 s, as the f32 headline.
- prefilter_f64: `nuc3.prefilter_chain` in f64, the counterpart of the
  JAX package's dd 3-layer NUC line: the 8192 x 8 prefilter and the
  512 x 12, 4096 x 64, 32768 x 23 layers, all on the f64 frame kernels;
  4 x 10 s, 64 x 60 s.
- config5, config5d32, config5d24: `build_semi_fixture`'s 1M-tap IR,
  eq20, soft clip at 0.3, semi-folded; the last two with the adaptive
  lattice dither (fir ladder) at 32 and 24 bits on the 48k factory bank.
  The dithered lines compare the dithered output.  4 x 10 s, 64 x 20 s.
- config6_f64: `config6.config6_chain` in f64 (384 kHz), fidelity before
  the quantizer; 4 x 1.25 s, 256 x 1.25 s with the dither to 24 bits.

Inputs and uniforms of the fidelity runs come from the JAX fixture's
numpy seeds (7 and 11); those of the timed runs are made on the card
from a torch.Generator, the uniforms in f64 inside the call.
"""
from __future__ import annotations

import json
import statistics
import sys
from dataclasses import dataclass

import numpy as np
import torch

from . import config6, headline, nuc3
from .device import card_description, resolve_device
from .models.chain import (ChainConfig, SemiFoldedChain,
                           prepare_semi_folded_convolver)
from .models.dither import ADAPTIVE9, apply_dither
from .models.eq import EQParams
from .models.learner import factory_banks
from .models.nuc import FilterSpec
from .ops.dispatch import plain

LINE_NAMES = ("headline_f64", "prefilter_f64", "config5", "config5d32",
              "config5d24", "config6_f64")
SEMI_BITS = {"config5": 0, "config5d32": 32, "config5d24": 24}
BLOCK_SIZE = 512


def build_headline_fixture(ir_len: int = headline.IR_LEN):
    """(ir, eq params) of the folded headline, as tools/tpu_parity.py's
    `build_headline_fixture` makes them (`headline.headline_ir`, seed 0,
    and the 20-band EQ at gains linspace(-4, 4, 20))."""
    return headline.headline_ir(ir_len, 0), headline.headline_eq()


def factory_bank(sample_rate: float, bits: int, mode: int) -> np.ndarray:
    """The factory bank of (rate, bits, mode), or the first shipped of
    (48k, 16, 0), (96k, 24, 2), (384k, 24, 5) when it is missing, as
    tools/tpu_parity.py's `_factory_bank`."""
    banks = factory_banks()
    k = banks.get(sample_rate, bits, mode)
    for cand in ((48000.0, 16, 0), (96000.0, 24, 2), (384000.0, 24, 5)):
        if k is not None:
            break
        k = banks.get(*cand)
    return np.asarray(k)


def fixture_signal(sample_rate: float, seconds: float, batch: int = 1,
                   bits: int = 0):
    """(x, uniforms or None) of the parity fixture: x (batch, 2, n) normal
    x0.25 from numpy seed 7, uniforms (batch, 2, n, 2) from seed 11 (for
    batch 1, the values of tools/tpu_parity.py's (2, n) fixture)."""
    n = int(sample_rate * seconds)
    x = np.random.default_rng(7).normal(size=(batch, 2, n)) * 0.25
    u = (np.random.default_rng(11).random(size=(batch, 2, n, 2)) if bits
         else None)
    return x, u


def build_semi_fixture(name: str, seconds: float, batch: int = 1,
                       ir_len: int | None = None):
    """(ir, eqp, cfg, x, uniforms or None, k9 or None, bits) of a
    semi-folded parity line, as tools/tpu_parity.py:415-466 makes them:
    "config5*" the 1M-tap 48 kHz IR (seed 0, decay exp(-n/(ir_len/10)),
    x0.02), "config6" the 2 s 384 kHz IR (seed 0, exp(-n/(ir_len/6)),
    x0.02); eq20, soft clip at 0.3, no output headroom.  `ir_len` cuts
    the IR (tests)."""
    rng = np.random.default_rng(0)
    eqp = EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    if name.startswith("config5"):
        sr = 48000.0
        ir_len = 1_000_000 if ir_len is None else ir_len
        decay = np.exp(-np.arange(ir_len) / (ir_len / 10.0))
        ir = np.stack([rng.normal(size=ir_len) * decay,
                       rng.normal(size=ir_len) * decay]) * 0.02
        bits = SEMI_BITS[name]
    elif name == "config6":
        sr = 384000.0
        ir_len = int(sr * 2.0) if ir_len is None else ir_len
        ir = np.stack([rng.normal(size=ir_len),
                       rng.normal(size=ir_len)]) \
            * np.exp(-np.arange(ir_len) / (ir_len / 6.0)) * 0.02
        bits = 24
    else:
        raise ValueError(f"unknown semi-folded line {name!r}")
    cfg = ChainConfig(sample_rate=sr, soft_clip_enabled=True,
                      saturation_amount=0.3, apply_output_headroom=False)
    x, u = fixture_signal(sr, seconds, batch, bits)
    k9 = (factory_bank(sr, 24 if bits >= 24 else bits,
                       5 if sr >= 384000.0 else 0) if bits else None)
    return ir, eqp, cfg, x, u, k9, bits


@dataclass
class Line:
    """One parity line on a device: its chain (chain(x)), the
    dither after it (bits 0: none), what its fidelity compares and its
    run shapes, (batch, seconds)."""
    name: str
    metric: str
    sample_rate: float
    chain: object
    limit: float | None          # rel RMS limit; None: reported
    fid: tuple
    rtf: tuple
    bits: int = 0
    k9: np.ndarray | None = None
    dithered_fidelity: bool = False

    def dither(self, y, u):
        return apply_dither(y, ADAPTIVE9, self.sample_rate, self.bits,
                            uniforms=u, adaptive_coeffs=self.k9,
                            lattice_ladder="fir")

    def run(self, x, u=None):
        """(chain output, dithered output or None) of x, with uniforms u."""
        y = self.chain(x)
        return y, (self.dither(y, u) if self.bits else None)

    def compared(self, y, q):
        return q if self.dithered_fidelity else y

    def render(self, x, generator):
        """The timed call: the chain, then the dither with f64 uniforms
        drawn from `generator` on x's device."""
        y = self.chain(x)
        if not self.bits:
            return y
        u = torch.rand(y.shape + (2,), generator=generator, dtype=y.dtype,
                       device=y.device)
        return self.dither(y, u)


def make_line(name: str, device="cuda", ir_len: int | None = None) -> Line:
    """The prepared line `name` of LINE_NAMES (rebuild-time work on the
    host); `ir_len` cuts the IR (rehearsals)."""
    if name == "headline_f64":
        return Line(name, "RTF 1M-tap stereo IR + 20-band EQ @48kHz, folded,"
                    " f64", headline.SAMPLE_RATE,
                    headline.headline_chain(device, torch.float64,
                                            ir_len or headline.IR_LEN),
                    1e-12, (4, 10.0), (64, 60.0))
    if name == "prefilter_f64":
        return Line(name, "RTF 1M-tap 3-layer NUC + fused 20-band EQ "
                    "prefilter @48kHz, f64", nuc3.SAMPLE_RATE,
                    nuc3.prefilter_chain(device, torch.float64,
                                         ir_len or headline.IR_LEN),
                    1e-12, (4, 10.0), (64, 60.0))
    if name in SEMI_BITS:
        ir, eqp, cfg, _x, _u, k9, bits = build_semi_fixture(name, 0.0,
                                                            ir_len=ir_len)
        state = prepare_semi_folded_convolver(
            ir, BLOCK_SIZE, FilterSpec(cfg.sample_rate), cfg, eqp,
            dtype=torch.float64, device=device)
        limit = {"config5": 1e-12, "config5d32": 1e-9, "config5d24": None}
        return Line(name, f"RTF {name}: 1M-tap + 20-band EQ + soft clip"
                    f"{f' + lattice dither to {bits} bits' if bits else ''}"
                    " @48kHz, semi-folded, f64", cfg.sample_rate,
                    SemiFoldedChain(cfg, state), limit[name], (4, 10.0),
                    (64, 20.0), bits, k9, dithered_fidelity=bool(bits))
    if name == "config6_f64":
        return Line(name, "RTF config6: semi-folded chain + lattice dither "
                    "@384kHz, f64", config6.SAMPLE_RATE,
                    config6.config6_chain(device, torch.float64,
                                          ir_len or config6.IR_LEN),
                    1e-12, (4, config6.SECONDS),
                    (config6.BATCH, config6.SECONDS), config6.BIT_DEPTH,
                    config6.config6_bank())
    raise ValueError(f"unknown parity line {name!r}")


def fidelity_signal(line: Line, device="cuda"):
    """(x, uniforms or None) of `line`'s fidelity run, on `device`."""
    batch, seconds = line.fid
    x, u = fixture_signal(line.sample_rate, seconds, batch, line.bits)
    dev = resolve_device(device)
    return (torch.from_numpy(x).to(dev),
            None if u is None else torch.from_numpy(u).to(dev))


def rel_rms(a, ref) -> float:
    return float(((a.double() - ref.double()).pow(2).mean()
                  / ref.double().pow(2).mean()).sqrt())


def timed_signal(line: Line, device="cuda", seed=1):
    """(batch, 2, seconds * rate) noise x0.25 of `line`'s timed run, made
    on `device` from a seed."""
    batch, seconds = line.rtf
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, 2, int(line.sample_rate * seconds)),
                       generator=gen, device=dev, dtype=torch.float64) * 0.25


def measure_rtf(line: Line, x, reps: int = 3, seed: int = 8) -> dict:
    """Realtime factor of line.render on x: median of `reps` calls after a
    warm-up, each fenced by torch.cuda.synchronize(); the spread and the
    peak device memory of the calls."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = headline.measure(lambda v: line.render(v, gen), x, reps)
    peak = torch.cuda.max_memory_allocated()
    audio = x.shape[0] * x.shape[-1] / line.sample_rate
    return {"rtf": audio / statistics.median(walls),
            "rtf_spread": [audio / max(walls), audio / min(walls)],
            "walls_s": walls, "peak_gib": peak / 2 ** 30}


def main(argv=()):
    """Every line of LINE_NAMES in f64 on the card."""
    card = card_description()
    for name in LINE_NAMES:
        line = make_line(name)
        x, u = fidelity_signal(line)
        y, q = line.run(x, u)
        with plain():
            y_ref, q_ref = line.run(x, u)
        rel = rel_rms(line.compared(y, q), line.compared(y_ref, q_ref))
        del x, u, y, q, y_ref, q_ref
        xt = timed_signal(line)
        row = measure_rtf(line, xt)
        print(json.dumps({
            "line": name, "metric": line.metric, "value": row["rtf"],
            "unit": "x realtime", **row, "batch": line.rtf[0],
            "seconds": line.rtf[1], "rel_rms_vs_f64_plain": rel,
            "rel_rms_limit": line.limit, "fidelity_batch": line.fid[0],
            "fidelity_seconds": line.fid[1],
            "compared": "dithered output" if line.dithered_fidelity
            else "chain output, before any quantizer", "device": card}),
            flush=True)
        if "--profile" in argv:
            gen = torch.Generator(device=xt.device).manual_seed(9)
            headline.print_profile(name, *headline.profile_call(
                lambda: line.render(xt, gen)), card)
        del line, xt
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
