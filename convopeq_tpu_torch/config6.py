"""Bench config6 (counterpart of bench.py:254-339): BASELINE.json's
configuration[4], "full chain with adaptive noise-shaper dither at
384 kHz, batched multi-stream".

    python -m convopeq_tpu_torch.config6 [--profile]

prints one JSON line with the realtime factor on the card (256 streams x
1.25 s) beside the card's name and power limit; with --profile, then the
device time of one call by kernel (torch.profiler), one line each.

- 384 kHz stereo; a 2 s IR (768,000 taps a channel): normal noise x
  exp(-n/(ir_len/6)) x 0.02 from a seed of the port's own; the 20-band
  EQ at gains linspace(-4, 4, 20); FilterSpec(384 kHz), block 512.
- ChainConfig(384 kHz, soft clip on at saturation 0.3, no output
  headroom), prepared semi-folded at partition 32768, in f32 (the bench
  line) or f64 (`config6_chain(dtype=torch.float64)`, the <=1e-9 tier's
  line in `parity.py`): the LTI prefix folds into one uniform partitioned
  convolution per channel (the three frame kernels of the dtype), then
  makeup -> local 2x soft clip -> output DC blocker run staged.
- Then the adaptive 9th-order lattice shaper (fir ladder) to 24 bits on
  the learned 384k/24/mode-5 factory bank, through the quantizer kernel,
  with the uniforms drawn in the same call from an explicit
  torch.Generator on the card.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .device import card_description, resolve_device
from .headline import print_profile, profile_call
from .models.chain import (ChainConfig, SemiFoldedChain,
                           prepare_semi_folded_convolver)
from .models.dither import ADAPTIVE9, apply_dither
from .models.eq import EQParams
from .models.learner import factory_banks
from .models.nuc import FilterSpec

SAMPLE_RATE = 384000.0
IR_LEN = int(SAMPLE_RATE * 2.0)
BLOCK_SIZE = 512
PARTITION = 32768
BIT_DEPTH = 24
BANK_MODE = 5            # the "Long" learning mode's bank
BATCH, SECONDS = 256, 1.25


def config6_ir(ir_len: int = IR_LEN, seed: int = 6) -> np.ndarray:
    """(2, ir_len) float64 stereo reverb IR, as bench.py:281-284 makes it
    (from the port's own seed)."""
    rng = np.random.default_rng(seed)
    decay = np.exp(-np.arange(ir_len) / (ir_len / 6.0))
    return np.stack([rng.normal(size=ir_len),
                     rng.normal(size=ir_len)]) * decay * 0.02


def config6_config() -> ChainConfig:
    return ChainConfig(sample_rate=SAMPLE_RATE, soft_clip_enabled=True,
                       saturation_amount=0.3, apply_output_headroom=False)


def config6_eq() -> EQParams:
    eqp = EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)   # all 20 bands active
    return eqp


def config6_chain(device="cuda", dtype=torch.float32, ir_len: int = IR_LEN,
                  seed: int = 6) -> SemiFoldedChain:
    """The prepared semi-folded chain (rebuild-time work on the host)."""
    cfg = config6_config()
    state = prepare_semi_folded_convolver(
        config6_ir(ir_len, seed), BLOCK_SIZE, FilterSpec(SAMPLE_RATE), cfg,
        config6_eq(), dtype=dtype, partition=PARTITION, device=device)
    return SemiFoldedChain(cfg, state)


def config6_bank() -> np.ndarray:
    """The learned 384k / 24-bit / mode-5 reflection coefficients."""
    k9 = factory_banks().get(SAMPLE_RATE, BIT_DEPTH, BANK_MODE)
    if k9 is None:
        raise ValueError("384k/24/mode-5 factory bank missing")
    return k9


def config6_input(batch: int, seconds: float, device="cuda",
                  dtype=torch.float32, seed: int = 7):
    """(batch, 2, seconds * 384k) normal noise x0.25, made on `device`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = int(SAMPLE_RATE * seconds)
    return torch.randn((batch, 2, n), generator=gen, device=dev,
                       dtype=dtype) * 0.25


def dither(y, k9, generator):
    """The lattice shaper to 24 bits, uniforms drawn from `generator`."""
    u = torch.rand(y.shape + (2,), generator=generator, dtype=y.dtype,
                   device=y.device)
    return apply_dither(y, ADAPTIVE9, SAMPLE_RATE, BIT_DEPTH, uniforms=u,
                        adaptive_coeffs=k9, lattice_ladder="fir")


def render(chain: SemiFoldedChain, x, k9, generator):
    """The whole config6 call: the chain, then the dither."""
    return dither(chain(x), k9, generator)


def measure(chain: SemiFoldedChain, x, k9, reps: int = 3,
            seed: int = 8) -> list:
    """Wall seconds of `reps` render calls after one warm-up call, each
    fenced by torch.cuda.synchronize()."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    render(chain, x, k9, gen)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render(chain, x, k9, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def profile(chain: SemiFoldedChain, x, k9, seed: int = 9):
    """Device time of one render call after a warm-up
    (`headline.profile_call`)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return profile_call(lambda: render(chain, x, k9, gen))


def main(argv=()):
    """config6 at its fixed batch: 256 streams x 1.25 s, f32, on the card."""
    chain = config6_chain("cuda")
    x = config6_input(BATCH, SECONDS, "cuda")
    k9 = config6_bank()
    walls = measure(chain, x, k9)
    card = card_description()
    print(json.dumps({
        "metric": "RTF config6: semi-folded chain + lattice dither @384kHz",
        "value": BATCH * SECONDS / statistics.median(walls),
        "unit": "x realtime",
        "walls_s": walls,
        "batch": BATCH,
        "device": torch.cuda.get_device_name(0),
        "card": card}))
    if "--profile" in argv:
        print_profile("config6", *profile(chain, x, k9), card)


if __name__ == "__main__":
    main(sys.argv[1:])
