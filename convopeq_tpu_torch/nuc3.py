"""The reference 3-layer convolver on the card: the fused-prefilter chain
and the engine's room-correction convolver stage.

    python -m convopeq_tpu_torch.nuc3 [--profile]

prints two JSON lines, each beside the card's name and power limit:
the realtime factor, in f32, of the prefilter chain (64 streams x 60 s;
in f64 it is `parity.py`'s prefilter_f64 line) and of the
room-correction convolver (256 streams x 10 s); with --profile, after
each, the device time of one call by kernel (torch.profiler).

- `prefilter_chain`: the headline's 1M-tap IR (`headline.headline_ir`)
  and 20-band EQ at 48 kHz, block 512, FilterSpec(48 kHz) contour tail.
  The EQ, both DC blockers, the output filter and the HC/LC curve fold
  into one prefilter (65,150 taps, 8192 x 8: the fused kernel); the IR
  goes through `stereo_prepare(apply_spectrum_filter=False)`, the
  reference's 3-layer plan 512 x 12, 4096 x 64 (gain 1.4375),
  32768 x 23 (gain 1.1): the three frame kernels.
- `roomcorr_convolver`: the engine's convolver stage (as
  ConvoPeqEngine prepares an IR, convopeq_tpu/engine/engine.py:351-355)
  on a room-correction-length IR made from a seed: 24,000 stereo taps of
  normal noise x exp(-n/4000) x 0.05, `stereo_prepare` with
  FilterSpec(48 kHz) contour, the spectrum filter and the direct head
  on: 32 direct taps, 512 x 12 (frame kernels) and 4096 x 5 (the fused
  kernel).  It runs at mix 0.7, ramped per sample from 1.0 over 0.1 s.
"""
from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from . import headline
from .device import card_description
from .models.chain import (ChainConfig, PrefilterChain,
                           prepare_fused_prefilter)
from .models.convolver import (StereoConvolver, linear_mix_ramp,
                               stereo_prepare)
from .models.nuc import FilterSpec

SAMPLE_RATE = headline.SAMPLE_RATE
BLOCK_SIZE = headline.BLOCK_SIZE
ROOM_IR_LEN = 24_000
ROOM_MIX, ROOM_MIX_FROM, ROOM_RAMP_SECONDS = 0.7, 1.0, 0.1


def prefilter_chain(device="cuda", dtype=torch.float32,
                    ir_len: int = headline.IR_LEN,
                    seed: int = 0) -> PrefilterChain:
    """The prepared prefilter chain (rebuild-time work on the host)."""
    cfg = ChainConfig(sample_rate=SAMPLE_RATE)
    spec = FilterSpec(SAMPLE_RATE)
    prefilter = prepare_fused_prefilter(
        cfg, headline.headline_eq(), dtype=dtype, spec=spec, ir_len=ir_len,
        block_size=BLOCK_SIZE, device=device)
    conv = stereo_prepare(headline.headline_ir(ir_len, seed), BLOCK_SIZE,
                          spec, apply_spectrum_filter=False, dtype=dtype,
                          device=device)
    return PrefilterChain(cfg, prefilter, conv)


def room_ir(ir_len: int = ROOM_IR_LEN, seed: int = 24) -> np.ndarray:
    """(2, ir_len) float64 room-correction-length IR from a seed."""
    rng = np.random.default_rng(seed)
    decay = np.exp(-np.arange(ir_len) / 4000.0)
    return rng.normal(size=(2, ir_len)) * decay * 0.05


def roomcorr_convolver(device="cuda", dtype=torch.float32,
                       ir_len: int = ROOM_IR_LEN,
                       seed: int = 24) -> StereoConvolver:
    """The prepared stereo convolver of the room-correction IR."""
    state = stereo_prepare(room_ir(ir_len, seed), BLOCK_SIZE,
                           FilterSpec(SAMPLE_RATE), enable_direct_head=True,
                           dtype=dtype, device=device)
    return StereoConvolver(state)


def roomcorr_process(conv: StereoConvolver, x):
    """x (..., 2, N) through the convolver at mix 0.7, ramped from 1.0."""
    ramp = linear_mix_ramp(x.shape[-1], ROOM_MIX_FROM, ROOM_MIX,
                           SAMPLE_RATE, ROOM_RAMP_SECONDS, x.device)
    return conv(x, ROOM_MIX, mix_ramp=ramp)


def _rtf_line(metric, batch, seconds, walls, card) -> str:
    return json.dumps({
        "metric": metric,
        "value": batch * seconds / statistics.median(walls),
        "unit": "x realtime", "walls_s": walls, "batch": batch,
        "seconds": seconds, "device": card})


def main(argv=()):
    """The two realtime factors, f32, on the card."""
    card = card_description()

    def report(metric, name, fn, x):
        print(_rtf_line(metric, x.shape[0], x.shape[-1] / SAMPLE_RATE,
                        headline.measure(fn, x), card))
        if "--profile" in argv:
            headline.print_profile(
                name, *headline.profile_call(lambda: fn(x)), card)

    x = headline.headline_input(64, 60.0, "cuda")
    report("RTF 1M-tap 3-layer NUC + fused 20-band EQ prefilter @48kHz",
           "prefilter chain", prefilter_chain("cuda"), x)
    del x
    conv = roomcorr_convolver("cuda")
    report("RTF 24k-tap room-correction convolver, direct head, mix ramp "
           "@48kHz", "room-correction convolver",
           lambda v: roomcorr_process(conv, v),
           headline.headline_input(256, 10.0, "cuda"))


if __name__ == "__main__":
    main(sys.argv[1:])
