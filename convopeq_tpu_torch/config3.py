"""Bench config3 (counterpart of bench.py:172-223): BASELINE.json's
configuration[2], "EQ->Conv and Conv->EQ chains with AutoGainPlanner +
4x polyphase oversampling".

    python -m convopeq_tpu_torch.config3 [--profile]

prints one JSON line for each order (`config3_eq_conv`,
`config3_conv_eq`) in f32 through the kernels and for its "_f64" twin:
the realtime factor at RTF_SHAPE (median of 3 calls after a warm-up,
each fenced by torch.cuda.synchronize(), and the spread), the peak
device memory, the relative RMS at FIDELITY_SHAPE against the port's f64
plain path (`frame_mac="plain"`) on the same card and input, its limit,
the planner's three gains in dB, the plan (p, P), the kernel launches of
the fidelity run, and the card's name and power limit.  With --profile,
after each line, the device time of one call by kernel
(`headline.profile_call`).

The configuration, as bench.py builds it (the host set-up,
`staged.config3_setup` and `staged.config3_config`, is shared with the
staged line config3_staged):
- the IR is bench_all's 2 s stereo reverb at 48 kHz (`staged.bench_ir3`:
  normal noise x exp(-n/16000) x 0.05 from np.random.default_rng(0) in
  bench_all's draw order), resampled to the 192 kHz processing rate
  (`ir.resample.resample_ir`, as the reference loader does:
  processingRate = sr x L, DSPCoreLifecycle.cpp:192);
- eq20 (the default bands at gains linspace(-4, 4, 20));
- the AutoGainPlanner's gains per order (`models.gain_planner.plan`) from
  the EQ's estimated peak at 192 kHz, its largest boosted Q and the 48 kHz
  IR's peak gain;
- the whole 4x chain folded into one base-rate IR
  (`prepare_folded_convolver_oversampled`: FilterSpec(192 kHz), block
  512, partition "auto") and run as `process_chain_fused`: one uniform
  partitioned convolution per channel through the three frame kernels of
  the dtype.

Limits: f32 2e-5 and f64 1e-12 relative RMS, PERF.md's limits for the
folded lines.
"""
from __future__ import annotations

import sys

import torch

from . import staged
from .device import card_description, resolve_device
from .models.chain import FoldedChain, prepare_folded_convolver_oversampled
from .models.gain_planner import CONVOLVER_THEN_EQ, EQ_THEN_CONVOLVER
from .models.nuc import FilterSpec
from .staged import Config3Setup, config3_config, config3_setup, planner_db

BLOCK_SIZE = 512
ORDERS = {"config3_eq_conv": (EQ_THEN_CONVOLVER, "EQ->Conv"),
          "config3_conv_eq": (CONVOLVER_THEN_EQ, "Conv->EQ")}
LIMITS = {torch.float32: 2e-5, torch.float64: 1e-12}


def config3_lines(device="cuda", dtype=torch.float32,
                  setup: Config3Setup | None = None) -> dict:
    """{name: staged.Line} of both orders in `dtype` (names with "_f64"
    for float64), folded and prepared on `device`."""
    dev = resolve_device(device)
    setup = setup or config3_setup()
    f64 = dtype == torch.float64
    lines = {}
    for name, (order, tag) in ORDERS.items():
        cfg, g = config3_config(order, setup.planner_input)
        state = prepare_folded_convolver_oversampled(
            setup.ir_hf, BLOCK_SIZE, FilterSpec(staged.CONFIG3_RATE), cfg,
            staged.eq20(), dtype=dtype, device=dev)
        lp = state.left.plan.layers[0]
        name += "_f64" if f64 else ""
        lines[name] = staged.Line(
            name, f"RTF config3 {tag}: AutoGainPlanner + 4x OS, 2s IR, "
            f"folded, {'f64' if f64 else 'f32'}", FoldedChain(cfg, state),
            dtype, limits=LIMITS,
            info={"planner_db": planner_db(g),
                  "plan": [lp.part_size, lp.num_parts],
                  "folded_taps": state.left.plan.ir_len})
    return lines


def main(argv=()):
    """Both orders in f32 and in f64 on the card."""
    card = card_description()
    setup = config3_setup()
    lines64 = config3_lines("cuda", torch.float64, setup)
    lines = [*config3_lines("cuda", torch.float32, setup).values(),
             *lines64.values()]
    staged.report_lines(lines, lines64, card, "--profile" in argv)


if __name__ == "__main__":
    main(sys.argv[1:])
