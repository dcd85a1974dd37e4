"""The readings that the correctness limits are set from, on the card.

    python3 -m benchmark.control --workload <name> --seeds S... \
        --control-seeds C... [--seconds 1]

prints one JSON line a reading: the program's numbers on each seed of
--seeds (a short run of the cell, its window and check as in a
benchmark run), and the control's on each of --control-seeds.  The
benchmark's own runs never run the control.

The control is what a later change might be tempted to ship, a step
below the precision the configuration states: offline the system's
`control_render` on the cell's own inputs (its module says what it
computes), judged by the system's own comparison; live the program's
own lower-precision path: the system's live chain with its
frequency-domain delay line in float16.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness, system, traffic


def control_render(workload: str, seed: int, device="cuda",
                   config_override=None, traffic_override=None) -> dict:
    """The offline control's numbers on `seed`'s inputs at the cell's
    size."""
    _, cfg, mix = harness.cell_data(workload)
    cfg.update(config_override or {})
    mix.update(traffic_override or {})
    sysmod = harness.system_for(cfg, mix["kind"])
    if not hasattr(sysmod, "control_render"):
        raise ValueError(f"system {cfg['system']!r} has no control_render")
    dev = torch.device(device)
    ir = system.ir_from_seed(cfg, seed)
    inputs = traffic.render_inputs(mix, cfg, seed, dev,
                                   cfg.get("dither") is not None)
    return sysmod.control_render(cfg, ir, inputs, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    kind = harness.cell_data(a.workload)[2]["kind"]
    for side, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for s in seeds:
            if side == "program":
                nums = {k: c["value"] for k, c in harness.run_cell(
                    a.workload, s, a.seconds, False)["checks"].items()}
            elif kind == "live":
                nums = {k: c["value"] for k, c in harness.run_cell(
                    a.workload, s, a.seconds, False,
                    fdl_dtype="float16")["checks"].items()}
            else:
                nums = control_render(a.workload, s)
            print(json.dumps({"workload": a.workload, "side": side,
                              "seed": s, **nums}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
