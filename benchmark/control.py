"""The readings that the correctness limits are set from, on the card.

    python3 -m benchmark.control --workload <name> --seeds S... \
        --control-seeds C... [--seconds 1]

prints one JSON line a reading: the program's numbers on each seed of
--seeds (a short run of the cell, its window and check as in a
benchmark run), and the control's on each of --control-seeds.  The
benchmark's own runs never run the control.

The control is what a later change might be tempted to ship: the
configuration states float32, so offline it is the reference put in the
program's place in bfloat16 (each stage's output, the input and the IR
rounded to bfloat16, the arithmetic between in float32), judged by the
same comparison; a dithered cell's control then quantizes with the
reference quantizer in float32 (there is no bfloat16 24-bit grid).  Live
it is the program's own lower-precision path: the streaming chain with
its frequency-domain delay line in float16.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import check, harness, system, traffic
from .reference import chain as R
from .reference import coeffs as C
from .reference.quantizer import lattice_quantize


def bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def control_render(workload: str, seed: int, device="cuda",
                   config_override=None, traffic_override=None) -> dict:
    """The offline control's numbers on `seed`'s inputs at the cell's
    size."""
    _, cfg, mix = harness.cell_data(workload)
    cfg.update(config_override or {})
    mix.update(traffic_override or {})
    dev = torch.device(device)
    ir = system.ir_from_seed(cfg, seed)
    d = cfg.get("dither")
    inputs = traffic.render_inputs(mix, cfg, seed, dev, d is not None)
    semi = cfg["render"]["fold"] == "semi_folded"
    h = bf16(check.folded_response(cfg, ir, dev, semi))
    sr = float(cfg["sample_rate"])
    outs = []
    for x, u in inputs:
        y = R.run_chain(bf16(x), h, cfg["chain"], sr, rnd=bf16)
        if d is None:
            outs.append(y)
            continue
        q = torch.zeros_like(y)
        outs.append((y, q))
    if d is not None:
        n = check.QUANT_SAMPLES
        rows = check.quant_rows(seed, len(inputs), inputs[0][0].shape[0])
        ys = np.stack([outs[k][0][r, c, :n].cpu().numpy()
                       for k, r, c in rows])
        us = np.stack([inputs[k][1][r, c, :n].cpu().numpy()
                       for k, r, c in rows])
        qs = lattice_quantize(ys, us, d["reflection_coeffs"],
                              int(d["bit_depth"]), C.K_OUTPUT_HEADROOM)
        for i, (k, r, c) in enumerate(rows):
            outs[k][1][r, c, :n] = torch.as_tensor(qs[i], device=dev)
    return check.check_render(cfg, ir, inputs, outs, seed)


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
