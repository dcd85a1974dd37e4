"""Whether what the timed path produced is correct: the program's own
outputs from the window against the plain reference (reference/),
which recomputes the fold from the configuration's IR and EQ and runs
the chain in f64 on the same inputs, in blocks of rows.

Numbers compared (each against the configuration's limit for the
traffic's kind):
- rel_rms: the largest relative RMS error of a stream's channel (every
  row of the last output of each batch offline; the sampled streams'
  whole window live).  In a dithered cell it is read on the chain's
  output y, which the timed call produces and hands to the quantizer:
  the quantizer is chaotic at the last bit, so a dithered f32 output
  cannot match an f64 reference sample by sample.
- q_mismatch (dithered): the quantizer stage followed from the
  program's own y: samples where the program's q differs from the
  reference quantizer's on the same y and uniforms, computed in the
  configuration's type (exact: 0), over a sample of rows drawn from the
  seed, on their first QUANT_SAMPLES samples (the reference is a loop
  over time in NumPy).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import chain as R
from .reference import coeffs as C
from .reference.quantizer import lattice_quantize

QUANT_ROWS = 32
QUANT_SAMPLES = 8192


def quant_rows(seed: int, batches: int, B: int):
    """(batch, row, channel) of the rows whose quantizer is followed,
    drawn from the seed."""
    rng = np.random.default_rng([int(seed), 2])
    pick = rng.choice(batches * B * 2, size=min(QUANT_ROWS, batches * B * 2),
                      replace=False)
    return [(int(i) // (2 * B), int(i) // 2 % B, int(i) % 2) for i in pick]


def folded_response(cfg: dict, ir: np.ndarray, dev, semi: bool):
    sr = float(cfg["sample_rate"])
    h = R.folded_ir(ir, int(cfg["block_size"]), sr,
                    C.eq_params(cfg["eq_gains_db"]),
                    {"sample_rate": sr, **cfg.get("filter_spec", {})},
                    cfg["chain"], 1 if semi else 2)
    return torch.as_tensor(h, device=dev)


def _rel(err, ref):
    return err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-300)


def check_render(cfg: dict, ir, inputs, outputs, seed: int, rows: int = 8):
    """The offline cell's numbers."""
    dev = inputs[0][0].device
    semi = cfg["render"]["fold"] == "semi_folded"
    h = folded_response(cfg, ir, dev, semi)
    sr = float(cfg["sample_rate"])
    d = cfg.get("dither")
    worst = 0.0
    for (x, _), out in zip(inputs, outputs):
        y = out[0] if d is not None else out
        for r0 in range(0, x.shape[0], rows):
            ref = R.run_chain(x[r0:r0 + rows].double(), h, cfg["chain"], sr,
                              rows)
            worst = max(worst, float(_rel(y[r0:r0 + rows].double() - ref,
                                          ref).max()))
    numbers = {"rel_rms": worst}
    if d is not None:
        sl = slice(0, QUANT_SAMPLES)
        rows_of = quant_rows(seed, len(inputs), inputs[0][0].shape[0])
        y = np.stack([outputs[k][0][r, c, sl].cpu().numpy()
                      for k, r, c in rows_of])
        u = np.stack([inputs[k][1][r, c, sl].cpu().numpy()
                      for k, r, c in rows_of])
        q = np.stack([outputs[k][1][r, c, sl].cpu().numpy()
                      for k, r, c in rows_of])
        q_ref = lattice_quantize(y, u, d["reflection_coeffs"],
                                 int(d["bit_depth"]), C.K_OUTPUT_HEADROOM)
        numbers["q_mismatch"] = float(np.count_nonzero(q != q_ref))
    return numbers


def check_live(cfg: dict, ir, feed, keep, kept, n_window: int, dev):
    """The live cell's number: each kept stream's whole window against
    the reference chain over the same input from the first block."""
    h = folded_response(cfg, ir, dev, False)
    sr = float(cfg["sample_rate"])
    worst = 0.0
    for i, s in enumerate(keep):
        x = torch.as_tensor(feed.stream_input(int(s), n_window),
                            device=dev).double()
        ref = R.run_chain(x[None], h, cfg["chain"], sr)[0]
        y = torch.as_tensor(kept[i], device=dev).double()
        worst = max(worst, float(_rel(y - ref, ref).max()))
    return {"rel_rms": worst}
