"""The engine system: the application's own offline path,
`ConvoPeqEngine.process`, at 1x: the staged chain (`process_chain`: the
EQ through the fused kernel, the 3-layer NUC with its spectrum filter,
the output filter's biquad scans, the soft clip kernel, the DC
blockers) and the psychoacoustic dither's quantizer kernel, with the IR
loaded through the engine's loader and the gains from its auto-gain
plan.  It serves offline render only.

Numbers compared (each against the configuration's limit):
- rel_rms: the largest relative RMS error of a stream's channel of the
  chain's output y (the signal the timed call hands to the dither),
  every row of each batch's last output, against the plain f64
  reference (benchmark/reference/staged.py) in blocks of rows.  The
  quantizer is chaotic at the last bit, so a dithered f32 output cannot
  match an f64 reference sample by sample.
- q_mismatch: the quantizer followed from the program's own y: samples
  where the program's q differs from the plain psycho quantizer's
  (benchmark/reference/psycho.py) on the same y and uniforms, in the
  configuration's type (exact: 0), over the rows `folded.quant_rows`
  draws from the seed, on their first QUANT_SAMPLES samples.
The kernels' launch counters are `folded.launch_counts`'s.

The reference (benchmark/reference/staged.py) is built from the raw IR
and the configuration alone: its own copies of the loader's trim and
scale and of the auto-gain plan.  The control (`control_render`) is
the reference in the program's place in bfloat16: the input, the
prepared IR and each stage's output rounded to bfloat16, the arithmetic
between in float32; its y then quantized by the plain quantizer in
float32.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import coeffs as C
from benchmark.reference.psycho import psycho_quantize
from benchmark.reference.staged import StagedReference
from benchmark.systems.folded import (QUANT_SAMPLES, bf16, launch_counts,
                                      quant_rows)

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _engine(cfg: dict, ir: np.ndarray, device):
    """A ConvoPeqEngine set up as the configuration states, its IR
    loaded."""
    from convopeq_tpu_torch.engine.engine import ConvoPeqEngine
    from convopeq_tpu_torch.models.dither import PSYCHOACOUSTIC
    from convopeq_tpu_torch.models.gain_planner import EQ_THEN_CONVOLVER
    chain, d = cfg["chain"], cfg["dither"]
    if chain["order"] != "eq_conv" or d["shaper"] != "psycho":
        raise ValueError("the engine system runs the EQ -> conv order "
                         "with the psycho shaper")
    sr = float(cfg["sample_rate"])
    eng = ConvoPeqEngine(sr, int(cfg["block_size"]), DTYPES[cfg["dtype"]],
                         device=device)
    eng.eq_params.gains_db[:] = np.asarray(cfg["eq_gains_db"], np.float64)
    eng.set_processing_order(EQ_THEN_CONVOLVER)
    eng.set_soft_clip(chain["soft_clip_enabled"], chain["saturation_amount"])
    eng.set_auto_gain(chain["auto_gain"])
    eng.set_dither(PSYCHOACOUSTIC, int(d["bit_depth"]))
    eng.load_impulse_response(ir, target_seconds=ir.shape[-1] / sr)
    return eng


class Render:
    """`call(x, u)` renders a batch (B, 2, N) through the engine with the
    dither's uniforms u (B, 2, N, 2) and returns (y, q)."""

    def __init__(self, cfg: dict, ir: np.ndarray, device):
        self.engine = _engine(cfg, ir, device)

    def shapes(self, inputs) -> dict:
        """The call's shapes: R rows of N samples, C streams a channel,
        the NUC's layers [(p, P, offset)] and the EQ's blocked
        convolution (p, P), each as the program plans it."""
        from convopeq_tpu_torch.models.eq import eq_fft_blocking
        B, _, n = inputs[0][0].shape
        eng = self.engine
        return {"C": B, "channels": 2, "R": 2 * B, "N": n,
                "layers": eng.nuc_layer_shapes(),
                "eq": eq_fft_blocking(eng.eq_params, eng.sample_rate)}

    def call(self, x, u=None):
        return self.engine.process(x, uniforms=u, return_chain_output=True)


render = Render


def _rel(err, ref):
    return err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-300)


def _numbers(cfg, inputs, outputs, seed, reference, rows):
    worst = 0.0
    for (x, _), (y, _) in zip(inputs, outputs):
        for r0 in range(0, x.shape[0], rows):
            ref = reference(x[r0:r0 + rows].double())
            worst = max(worst, float(_rel(y[r0:r0 + rows].double() - ref,
                                          ref).max()))
    picked, y, u = _quant_rows(inputs, outputs, seed)
    q = np.stack([outputs[k][1][r, c, :QUANT_SAMPLES].cpu().numpy()
                  for k, r, c in picked])
    return {"rel_rms": worst, "q_mismatch": float(np.count_nonzero(
        q != _quantize(cfg, y, u)))}


def _quant_rows(inputs, outputs, seed):
    """The rows whose quantizer is followed, with their y and u over
    the first QUANT_SAMPLES samples."""
    picked = quant_rows(seed, len(inputs), inputs[0][0].shape[0])
    sl = slice(0, QUANT_SAMPLES)
    return (picked,
            np.stack([outputs[k][0][r, c, sl].cpu().numpy()
                      for k, r, c in picked]),
            np.stack([inputs[k][1][r, c, sl].cpu().numpy()
                      for k, r, c in picked]))


def _quantize(cfg, y, u):
    d = cfg["dither"]
    return psycho_quantize(y, u, d["coeffs"], int(d["bit_depth"]),
                           C.K_OUTPUT_HEADROOM)


def check_render(cfg: dict, ir, inputs, outputs, seed: int, rows: int = 8):
    """The offline cell's numbers."""
    reference = StagedReference(cfg, ir, inputs[0][0].device)
    return _numbers(cfg, inputs, outputs, seed, reference, rows)


def control_render(cfg: dict, ir, inputs, seed: int, rows: int = 8) -> dict:
    """The offline control's numbers on the cell's own inputs; its q is
    the plain quantizer's on the followed rows (zero elsewhere)."""
    dev = inputs[0][0].device
    control = StagedReference(cfg, ir, dev, torch.float32, ir_round=bf16)
    outs = [(torch.cat([control(bf16(x[r0:r0 + rows]), rnd=bf16)
                        for r0 in range(0, x.shape[0], rows)]),
             torch.zeros_like(x)) for x, _ in inputs]
    picked, y, u = _quant_rows(inputs, outs, seed)
    for (k, r, c), q in zip(picked, _quantize(cfg, y, u)):
        outs[k][1][r, c, :QUANT_SAMPLES] = torch.as_tensor(q, device=dev)
    return _numbers(cfg, inputs, outs, seed, StagedReference(cfg, ir, dev),
                    rows)
