"""The folded system: the port's folded or semi-folded chain offline
(`render.fold`; the dither after it when the configuration has one) and
its folded streaming chain live, with the check of their outputs
against the plain reference (benchmark/reference/), which recomputes
the fold from the configuration's IR and EQ and runs the chain in f64
on the same inputs, in blocks of rows.

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

The control (`control_render`) is the reference put in the program's
place in bfloat16: each stage's output, the input and the IR rounded to
bfloat16, the arithmetic between in float32; a dithered cell's control
then quantizes with the reference quantizer in float32 (there is no
bfloat16 24-bit grid).  Live, the control is the program's own
lower-precision path: the streaming chain with its frequency-domain
delay line in `fdl_dtype`.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import chain as R
from benchmark.reference import coeffs as C
from benchmark.reference.quantizer import lattice_quantize

QUANT_ROWS = 32
QUANT_SAMPLES = 8192
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16}


def _program_parts(cfg: dict):
    from convopeq_tpu_torch.models.chain import ChainConfig
    from convopeq_tpu_torch.models.eq import EQParams
    from convopeq_tpu_torch.models.nuc import FilterSpec
    sr = float(cfg["sample_rate"])
    eqp = EQParams()
    eqp.gains_db[:] = np.asarray(cfg["eq_gains_db"], np.float64)
    chain_cfg = ChainConfig(sample_rate=sr, **cfg["chain"])
    spec = FilterSpec(sample_rate=sr, **cfg.get("filter_spec", {}))
    return chain_cfg, eqp, spec


def launch_counts() -> dict:
    """The port's kernel launch counters, by kernel."""
    from convopeq_tpu_torch.ops import frame_conv_kernels as fk
    from convopeq_tpu_torch.ops import fused_conv_kernels as fc
    from convopeq_tpu_torch.ops import quantize_kernels as qk
    from convopeq_tpu_torch.ops import softclip as sc
    return {**fk.launch_counts, **fc.launch_counts, **qk.launch_counts,
            **sc.launch_counts}


class Render:
    """The offline chain of a configuration: `call(x, u)` renders a batch
    (B, 2, N); when the configuration dithers, it then quantizes the
    chain's output y with the uniforms u (B, 2, N, 2) and returns (y, q)."""

    def __init__(self, cfg: dict, ir: np.ndarray, device):
        from convopeq_tpu_torch.models.chain import (
            FoldedChain, SemiFoldedChain, prepare_folded_convolver,
            prepare_semi_folded_convolver)
        chain_cfg, eqp, spec = _program_parts(cfg)
        r = cfg["render"]
        prep, cls = {"folded": (prepare_folded_convolver, FoldedChain),
                     "semi_folded": (prepare_semi_folded_convolver,
                                     SemiFoldedChain)}[r["fold"]]
        self.dither = cfg.get("dither")
        if self.dither is not None and self.dither["shaper"] != "adaptive9":
            raise ValueError(f"the folded system dithers only with the "
                             f"adaptive9 shaper, not "
                             f"{self.dither['shaper']!r}")
        state = prep(ir, int(cfg["block_size"]), spec, chain_cfg, eqp,
                     dtype=DTYPES[cfg["dtype"]],
                     partition=int(r["partition"]), device=device)
        self.chain = cls(chain_cfg, state)
        self.layers = [(lp.part_size, lp.num_parts)
                       for lp in state.left.plan.layers]
        self.sample_rate = float(cfg["sample_rate"])

    def shapes(self, inputs) -> dict:
        """The offline call's shapes: the uniform layer's C x K frames of
        p samples and its P partitions; R rows of N samples."""
        B, _, n = inputs[0][0].shape
        p, P = self.layers[0]
        return {"C": B, "K": -(-n // p), "p": p, "P": P, "channels": 2,
                "R": 2 * B, "N": n}

    def call(self, x, u=None):
        y = self.chain(x)
        if self.dither is None:
            return y
        from convopeq_tpu_torch.models.dither import ADAPTIVE9, apply_dither
        d = self.dither
        return y, apply_dither(y, ADAPTIVE9, self.sample_rate,
                               int(d["bit_depth"]), uniforms=u,
                               adaptive_coeffs=np.asarray(
                                   d["reflection_coeffs"], np.float64),
                               lattice_ladder=d["ladder"])


class Live:
    """The folded streaming chain of a configuration: `step(state,
    block)` advances every stream by one block in place."""

    def __init__(self, cfg: dict, ir: np.ndarray, device,
                 fdl_dtype: str | None = None):
        from convopeq_tpu_torch.runtime.streaming import StreamingChain
        chain_cfg, eqp, spec = _program_parts(cfg)
        self.chain = StreamingChain.folded_from_ir(
            chain_cfg, eqp, ir, spec, block_size=int(cfg["block_size"]),
            dtype=DTYPES[cfg["dtype"]],
            fdl_dtype=None if fdl_dtype is None else DTYPES[fdl_dtype],
            device=device)
        self.block_size = self.chain.block_size
        # (part size, partitions, blocks between fires) of each layer
        self.layers = [(lp.part_size, lp.num_parts,
                        lp.part_size // self.block_size)
                       for lp in self.chain.layers]

    def init_state(self, streams: int):
        return self.chain.init_state((streams,))

    def step(self, state, block):
        return self.chain.step(state, block)


render = Render
live = Live


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


def bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def control_render(cfg: dict, ir, inputs, seed: int) -> dict:
    """The offline control's numbers on the cell's own inputs."""
    dev = inputs[0][0].device
    d = cfg.get("dither")
    semi = cfg["render"]["fold"] == "semi_folded"
    h = bf16(folded_response(cfg, ir, dev, semi))
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
        n = QUANT_SAMPLES
        rows = quant_rows(seed, len(inputs), inputs[0][0].shape[0])
        ys = np.stack([outs[k][0][r, c, :n].cpu().numpy()
                       for k, r, c in rows])
        us = np.stack([inputs[k][1][r, c, :n].cpu().numpy()
                       for k, r, c in rows])
        qs = lattice_quantize(ys, us, d["reflection_coeffs"],
                              int(d["bit_depth"]), C.K_OUTPUT_HEADROOM)
        for i, (k, r, c) in enumerate(rows):
            outs[k][1][r, c, :n] = torch.as_tensor(qs[i], device=dev)
    return check_render(cfg, ir, inputs, outs, seed)
