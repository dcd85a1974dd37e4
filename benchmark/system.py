"""The system under test, built from a configuration file: the port's
folded or semi-folded chain (offline render, with the dither when the
configuration has one) and its folded streaming chain (live serving).

This is the only module of the benchmark that imports the port
(`convopeq_tpu_torch`), and it takes from it only the chains, their
plans' shapes and the kernels' launch counters.  The IR is made here
from the seed and handed to the program and to the reference alike.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16}


def ir_from_seed(cfg: dict, seed: int) -> np.ndarray:
    """(2, taps) f64 stereo IR: normal noise x exp(-n / (taps / divisor))
    x scale, the two channels drawn in turn from the seed."""
    ir = cfg["ir"]
    n = int(ir["taps"])
    rng = np.random.default_rng([int(seed), 0])
    decay = np.exp(-np.arange(n) / (n / float(ir["decay_divisor"])))
    return np.stack([rng.normal(size=n), rng.normal(size=n)]) * decay \
        * float(ir["scale"])


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
    return {**fk.launch_counts, **fc.launch_counts, **qk.launch_counts}


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
        state = prep(ir, int(cfg["block_size"]), spec, chain_cfg, eqp,
                     dtype=DTYPES[cfg["dtype"]],
                     partition=int(r["partition"]), device=device)
        self.chain = cls(chain_cfg, state)
        self.layers = [(lp.part_size, lp.num_parts)
                       for lp in state.left.plan.layers]
        self.dither = cfg.get("dither")
        self.sample_rate = float(cfg["sample_rate"])

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
