"""Build the port's prepared state from the JAX package's.

The caller turns the JAX objects into plain values first (the port never
sees a JAX object): each channel's `layer_spectra` as numpy arrays and
the plan as plain numbers; a learned coefficient bank store as its dict
of plain numbers (`AdaptiveCoefficientBanks.to_dict()`).  From the same
prepared state both packages compute the same output.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.convolver import StereoConvolverState
from .models.learner import AdaptiveCoefficientBanks
from .models.nuc import NUCLayerPlan, NUCPlan, NUCState


def stereo_state_from_arrays(left_spectra, right_spectra, layers,
                             latency: int, block_size: int, ir_len: int,
                             device="cuda") -> StereoConvolverState:
    """left_spectra / right_spectra: per layer a (num_parts, part_size+1)
    complex numpy array.  layers: per layer (offset, length, part_size,
    num_parts, gain), shared by both channels."""
    dev = resolve_device(device)
    plan = NUCPlan(
        layers=tuple(NUCLayerPlan(offset=int(o), length=int(n),
                                  part_size=int(p), num_parts=int(k),
                                  gain=float(g), damping=None)
                     for (o, n, p, k, g) in layers),
        direct_taps=0, latency=int(latency), block_size=int(block_size),
        ir_len=int(ir_len))

    def side(spectra):
        if len(spectra) != plan.num_layers:
            raise ValueError(f"{len(spectra)} spectra for "
                             f"{plan.num_layers} layers")
        out = []
        for lp, H in zip(plan.layers, spectra):
            H = np.asarray(H)
            if H.shape != (lp.num_parts, lp.part_size + 1):
                raise ValueError(f"spectra shape {H.shape} does not match "
                                 f"layer {lp}")
            out.append(torch.from_numpy(H.copy()).to(dev))
        return NUCState(plan=plan, layer_spectra=out)

    return StereoConvolverState(left=side(left_spectra),
                                right=side(right_spectra))


def banks_from_dict(banks: dict) -> AdaptiveCoefficientBanks:
    """banks: {bank index: nine reflection coefficients}, the JAX store's
    `to_dict()` (keys str or int, values lists or arrays)."""
    return AdaptiveCoefficientBanks.from_dict(banks)
