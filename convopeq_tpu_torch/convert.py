"""Build the port's prepared state from the JAX package's.

The caller turns the JAX objects into plain values first (the port never
sees a JAX object): each channel's `layer_spectra` and direct-head taps
as numpy arrays and the plan (with each layer's damping) as plain
numbers; a folded prefilter's spectra as a numpy array; a learned
coefficient bank store as its dict of plain numbers
(`AdaptiveCoefficientBanks.to_dict()`); EQ parameters and halfband
stages as their numpy fields; a streaming state as its fields' numpy
arrays (`stream_state_from_arrays`).  From the same prepared state both
packages compute the same output.

Spectra come as complex arrays or, as the JAX package holds f64 spectra
on an accelerator (its dd mode, convopeq_tpu/ops/partitioned_conv.py:
40-50), as a split (Hr, Hi) pair of f64 arrays; both become complex
tensors, the pair complex128.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.convolver import StereoConvolverState
from .models.eq import NUM_BANDS, EQParams
from .models.learner import AdaptiveCoefficientBanks
from .models.nuc import NUCLayerPlan, NUCPlan, NUCState
from .ops.oversample import HalfbandStage


def _spectra(H) -> np.ndarray:
    """A complex spectra array, or a split (Hr, Hi) pair of real arrays as
    complex128 (the parts copied exactly)."""
    if not isinstance(H, tuple):
        return np.asarray(H)
    Hr, Hi = (np.asarray(a, np.float64) for a in H)
    if Hr.shape != Hi.shape:
        raise ValueError(f"split spectra of shapes {Hr.shape} and "
                         f"{Hi.shape}")
    out = np.empty(Hr.shape, np.complex128)
    out.real, out.imag = Hr, Hi
    return out


def stereo_state_from_arrays(left_spectra, right_spectra, layers,
                             latency: int, block_size: int, ir_len: int,
                             direct=None, device="cuda"
                             ) -> StereoConvolverState:
    """left_spectra / right_spectra: per layer a (num_parts, part_size+1)
    complex numpy array or a split (Hr, Hi) pair of f64 arrays.  layers:
    per layer (offset, length, part_size, num_parts, gain) or (..., gain,
    damping), shared by both channels.
    direct: None, or the (left, right) direct-head taps as 1-D arrays."""
    dev = resolve_device(device)
    plan = NUCPlan(
        layers=tuple(NUCLayerPlan(offset=int(t[0]), length=int(t[1]),
                                  part_size=int(t[2]), num_parts=int(t[3]),
                                  gain=float(t[4]),
                                  damping=(None if len(t) < 6 or t[5] is None
                                           else float(t[5])))
                     for t in layers),
        direct_taps=0 if direct is None else len(direct[0]),
        latency=int(latency), block_size=int(block_size),
        ir_len=int(ir_len))

    def side(spectra, taps):
        if len(spectra) != plan.num_layers:
            raise ValueError(f"{len(spectra)} spectra for "
                             f"{plan.num_layers} layers")
        out = []
        for lp, H in zip(plan.layers, spectra):
            H = _spectra(H)
            if H.shape != (lp.num_parts, lp.part_size + 1):
                raise ValueError(f"spectra shape {H.shape} does not match "
                                 f"layer {lp}")
            out.append(torch.from_numpy(H.copy()).to(dev))
        if taps is not None:
            taps = np.asarray(taps)
            if taps.shape != (plan.direct_taps,):
                raise ValueError(f"direct head of shape {taps.shape}, "
                                 f"expected ({plan.direct_taps},)")
            taps = torch.from_numpy(taps.copy()).to(dev)
        return NUCState(plan=plan, layer_spectra=out, direct_ir=taps)

    left_taps, right_taps = (None, None) if direct is None else direct
    return StereoConvolverState(left=side(left_spectra, left_taps),
                                right=side(right_spectra, right_taps))


def prefilter_from_arrays(spectra, part_size: int, device="cuda"):
    """The JAX package's `prepare_fused_prefilter` result, (Hg, part_size)
    with Hg as a (P, part_size+1) complex numpy array or a split (Hr, Hi)
    pair of f64 arrays, as the port's (tensor on `device`, part_size)."""
    Hg = _spectra(spectra)
    if Hg.ndim != 2 or Hg.shape[1] != part_size + 1:
        raise ValueError(f"prefilter spectra of shape {Hg.shape} for "
                         f"partition {part_size}")
    return torch.from_numpy(Hg.copy()).to(resolve_device(device)), \
        int(part_size)


def banks_from_dict(banks: dict) -> AdaptiveCoefficientBanks:
    """banks: {bank index: nine reflection coefficients}, the JAX store's
    `to_dict()` (keys str or int, values lists or arrays)."""
    return AdaptiveCoefficientBanks.from_dict(banks)


def eq_params_from_arrays(band_types, freqs, gains_db, qs, modes, enabled,
                          structure: int, saturation: float,
                          agc_enabled: bool) -> EQParams:
    """The port's EQParams from the JAX EQParams' fields: per band the
    type, frequency, gain (dB), Q, channel mode and enable (arrays of
    NUM_BANDS), and the structure, saturation and AGC switch."""
    fields = dict(band_types=np.asarray(band_types, np.int32),
                  freqs=np.asarray(freqs, np.float64),
                  gains_db=np.asarray(gains_db, np.float64),
                  qs=np.asarray(qs, np.float64),
                  modes=np.asarray(modes, np.int32),
                  enabled=np.asarray(enabled, bool))
    for name, a in fields.items():
        if a.shape != (NUM_BANDS,):
            raise ValueError(f"{name} of shape {a.shape}, expected "
                             f"({NUM_BANDS},)")
    return EQParams(**{k: a.copy() for k, a in fields.items()},
                    structure=int(structure), saturation=float(saturation),
                    agc_enabled=bool(agc_enabled))


def halfband_stage_from_arrays(taps: int, center_tap: int,
                               center_parity: int, conv_parity: int, conv,
                               center_delay: int,
                               center_gain: float) -> HalfbandStage:
    """The port's HalfbandStage from the JAX stage's fields: the tap count,
    center tap M, the two phase parities, the non-zero arm's coefficients
    (a 1-D array), the center delay in input samples and the center
    phase's gain."""
    conv = np.array(conv, np.float64)
    if conv.ndim != 1 or len(conv) != (taps - conv_parity + 1) // 2:
        raise ValueError(f"conv arm of shape {conv.shape} for {taps} taps")
    return HalfbandStage(taps=int(taps), center_tap=int(center_tap),
                         center_parity=int(center_parity),
                         conv_parity=int(conv_parity), conv=conv,
                         center_delay=int(center_delay),
                         center_gain=float(center_gain))


def stream_state_from_arrays(chain, arrays: dict):
    """The port's StreamState (runtime/streaming.py) for `chain` from a
    streaming state of the JAX package, so that a stream the JAX package
    advanced continues in the port.

    arrays: the JAX StreamState's fields by name as numpy arrays: dc_in,
    dc_out, eq_states, of_states, sc_up_hist, sc_down_hist, dc_os and agc
    (each None where the JAX state holds None), os_up_hists and
    os_down_hists (tuples), direct_hist (a (left, right) pair or None),
    step (an int), and conv_layers as a (left, right) pair of layer
    tuples, each layer a dict of prev, fdl, acc, ring, par and step with
    the split planes joined into complex (fdl = fdl_r + 1j fdl_i, par =
    par_r + 1j par_i).  The port keeps the two channels on axis -2 of one
    tensor; the immediate layer's accumulator and output ring, which its
    step never reads, are not kept."""
    batch = tuple(np.shape(arrays["dc_in"])[:-2])
    state = chain.init_state(batch)

    def put(dst, src, name):
        src = np.asarray(src)
        if dst.dtype == torch.float16 and dst.shape[-1:] == (2,) \
                and np.iscomplexobj(src):
            src = np.stack([src.real, src.imag], axis=-1)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape}, the chain's state "
                             f"holds {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src)))

    for name in ("dc_in", "dc_out", "eq_states", "of_states", "sc_up_hist",
                 "sc_down_hist", "dc_os", "agc"):
        dst, src = getattr(state, name), arrays.get(name)
        if (dst is None) != (src is None):
            raise ValueError(f"{name}: the chain's state and the arrays "
                             "disagree on whether it is carried")
        if dst is not None:
            put(dst, src, name)
    for name in ("os_up_hists", "os_down_hists"):
        dsts, srcs = getattr(state, name), arrays[name]
        if len(dsts) != len(srcs):
            raise ValueError(f"{name}: {len(srcs)} stages, the chain has "
                             f"{len(dsts)}")
        for i, (dst, src) in enumerate(zip(dsts, srcs)):
            put(dst, src, f"{name}[{i}]")
    if (state.direct_hist is None) != (arrays.get("direct_hist") is None):
        raise ValueError("direct_hist: the chain's state and the arrays "
                         "disagree on whether it is carried")
    if state.direct_hist is not None:
        put(state.direct_hist, np.stack(arrays["direct_hist"], axis=-2),
            "direct_hist")
    left, right = arrays["conv_layers"]
    if not len(left) == len(right) == len(state.conv_layers):
        raise ValueError(f"conv_layers: {len(left)} / {len(right)} layers, "
                         f"the chain has {len(state.conv_layers)}")
    for i, (ls, lj, rj) in enumerate(zip(state.conv_layers, left, right)):
        for name in ("prev", "fdl", "acc", "ring", "par"):
            dst = getattr(ls, name)
            if dst.shape[-1] == 0 and name in ("acc", "ring", "par"):
                continue
            put(dst, np.stack([lj[name], rj[name]], axis=-3
                              if name == "fdl" else -2),
                f"conv_layers[{i}].{name}")
        if int(lj["step"]) != int(rj["step"]):
            raise ValueError(f"conv_layers[{i}]: the channels' steps differ")
        ls.step = int(lj["step"])
    state.step = int(arrays["step"])
    return state
