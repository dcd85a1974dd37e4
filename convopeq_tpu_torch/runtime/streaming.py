"""The streaming (serving) runtime: block-at-a-time processing with state
(counterpart of convopeq_tpu/runtime/streaming.py).

The real-time analog of the reference's audio callback: one call of
`StreamingChain.step(state, block)` advances a batch of independent
stereo streams by one block, carrying all DSP state (the DC blockers,
the EQ bands' states, the AGC, each NUC layer's overlap-save frame,
frequency-domain delay line (FDL), input accumulator, output ring and
amortized partial MAC, the direct head's history, the halfband
cascades' and the soft clip's FIR histories, the output filter).

How the port differs from the JAX package, and why:
- The state is mutated in place.  The FDL ring takes one slot write a
  fired frame, the accumulator one block write a block, the output ring
  one frame write a fired frame (the JAX package's `donate_state=True`,
  which every serving caller there passes).  `step` returns the state it
  was given; a caller that wants to keep an old state clones it
  (`StreamState.clone`).
- Spectra are complex tensors (complex64 / complex128), not split
  real / imaginary planes (those worked around the TPU).  The f16 FDL
  tier (`fdl_dtype=torch.float16`) stores frame spectra as a real f16
  tensor (..., bins, 2), since torch.complex32 lacks most CUDA ops, and
  widens them to the chain's dtype in the MAC, which accumulates there.
- The step counter is a host int.  Each tail layer's schedule is
  periodic and known on the host, so the JAX package's `lax.cond` on
  the frame clock is a Python branch: nothing runs the fire path on a
  block that does not fire, and every ring position is a host int.
- The two channels run as one batch (channel axis -2, as the signal
  (..., 2, N)), so both channels' NUC states must share one plan (any
  `stereo_prepare` or `prepare_folded_convolver` state does).
- The per-block transforms run the port's frame kernels: an f32 chain
  `ops/frame_conv_kernels.osa_rfft` of the materialized [prev | cur]
  frame, an f64 chain `frames_rfft` of the stacked (prev, cur) pair
  (its second frame), and `irfft_valid` for the valid half.  A CPU
  tensor takes their plain versions, a CUDA tensor the kernels.  The
  split-plane GEMM DFTs of the JAX package's f64 accelerator route are
  not ported: the f64 tier is native complex128.
- The ring MAC sums over a ring whose slots rotate, not the function
  `causal_mac` computes: it stays torch ops (a product and a sum over
  the partitions), as the JAX package computes it in jnp.  Each layer's
  spectra are kept doubled and reversed (`_ring_spectra`), so that the
  spectra a ring range needs are one contiguous slice: no gather.
- `multi_step` is a loop over the same step: the same numbers, no single
  dispatch.
- In an f32 chain the output filter's 15-20 Hz high-passes run their
  scan in f64 and round its output to f32.  The JAX step runs them in
  f32 on the 2x2 companion form (the diagonalized form the offline chain
  takes starts from zero state), which loses ~1% of their output over a
  512-sample block in f32; the JAX package's f32 step of the serving
  fixture's staged chain sits 1.6e-3 from f64 on the CPU, the port's
  ~3e-7 this way (2.3e-3 in f32 on the matmul form).

Constraints (as in the JAX package): the block size equals the NUC's L0
partition (its plan's latency); a tail layer needs offset >= part_size
(the reference drops contributions in the violating corner); tail
layers fire every part_size / block steps.  Consecutive steps equal the
offline chain (`models/chain.process_chain`, `process_chain_fused`).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.chain import (ChainConfig, _sanitize, fused_eligible,
                            prepare_folded_convolver,
                            resolve_oversampling_factor)
from ..models.convolver import CONVOLUTION_HEADROOM_GAIN
from ..models.eq import (LEFT, MID, NUM_BANDS, RIGHT, SERIAL, STEREO,
                         EQParams, agc_apply, band_active_mask)
from ..models.gain_planner import CONVOLVER_THEN_EQ
from ..models.nuc import NUCState
from ..models.output_filter import IDENTITY, output_filter_coeffs
from ..ops.dc_blocker import dc_blocker_alphas
from ..ops.frame_conv_kernels import COMPLEX_OF, frames_rfft, irfft_valid, \
    osa_rfft
from ..ops.oversample import design_halfband, downsample2, make_stages, \
    upsample2
from ..ops.scan_iir import (POLE_RADIUS_DIAG_F32, _biquad_pole_radius,
                            affine_scan_2x2, biquad_df2t_scan)
from ..ops.softclip import soft_clip, soft_clip_params
from ..ops.svf import svf_coeffs, svf_process
from ..utils.dsputil import K_OUTPUT_HEADROOM, equal_power_sin
from .telemetry import NO_SPAN, setup_span, span, tracing


# ---------------------------------------------------------------- ring ops

def _ring_write(ring, data, pos: int):
    """Circular write of `data` into `ring` at host position `pos`, in
    place."""
    n, L = ring.shape[-1], data.shape[-1]
    head = min(L, n - pos)
    ring[..., pos:pos + head].copy_(data[..., :head])
    if head < L:
        ring[..., :L - head].copy_(data[..., head:])


def _ring_read(ring, pos: int, L: int):
    """Aligned ring read: the step reads at pos = step * L mod n with n a
    power-of-two multiple of L, so the read never wraps (a view)."""
    return ring[..., pos:pos + L]


# ------------------------------------------------------------- NUC layers

@dataclass
class StreamLayerState:
    """One NUC layer's state for a batch of streams, both channels on
    axis -2 of each tensor."""
    prev: torch.Tensor   # (..., 2, p) previous overlap-save frame
    fdl: torch.Tensor    # (..., 2, P, p+1) complex ring: slot k mod P
    #                      holds frame k's spectrum; f16 tier (..., 2, P,
    #                      p+1, 2) real
    acc: torch.Tensor    # (..., 2, p) input accumulator (tail layers;
    #                      (..., 2, 0) on the immediate layer)
    ring: torch.Tensor   # (..., 2, ring_len) aligned output ring (tail
    #                      layers; (..., 2, 0) on the immediate layer)
    par: torch.Tensor    # (..., 2, p+1) amortized partial MAC of the
    #                      frame being accumulated ((..., 2, 0) on the
    #                      immediate layer, which fires every block)
    step: int            # blocks this layer has taken


def _is_immediate(lp, block_size: int) -> bool:
    """L0 of the JAX package's step: one frame a block, no delay."""
    return lp.part_size == block_size and lp.offset == 0


def _ring_len(lp) -> int:
    return int(2 ** int(np.ceil(np.log2(lp.offset + 2 * lp.part_size))))


def _check_layer(lp, block_size: int):
    if lp.offset > 0 and lp.offset < lp.part_size:
        raise ValueError(
            f"streaming tail layer needs offset ({lp.offset}) >= "
            f"part_size ({lp.part_size}); the reference drops these "
            "contributions: use the offline path for this config")
    if lp.part_size % block_size or (lp.offset == 0 and not
                                     _is_immediate(lp, block_size)):
        raise ValueError(f"layer {lp} does not stream at block "
                         f"{block_size}: a layer at offset 0 must have "
                         "the block's partition, every layer a multiple")


def _layer_init(batch, lp, block_size: int, rdt, sdt, device):
    """Zero state of one layer for `batch` = batch shape + (2,).  sdt is
    the FDL's storage dtype: the chain's (complex storage) or f16."""
    p, P = lp.part_size, lp.num_parts
    tail = not _is_immediate(lp, block_size)
    if sdt == torch.float16:
        fdl = torch.zeros(batch + (P, p + 1, 2), dtype=sdt, device=device)
    else:
        fdl = torch.zeros(batch + (P, p + 1), dtype=COMPLEX_OF[rdt],
                          device=device)
    return StreamLayerState(
        prev=torch.zeros(batch + (p,), dtype=rdt, device=device),
        fdl=fdl,
        acc=torch.zeros(batch + (p if tail else 0,), dtype=rdt,
                        device=device),
        ring=torch.zeros(batch + (_ring_len(lp) if tail else 0,), dtype=rdt,
                         device=device),
        par=torch.zeros(batch + (p + 1 if tail else 0,),
                        dtype=COMPLEX_OF[rdt], device=device),
        step=0)


def _ring_spectra(H):
    """(..., P, bins) partition spectra -> (..., 2P, bins): R twice over,
    R[m] = H[(-m) mod P].  Slot s of a ring whose newest frame sits in
    slot w needs H[(w - s) mod P] = RR[s - w + P], so a range of slots
    takes one contiguous slice."""
    R = torch.cat([H[..., :1, :], H[..., 1:, :].flip(-2)], dim=-2)
    return torch.cat([R, R], dim=-2).contiguous()


def _fdl_slots(fdl, s0: int, s1: int, rdt):
    """Slots [s0, s1) of the FDL as complex in the chain's dtype."""
    if fdl.dtype == torch.float16:
        return torch.view_as_complex(fdl[..., s0:s1, :, :].to(
            rdt, memory_format=torch.contiguous_format))
    return fdl[..., s0:s1, :]


def _fdl_write(fdl, X, slot: int):
    if fdl.dtype == torch.float16:
        fdl[..., slot, :, :].copy_(torch.view_as_real(X))
    else:
        fdl[..., slot, :].copy_(X)


def _ring_mac(fdl, RR, w: int, j0: int, j1: int, rdt):
    """sum_{j0 <= j < j1} fdl[(w - j) mod P] * H[j]: the MAC of the ring
    (the accumulateSplitComplex loop, MKLNonUniformConvolver.cpp:167-182)
    over the partitions j0..j1-1, frame w's spectrum newest in slot w."""
    P = RR.shape[-2] // 2
    n = j1 - j0
    if n == P:
        pieces = [(0, P)]
    else:
        a = (w - j1 + 1) % P        # slots a, a+1, ... hold j1-1, j1-2, ...
        pieces = ([(a, a + n)] if a + n <= P
                  else [(a, P), (0, a + n - P)])
    Y = None
    for s0, s1 in pieces:
        t = (_fdl_slots(fdl, s0, s1, rdt)
             * RR[..., s0 - w + P:s1 - w + P, :]).sum(dim=-2)
        Y = t if Y is None else Y + t
    return Y


def _forward(prev, cur):
    """rfft of the overlap-save frame [prev | cur]: (..., p) each ->
    (..., p+1) complex, through the frame kernels (f32 `osa_rfft` of the
    built frame, f64 `frames_rfft` of the stacked pair's second frame)."""
    p = cur.shape[-1]
    batch = cur.shape[:-1]
    if cur.dtype == torch.float64:
        X = frames_rfft(torch.stack([prev, cur], dim=-2)
                        .reshape(-1, 2, p))[:, 1]
    else:
        X = osa_rfft(torch.cat([prev, cur], dim=-1).reshape(-1, 1, 2 * p))
    return X.reshape(batch + (p + 1,))


def _inverse(Y):
    """Valid half of irfft(Y, 2p): (..., p+1) -> (..., p)."""
    p = Y.shape[-1] - 1
    return irfft_valid(Y.reshape(-1, 1, p + 1)).reshape(Y.shape[:-1] + (p,))


def _layer_step(ls: StreamLayerState, sig, RR, H0, lp, block_size: int,
                rdt, names, dev):
    """Advance one layer by one block `sig` (..., 2, block) in place and
    return its output (..., 2, block), the layer's gain applied.  names:
    None, or while the profiler records the layer's (MAC, fire) span
    names, its work on `dev`; each MAC span counts the partitions it
    sums and their bins."""
    p, P = lp.part_size, lp.num_parts
    mac, fire = names or (None, None)
    if _is_immediate(lp, block_size):
        # processLayerBlock: the block is the frame
        with span(fire, dev) if names else NO_SPAN:
            X = _forward(ls.prev, sig)
            w = ls.step % P
            _fdl_write(ls.fdl, X, w)
            with span(mac, dev, partitions=P, bins=p + 1) if names \
                    else NO_SPAN:
                Y = _ring_mac(ls.fdl, RR, w, 0, P, rdt)
            y = _inverse(Y)
        ls.prev = sig
        ls.step += 1
        return y if lp.gain == 1.0 else lp.gain * y

    ratio = p // block_size
    slot = ls.step % ratio
    ls.acc[..., slot * block_size:(slot + 1) * block_size].copy_(sig)
    k = ls.step // ratio                      # the frame being accumulated
    # amortized tail MAC (the partsPerCallback analog,
    # MKLNonUniformConvolver.cpp:991-993, 1497-1545): the j >= 1 terms of
    # frame k use frames already in the FDL, ppc partitions a block
    ppc = -(-(P - 1) // ratio) if P > 1 else 0
    j0 = 1 + slot * ppc
    j1 = min(j0 + ppc, P)
    if j0 < j1:
        with span(mac, dev, partitions=j1 - j0, bins=p + 1) if names \
                else NO_SPAN:
            ls.par += _ring_mac(ls.fdl, RR, k % P, j0, j1, rdt)
    if slot == ratio - 1:
        # fire: frame k holds local samples [k p, (k+1) p); its output
        # lands at stream position k p + offset
        with span(fire, dev) if names else NO_SPAN:
            X = _forward(ls.prev, ls.acc)
            _fdl_write(ls.fdl, X, k % P)
            with span(mac, dev, partitions=1, bins=p + 1) if names \
                    else NO_SPAN:
                Y = ls.par + X * H0
            y = _inverse(Y)
            _ring_write(ls.ring, y, (k * p + lp.offset) % ls.ring.shape[-1])
            ls.par.zero_()
        ls.prev, ls.acc = ls.acc, ls.prev
    out = _ring_read(ls.ring, (ls.step * block_size) % ls.ring.shape[-1],
                     block_size)
    ls.step += 1
    # a view of the ring when the gain is 1: `_run_conv` sums and scales
    # the layers into a new tensor before the ring is written again
    return lp.gain * out if lp.gain != 1.0 else out


# ------------------------------------------------------------- full chain

@dataclass
class StreamState:
    """All carried state for a batch of streams; tensors (..., 2, ...)
    with the channel on the axis after the batch."""
    dc_in: torch.Tensor          # (..., 2, 2)
    dc_out: torch.Tensor         # (..., 2, 2)
    eq_states: torch.Tensor      # (..., NUM_BANDS, 4, 2): L, R, mid, side
    conv_layers: tuple           # StreamLayerState a layer
    of_states: torch.Tensor      # (..., 2, 3, 2) [channel][biquad stage]
    direct_hist: torch.Tensor | None   # (..., 2, K-1) or None
    sc_up_hist: torch.Tensor | None    # (..., 2, H_up) soft clip's 2x
    sc_down_hist: torch.Tensor | None  # (..., 2, H_dn)
    os_up_hists: tuple           # per stage (..., 2, H) upsampler history
    os_down_hists: tuple         # per stage (..., 2, H) decimator history
    dc_os: torch.Tensor | None   # (..., 2, 2) oversampled-rate DC blockers
    agc: torch.Tensor | None     # (..., 3) [env_in, env_out, gain]
    step: int

    def tensors(self):
        """Every tensor of the state."""
        out = []
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, tuple):
                for e in v:
                    if isinstance(e, StreamLayerState):
                        out += [e.prev, e.fdl, e.acc, e.ring, e.par]
                    else:
                        out.append(e)
        return out

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def clone(self) -> "StreamState":
        """A deep copy (the step mutates the state it is given)."""
        def cp(v):
            if isinstance(v, torch.Tensor):
                return v.clone()
            if isinstance(v, StreamLayerState):
                return StreamLayerState(*(cp(getattr(v, f.name))
                                          for f in fields(v)))
            if isinstance(v, tuple):
                return tuple(cp(e) for e in v)
            return v
        return StreamState(*(cp(getattr(self, f.name))
                             for f in fields(self)))


def _stage_hist_sizes(st):
    """History lengths for block-stateful upsample2 / downsample2 of one
    halfband stage: enough input past to make the causal FIRs exact."""
    h_up = max(len(st.conv) - 1, st.center_delay)
    h_dn = max(st.center_tap, st.conv_parity + 2 * (len(st.conv) - 1))
    h_dn += h_dn % 2       # even: keeps the decimator grid aligned
    return h_up, h_dn


def _tail(t, n: int):
    """The last n samples of t along the last axis (n may be 0)."""
    return t[..., t.shape[-1] - n:]


class StreamingChain:
    """A block-at-a-time chain for a fixed config and prepared IR.

    Supports: input headroom and DC blockers, 2x / 4x / 8x oversampling
    (stateful halfband cascades and oversampled-rate DC blockers), the
    20-band EQ (the band scans, every channel mode, serial and parallel,
    the AGC), the stereo NUC with wet/dry mix and direct head, the output
    filter, makeup gain, the soft clip (at the oversampled rate when
    os > 1, the local 2x wrap at 1x), the output DC blocker and headroom.

    Block contract: `step` takes base-rate blocks of `block_size`
    samples; the DSP runs at base x os_factor.  With a convolver, its L0
    partition (plan.latency) must equal block_size x os_factor.

    device: where the state lives and the step runs ("cuda" by default:
    a CPU run must be asked for).
    """

    def __init__(self, cfg: ChainConfig, eq_params: EQParams | None,
                 conv_state: NUCState | None = None,
                 conv_state_r: NUCState | None = None,
                 dtype=torch.float32, fdl_dtype=None, folded: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.eq_params = eq_params
        # folded serving: the LTI stages around the convolver (DC
        # blockers, EQ, output filter) are baked into the IR at rebuild
        # time, so the step skips their scans (`folded_from_ir`)
        self._folded = bool(folded)
        if self._folded:
            if eq_params is not None:
                raise ValueError("folded streaming: the EQ is baked into "
                                 "the IR; pass eq_params=None")
            if cfg.soft_clip_enabled or conv_state is None:
                raise ValueError("folded streaming needs an active "
                                 "convolver and no soft clip (see "
                                 "models.chain.fused_eligible)")
        if dtype not in COMPLEX_OF:
            raise ValueError(f"dtype {dtype}: float32 or float64")
        self.dtype = dtype
        self.fdl_dtype = dtype if fdl_dtype is None else fdl_dtype
        if self.fdl_dtype not in (dtype, torch.float16):
            raise ValueError(f"fdl_dtype {fdl_dtype}: the chain's dtype or "
                             "torch.float16")
        self.left = conv_state
        self.right = conv_state_r if conv_state_r is not None else conv_state
        self.os_factor = resolve_oversampling_factor(
            cfg.oversampling_factor, cfg.sample_rate)
        self.os_stages = (make_stages(self.os_factor, cfg.oversampling_preset)
                          if self.os_factor > 1 else ())
        self._os_hists = tuple(_stage_hist_sizes(st) for st in self.os_stages)
        internal_block = (conv_state.plan.latency if conv_state is not None
                          else 512 * self.os_factor)
        if internal_block % self.os_factor:
            raise ValueError("convolver block must be divisible by the "
                             "oversampling factor")
        self._internal_block = internal_block
        self.block_size = internal_block // self.os_factor
        self._sc_stage = None
        self._sc_hists = (0, 0)
        if cfg.soft_clip_enabled and self.os_factor == 1:
            # prepareSingleStage: the local 2x wrap
            self._sc_stage = design_halfband(31, 90.0)
            self._sc_hists = _stage_hist_sizes(self._sc_stage)
        self._layers = ()
        self._span_names = ()
        self._direct_w = None
        if self.left is not None:
            if self.left.plan != self.right.plan:
                raise ValueError("the two channels' NUC plans differ: the "
                                 "step runs both channels as one batch")
            cdt = COMPLEX_OF[dtype]
            layers = []
            for lp, Hl, Hr in zip(self.left.plan.layers,
                                  self.left.layer_spectra,
                                  self.right.layer_spectra):
                _check_layer(lp, internal_block)
                H = torch.stack([Hl, Hr]).to(self.device, cdt)
                layers.append((lp, _ring_spectra(H),
                               H[:, 0, :].contiguous()))
            self._layers = tuple(layers)
            self._span_names = tuple(
                (f"nuc.L{lp.part_size}", (f"nuc.L{lp.part_size}.mac",
                                          f"nuc.L{lp.part_size}.fire"))
                for lp, _, _ in layers)
            if self.left.plan.direct_taps > 0:
                taps = torch.stack([self.left.direct_ir,
                                    self.right.direct_ir])
                self._direct_w = taps.flip(-1).unsqueeze(1).to(
                    self.device, dtype)              # (2, 1, K)
        self._setup_step()
        self._stream_bytes = self.state_bytes()

    # ----------------------------------------------------- folded build
    @classmethod
    @setup_span("setup.fold")
    def folded_from_ir(cls, cfg: ChainConfig, eq_params: EQParams | None, ir,
                       spec, block_size: int = 512, dtype=torch.float32,
                       fdl_dtype=None, eps: float = 1e-10,
                       partition: int | None = None,
                       device="cuda") -> "StreamingChain":
        """A folded streaming chain: the LTI stages (DC blockers, EQ,
        output filter, HC/LC curve) baked into the IR at rebuild time
        (`models.chain.prepare_folded_convolver`), so the step is sanitize
        -> scalar gains -> NUC -> scalar gains.

        Eligibility is `models.chain.fused_eligible`: wet-only mix, no
        soft clip, AGC or oversampling, stereo-only EQ bands.
        partition: None keeps the reference's 3-layer plan (the block's
        latency); an int builds one layer at that partition, the bigblock
        tier: one step a window of `partition` samples (the layer gains
        still bake at `block_size`, so the audio is the other tiers')."""
        if not fused_eligible(cfg, eq_params, True):
            raise ValueError("config is not fused-eligible (see "
                             "models.chain.fused_eligible): needs wet-only "
                             "mix, no soft clip/AGC/oversampling, "
                             "stereo-only EQ bands")
        st = prepare_folded_convolver(ir, block_size, spec, cfg, eq_params,
                                      eps=eps, dtype=dtype,
                                      partition=partition, device=device)
        return cls(cfg, None, st.left, st.right, dtype=dtype,
                   fdl_dtype=fdl_dtype, folded=True, device=device)

    # ------------------------------------------------------------ state
    @property
    def layers(self) -> tuple:
        """The NUC's layer plans (empty without a convolver)."""
        return tuple(lp for lp, _, _ in self._layers)

    def warmup_samples(self) -> int:
        """Samples before every layer has produced its first frame:
        max(offset + 2p)."""
        return max((lp.offset + 2 * lp.part_size for lp in self.layers),
                   default=0)

    def state_bytes(self) -> int:
        """Bytes of one stream's state as `init_state` makes it: per layer
        and channel the FDL (P x (p+1) complex, or f16 pairs) and the
        previous frame, and on a tail layer the accumulator, the output
        ring and the partial MAC; the DC blockers', EQ bands', output
        filter's, FIR histories' and AGC's states."""
        r = torch.empty((), dtype=self.dtype).element_size()
        per_bin = 4 if self.fdl_dtype == torch.float16 else 2 * r
        total = 0
        for lp in self.layers:
            p = lp.part_size
            total += lp.num_parts * (p + 1) * per_bin + p * r
            if not _is_immediate(lp, self._internal_block):
                total += (p + _ring_len(lp)) * r + (p + 1) * 2 * r
        values = 2 * 2 + 2 * 2 + NUM_BANDS * 4 * 2 + 2 * 3 * 2
        if self._direct_w is not None:
            values += 2 * (self._direct_w.shape[-1] - 1)
        values += 2 * sum(self._sc_hists)
        values += 2 * sum(h_up + h_dn for h_up, h_dn in self._os_hists)
        values += 2 * 2 if self.os_factor > 1 else 0
        values += 3 if self._agc else 0
        return 2 * total + values * r

    def init_state(self, batch_shape=()) -> StreamState:
        batch_shape = tuple(batch_shape)
        rdt, dev = self.dtype, self.device
        z = lambda *shape: torch.zeros(batch_shape + shape, dtype=rdt,
                                       device=dev)
        conv_layers = tuple(
            _layer_init(batch_shape + (2,), lp, self._internal_block, rdt,
                        self.fdl_dtype, dev)
            for lp, _, _ in self._layers)
        direct_hist = (z(2, self._direct_w.shape[-1] - 1)
                       if self._direct_w is not None else None)
        sc_up = sc_down = None
        if self._sc_stage is not None:
            sc_up, sc_down = z(2, self._sc_hists[0]), z(2, self._sc_hists[1])
        agc = None
        if self.eq_params is not None and self.eq_params.agc_enabled:
            agc = torch.cat([z(2), torch.ones(batch_shape + (1,), dtype=rdt,
                                              device=dev)], dim=-1)
        return StreamState(
            dc_in=z(2, 2), dc_out=z(2, 2), eq_states=z(NUM_BANDS, 4, 2),
            conv_layers=conv_layers, of_states=z(2, 3, 2),
            direct_hist=direct_hist, sc_up_hist=sc_up, sc_down_hist=sc_down,
            os_up_hists=tuple(z(2, h[0]) for h in self._os_hists),
            os_down_hists=tuple(z(2, h[1]) for h in self._os_hists),
            dc_os=z(2, 2) if self.os_factor > 1 else None, agc=agc, step=0)

    # ------------------------------------------------------------- step
    def _setup_step(self):
        """The step's static constants (the JAX package's `_make_step`
        closure)."""
        cfg, eqp = self.cfg, self.eq_params
        sr = cfg.sample_rate
        self._proc_rate = sr * self.os_factor
        self._dc_a = self._dc_matrix(dc_blocker_alphas(sr, 3.0))
        self._dc_os_a = (self._dc_matrix(dc_blocker_alphas(self._proc_rate,
                                                           1.0))
                         if self.os_factor > 1 else None)
        self._eq_active = (not cfg.eq_bypassed) and eqp is not None
        self._conv_active = (not cfg.conv_bypassed) and self.left is not None
        self._bands = ()
        if self._eq_active:
            active = band_active_mask(eqp)
            coeffs = svf_coeffs(eqp.band_types, eqp.freqs, eqp.gains_db,
                                eqp.qs, self._proc_rate)
            self._bands = tuple(
                (b, tuple(float(c[b]) for c in coeffs), int(eqp.modes[b]))
                for b in range(NUM_BANDS) if active[b])
        ofc = output_filter_coeffs(self._proc_rate)
        conv_is_last = self._conv_active and (
            not self._eq_active or cfg.order != CONVOLVER_THEN_EQ)
        if conv_is_last:
            stages = [ofc["hc"][cfg.conv_hc_mode][0],
                      ofc["hc"][cfg.conv_hc_mode][1],
                      ofc["lc"][cfg.conv_lc_mode]]
        else:
            stages = [ofc["hpf"], ofc["lp"][cfg.eq_lpf_mode][0],
                      ofc["lp"][cfg.eq_lpf_mode][1]]
        self._of_stages = tuple(stages)
        # an f32 biquad with a pole near the unit circle takes the
        # diagonalized scan in the offline chain, which starts from zero
        # state; from a carried state it has only the 2x2 companion form,
        # whose f32 prefix products lose ~1% of the 15-20 Hz high-passes'
        # output over a 512-sample block (the offline f32 chain: ~5e-4).
        # Those stages run their scan in f64 and round the output
        self._of_wide = frozenset(
            si for si, c in enumerate(stages)
            if self.dtype == torch.float32 and tuple(c) != IDENTITY
            and _biquad_pole_radius(c[3], c[4]) > POLE_RADIUS_DIAG_F32)
        mix = min(cfg.wet_dry_mix, 1.0)
        self._wet_g = float(equal_power_sin(mix)) * CONVOLUTION_HEADROOM_GAIN
        self._dry_g = float(equal_power_sin(1.0 - mix))
        self._agc = self._eq_active and eqp.agc_enabled
        self._agc_block = int(cfg.agc_block_size) * self.os_factor

    def _dc_matrix(self, alphas):
        """(A, alphas) of the two-stage DC blocker as a 2x2 recurrence,
        A on the device once."""
        a0, a1 = alphas
        b0, b1 = 1.0 - a0, 1.0 - a1
        A = torch.tensor([[b0, 0.0], [-a1 * b0, b1]], dtype=self.dtype,
                         device=self.device)
        return A, alphas

    @staticmethod
    def _dc(x, dc, state):
        """The 2-stage DC blocker on x (..., 2, N) from state (..., 2, 2)
        through `affine_scan_2x2`; returns (y, final state)."""
        A, (a0, a1) = dc
        b0, b1 = 1.0 - a0, 1.0 - a1
        bu = torch.stack([a0 * x, a1 * b0 * x], dim=-1)
        pre, final = affine_scan_2x2(A, bu, state, key=("dc", a0, a1))
        return b1 * (b0 * (x - pre[..., 0]) - pre[..., 1]), final

    def _band_block(self, x, cb, mode, sat, b, eq):
        """One EQ band over one block, its states in eq (..., 20, 4, 2)
        updated in place."""
        if mode == STEREO:
            y, s = svf_process(x, cb, state0=eq[..., b, 0:2, :],
                               saturation=sat, simd_tanh=True)
            eq[..., b, 0:2, :] = s
            return y
        L, R = x[..., 0, :], x[..., 1, :]

        def run(sig, ch):
            y, s = svf_process(sig, cb, state0=eq[..., b, ch, :],
                               saturation=sat, simd_tanh=False)
            eq[..., b, ch, :] = s
            return y
        if mode == LEFT:
            return torch.stack([run(L, 0), R], dim=-2)
        if mode == RIGHT:
            return torch.stack([L, run(R, 1)], dim=-2)
        m = (L + R) * 0.5
        s = (L - R) * 0.5
        if mode == MID:
            fm = run(m, 2)
            return torch.stack([fm + s, fm - s], dim=-2)
        fs = run(s, 3)
        return torch.stack([m + fs, m - fs], dim=-2)

    def _run_eq(self, x, st: StreamState):
        pre = x
        sat = float(self.eq_params.saturation)
        if self.eq_params.structure == SERIAL:
            for b, cb, mode in self._bands:
                x = self._band_block(x, cb, mode, sat, b, st.eq_states)
        else:
            acc = torch.zeros_like(x)
            for b, cb, mode in self._bands:
                acc = acc + (self._band_block(pre, cb, mode, sat, b,
                                              st.eq_states) - pre)
            x = pre + acc
        if self._agc:
            x, st.agc = agc_apply(pre, x, self._proc_rate, self._agc_block,
                                  state0=st.agc, return_state=True)
        return x

    def _run_conv(self, x, st: StreamState, on: bool):
        wet = None
        dev = self.device
        with span("step.conv", dev) if on else NO_SPAN:
            for ls, (lp, RR, H0), (name, names) in zip(
                    st.conv_layers, self._layers, self._span_names):
                with span(name, dev) if on else NO_SPAN:
                    y = _layer_step(ls, x, RR, H0, lp, self._internal_block,
                                    self.dtype, names if on else None, dev)
                wet = y if wet is None else wet + y
        if self._direct_w is not None:
            k = self._direct_w.shape[-1]
            n = x.shape[-1]
            windowed = torch.cat([st.direct_hist, x], dim=-1)
            g = F.conv1d(windowed.reshape(-1, 2, n + k - 1), self._direct_w,
                         groups=2).reshape(x.shape)
            wet = g if wet is None else wet + g
            st.direct_hist = _tail(windowed, k - 1).contiguous()
        out = wet * self._wet_g
        if self._dry_g != 0.0:
            out = out + x * self._dry_g
        return out

    def _run_output_filter(self, x, st: StreamState):
        for si, c in enumerate(self._of_stages):
            if tuple(c) == IDENTITY:
                continue
            s0 = st.of_states[..., :, si, :]
            if si in self._of_wide:
                y, s = biquad_df2t_scan(x.double(), *c, s0=s0.double())
                x = y.to(self.dtype)
            else:
                x, s = biquad_df2t_scan(x, *c, s0=s0)
            st.of_states[..., :, si, :] = s
        return x

    def _os_up(self, x, st: StreamState):
        """The stateful halfband cascade up: exact block-wise
        oversample_up."""
        hists = list(st.os_up_hists)
        for i, (stage, (h_up, _)) in enumerate(zip(self.os_stages,
                                                   self._os_hists)):
            xext = torch.cat([hists[i], x], dim=-1)
            x = upsample2(xext, stage)[..., 2 * h_up:]
            hists[i] = _tail(xext, h_up)
        st.os_up_hists = tuple(hists)
        return x

    def _os_down(self, x, st: StreamState):
        hists = list(st.os_down_hists)
        for i in range(len(self.os_stages) - 1, -1, -1):
            h_dn = self._os_hists[i][1]
            uext = torch.cat([hists[i], x], dim=-1)
            x = downsample2(uext, self.os_stages[i])[..., h_dn // 2:]
            hists[i] = _tail(uext, h_dn)
        st.os_down_hists = tuple(hists)
        return x

    def _soft_clip(self, y, st: StreamState):
        thr, knee, asym = soft_clip_params(self.cfg.saturation_amount)
        if self.os_factor > 1:
            # already oversampled: clip directly (DSPCoreDouble.cpp:471-501)
            return soft_clip(y, thr, knee, asym)
        # the local 2x wrap with its FIR histories carried (the offline
        # chain's prepareSingleStage path)
        h_up, h_dn = self._sc_hists
        xext = torch.cat([st.sc_up_hist, y], dim=-1)
        u = upsample2(xext, self._sc_stage)[..., 2 * h_up:]
        u = soft_clip(u, thr, knee, asym)
        uext = torch.cat([st.sc_down_hist, u], dim=-1)
        st.sc_up_hist = _tail(xext, h_up)
        st.sc_down_hist = _tail(uext, h_dn)
        return downsample2(uext, self._sc_stage)[..., h_dn // 2:]

    def _step_span(self, block, state: StreamState):
        streams = block.shape[:-2].numel()
        return span("step", self.device, streams=streams, step=state.step,
                    state_bytes=streams * self._stream_bytes)

    def step(self, state: StreamState, block):
        """Advance by one block: block (..., 2, block_size).  The state is
        updated in place and returned with the output (..., 2,
        block_size).

        Its spans (`runtime.telemetry.span`, recorded only under a
        profiler): "step" (counts: streams, step, and state_bytes, the
        streams x `state_bytes()`) around "step.in",
        "step.conv" (one "nuc.L<p>" a layer, each with its "nuc.L<p>.mac"
        ranges and, on a fire block, "nuc.L<p>.fire") and "step.out"."""
        cfg, dev = self.cfg, self.device
        on = tracing()
        with self._step_span(block, state) if on else NO_SPAN:
            with span("step.in", dev) if on else NO_SPAN:
                x = _sanitize(block.to(self.device, self.dtype))
                if cfg.input_headroom_gain != 1.0:
                    x = x * cfg.input_headroom_gain
                if not self._folded:
                    x, state.dc_in = self._dc(x, self._dc_a, state.dc_in)
                if self.os_factor > 1:
                    x = self._os_up(x, state)
                    x, state.dc_os = self._dc(x, self._dc_os_a,
                                              state.dc_os)
            if cfg.order == CONVOLVER_THEN_EQ:
                if self._conv_active:
                    x = self._run_conv(x, state, on)
                if self._eq_active:
                    x = self._run_eq(x, state)
            else:
                if self._eq_active:
                    x = self._run_eq(x, state)
                if self._conv_active:
                    if abs(cfg.convolver_input_trim_gain - 1.0) > 1e-12:
                        x = x * cfg.convolver_input_trim_gain
                    x = self._run_conv(x, state, on)
            with span("step.out", dev) if on else NO_SPAN:
                if (self._conv_active or self._eq_active) and \
                        not self._folded:
                    x = self._run_output_filter(x, state)
                if cfg.output_makeup_gain != 1.0:
                    x = x * cfg.output_makeup_gain
                if cfg.soft_clip_enabled:
                    x = self._soft_clip(x, state)
                if self.os_factor > 1:
                    x = self._os_down(x, state)
                if not self._folded:
                    x, state.dc_out = self._dc(x, self._dc_a, state.dc_out)
                if cfg.apply_output_headroom:
                    x = x * K_OUTPUT_HEADROOM
            state.step += 1
        return state, x

    def multi_step(self, state: StreamState, blocks):
        """Advance M blocks: blocks (..., 2, M x block_size).  A loop over
        `step` (the same numbers and state as M single steps); returns
        (state, y)."""
        y, state = self.process(blocks, state)
        return state, y

    def process(self, x, state: StreamState | None = None):
        """Stream a whole (..., 2, N) signal block by block; returns
        (y (..., 2, nb x block_size), state), nb = N // block_size."""
        bs = self.block_size
        nb = x.shape[-1] // bs
        if state is None:
            state = self.init_state(tuple(x.shape[:-2]))
        outs = []
        for k in range(nb):
            state, y = self.step(state, x[..., k * bs:(k + 1) * bs])
            outs.append(y)
        return torch.cat(outs, dim=-1), state
