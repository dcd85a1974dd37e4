"""Partitioned overlap-save FFT convolution — uniform layer primitive
(counterpart of convopeq_tpu/ops/partitioned_conv.py:23-51, 289-443).

50%-overlap-save frames of size p with 2p-point real FFTs, partition
spectra H_j, and the per-frame causal MAC  Y_k = sum_j X_{k-j} * H_j
(ref: src/MKLNonUniformConvolver.cpp:1245-1336 processLayerBlock),
computed for all frames at once: one forward transform of every frame,
the MAC over the frame axis, one inverse transform of every frame.

The three steps are the frame kernels of `frame_conv_kernels`: on a CUDA
tensor the hand-written kernels of its dtype, on a CPU tensor their
plain versions.  Routing is by dtype, then shape, before the launch:

- f32 signal, complex64 spectra: a layer of P <= 8 partitions goes to
  the fused kernel of `fused_conv_kernels` (the JAX package's
  `fused_conv_supported` gate, convopeq_tpu/ops/partitioned_conv.py:
  392-401), any other layer to the three f32 frame kernels.
- f64 signal, complex128 spectra (the <=1e-9 tier): every layer, of any
  P, goes to the three f64 frame kernels, as the JAX dd route sends every
  split-spectra layer to its three dd kernels
  (convopeq_tpu/ops/partitioned_conv.py:317-335).  There is no fused f64
  kernel.
- Any other pairing (an f64 signal with complex64 spectra, or the
  reverse) raises: nothing is cast silently.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .frame_conv_kernels import (COMPLEX_OF, causal_mac, causal_mac_plain,
                                 frames_rfft, frames_rfft_plain, irfft_valid,
                                 irfft_valid_plain)
from .fused_conv_kernels import fused_conv, fused_conv_supported

_FRAME_STEPS = {
    "auto": (frames_rfft, causal_mac, irfft_valid),
    "plain": (frames_rfft_plain, causal_mac_plain, irfft_valid_plain),
}


def partition_spectra(h, part_size: int, num_parts: int | None = None,
                      dtype=torch.float64, device="cuda"):
    """Partition an impulse response and FFT each zero-padded partition.

    Mirrors SetImpulse's per-partition precompute
    (MKLNonUniformConvolver.cpp:905-955): partition j covers
    h[j*p : (j+1)*p], zero-padded to 2p, real FFT -> (num_parts, p+1).
    Rebuild-time work: computed on the host in `dtype`, then moved to
    `device`."""
    h = torch.as_tensor(h).to("cpu", dtype)
    n = h.shape[-1]
    p = part_size
    nparts = -(-n // p) if num_parts is None else num_parts
    pad = nparts * p - n
    if pad:
        h = F.pad(h, (0, pad))
    parts = h.reshape(h.shape[:-1] + (nparts, p))
    parts = F.pad(parts, (0, p))
    return torch.fft.rfft(parts, dim=-1).to(resolve_device(device))


def uniform_partitioned_conv(x, Hparts, part_size: int, frame_mac="auto"):
    """Overlap-save partitioned convolution of x with precomputed spectra.

    x: (..., N) real signal, time last.
    Hparts: (P, part_size+1) complex partition spectra from
      `partition_spectra`, on x's device: complex64 for an f32 x,
      complex128 for an f64 x.
    frame_mac: "auto" runs the kernels' wrappers (the CUDA kernels for a
      CUDA tensor, the plain versions for a CPU tensor): for f32 the
      fused kernel for P <= 8 partitions, else the three frame kernels;
      for f64 the three f64 frame kernels;
      "plain" runs the plain frame steps on any device (the f64
      reference on the card).

    Returns y: (..., N) — frames k cover [k*p,(k+1)*p); equals linear
    convolution x*h truncated to N when Hparts are unfiltered.
    """
    if frame_mac not in _FRAME_STEPS:
        raise ValueError(f"frame_mac: {frame_mac!r}")
    if Hparts.device != x.device:
        raise ValueError(f"spectra on {Hparts.device}, signal on {x.device}")
    if COMPLEX_OF.get(x.dtype) != Hparts.dtype:
        raise ValueError(f"signal {x.dtype} with spectra {Hparts.dtype}: "
                         "take f32 with complex64 or f64 with complex128")
    fwd, mac, inv = _FRAME_STEPS[frame_mac]
    n = x.shape[-1]
    p = part_size
    k = -(-n // p)
    pad = k * p - n
    xp = F.pad(x, (0, pad)) if pad else x
    frames = xp.reshape((-1, k, p)).contiguous()
    if (frame_mac == "auto" and frames.dtype == torch.float32
            and fused_conv_supported(p, Hparts.shape[0])):
        y = fused_conv(frames, Hparts)
    else:
        y = inv(mac(fwd(frames), Hparts))
    y = y.reshape(x.shape[:-1] + (k * p,))
    return y[..., :n]
