"""The fused overlap-save convolution for P <= 8 partitions (counterpart
of `fused_conv_frames_pallas`, convopeq_tpu/ops/pallas_gemm_fft.py).

    fused_conv(frames, H) = irfft_valid(causal_mac(frames_rfft(frames), H))

in one launch sequence whose spectra X and Y never reach device memory.
Like the frame kernels it has a wrapper, a plain PyTorch version and a
launch count:

- A CPU tensor takes the plain version, `fused_conv_plain`.
- A CUDA tensor takes the hand-written kernel `fused_conv_f32` of
  csrc/frame_conv.cu, or raises ValueError for a dtype or shape it does
  not take.
- `launch_counts["fused_conv"]` grows by one at each kernel launch.

Design (csrc/frame_conv.cu, at `fused_packed_rows`): every transform on
the packed half-length grid (sample pairs as complex values, a p-point
FFT for a 2p-point real frame).  The forward transform's column FFTs as
in `frames_rfft`; then one pass in which a block owns a row of the
four-step grid and its partner row and walks the frames in order, two
frames a step, doing the forward's row FFTs, the split into the real
frame's bins X[k] and X[p-k], the MAC on the p+1 bins against a register
ring of each thread's bin pair's last P spectra, the inverse's
pre-combine and its row FFTs; then the inverse's valid-half pass, which
writes sample pairs.  The grouping works because a row of the forward's
second stage is exactly a row of the inverse's first stage.

What bounds it: per frame 4p bytes of samples in and 4p out are all the
function must move, against ~2 x (2.5 p log2 p + 10 p) + 8 P (p+1) f32
operations (the packed transform and its split, twice, and the MAC),
~19 operations a byte at p = 8192, P = 8: at the card's f32 ridge (67
TFLOP/s over 3.35 TB/s = 20), so an ideal kernel is bound by its bytes
(0.055 ms at C = 8, K = 352).  This one still moves two scratch round
trips (32p bytes a frame, against 64p for the full-length design it
replaced) through device memory, and its row pass waits on the barriers
between the shared-memory FFT stages; times in PERF.md.
"""
from __future__ import annotations

import torch

from ._build import load
from .frame_conv_kernels import (MAX_PART, MIN_PART, _check_cuda,
                                 _check_part, _raise_on, _stream,
                                 causal_mac_plain, frames_rfft_plain,
                                 irfft_valid_plain)

launch_counts = {"fused_conv": 0}

MAX_FUSED_PARTS = 8


def reset_launch_counts() -> None:
    launch_counts["fused_conv"] = 0


def fused_conv_supported(p: int, P: int) -> bool:
    """Whether the fused kernel takes this shape: 1 <= P <= 8 partitions
    of a power-of-two size from MIN_PART to MAX_PART (the gate of
    `fused_conv_supported` in the JAX package, for this kernel)."""
    return (1 <= P <= MAX_FUSED_PARTS and MIN_PART <= p <= MAX_PART
            and not p & (p - 1))


def fused_conv_plain(frames, H):
    """frames (..., K, p) real, H (P, p+1) complex -> (..., K, p): the
    valid half of the overlap-save convolution of each frame sequence."""
    return irfft_valid_plain(causal_mac_plain(frames_rfft_plain(frames), H))


def fused_conv(frames, H):
    """frames (C, K, p) f32, H (P, p+1) complex64 -> y (C, K, p) f32."""
    if frames.device.type == "cpu":
        return fused_conv_plain(frames, H)
    _check_cuda(frames, "fused_conv frames", (torch.float32,), 3)
    _check_cuda(H, "fused_conv H", (torch.complex64,), 2)
    if H.device != frames.device:
        raise ValueError("fused_conv: frames and H on different devices")
    C, K, p = frames.shape
    _check_part(p)
    P = H.shape[0]
    if H.shape[1] != p + 1:
        raise ValueError(f"fused_conv: H has {H.shape[1]} bins, p={p}")
    if not fused_conv_supported(p, P):
        raise ValueError(f"fused_conv: P={P} partitions; the kernel takes "
                         f"1 to {MAX_FUSED_PARTS}")
    # the kernel reads each sample pair as one complex value
    if frames.data_ptr() % 8:
        frames = frames.clone()
    lib = load("frame_conv")
    y = torch.empty((C, K, p), dtype=torch.float32, device=frames.device)
    scratch = torch.empty((C * K * p,), dtype=torch.complex64,
                          device=frames.device)
    with torch.cuda.device(frames.device):
        rc = lib.fused_conv_f32(frames.data_ptr(), H.data_ptr(),
                                scratch.data_ptr(), y.data_ptr(), C, K, p,
                                P, _stream(frames))
    _raise_on(rc, "fused_conv")
    launch_counts["fused_conv"] += 1
    return y
