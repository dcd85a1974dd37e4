"""The three overlap-save frame kernels of the folded convolution chain
(counterpart of convopeq_tpu/ops/pallas_gemm_fft.py).

Each kernel has a wrapper, a plain PyTorch version and a launch count:

- A CPU tensor takes the plain version (torch.fft and elementwise ops,
  f32 or f64).
- A CUDA tensor takes the hand-written kernel of csrc/frame_conv.cu, or
  raises ValueError for a dtype or shape the kernel does not take (f64
  on the card included: the f64 tier is not ported yet).
- `launch_counts[name]` grows by one at each kernel launch, and nowhere
  else, so a run can show that it went through the kernels.

Spectra are in natural bin order, (C, K, p+1) complex, where the JAX
kernels used the (k2, k1) stage grid: grid index k is bin k for k <= p.

What bounds each kernel at the headline shape (C = 64 channel-streams,
K = 88 frames, p = 32768, P = 33; design in csrc/frame_conv.cu; times
measured on an H100 80GB HBM3 at 700 W):

frames_rfft — replaces `_fwd_frames_kernel` (`rfft_frames_two_stage_pallas`).
    Per frame: 128 KB of samples in, about 1 MB of complex scratch out and
    back in (two passes of the four-step FFT), 256 KB of spectrum out,
    against ~5 N log2 N = 5.2 MFLOP (N = 65536): about 4 FLOP per byte,
    under the card's f32 ridge (~20), so an ideal kernel is bound by
    memory traffic, most of it the scratch round trip.  This one runs at
    ~1 TB/s, a third of that bound: its shared-memory stages and the
    per-block load/transform/store sequence bind it.  The design keeps the
    [prev | cur] frame out of memory (it is read from the frames directly)
    and writes only bins k <= p; packing the real input into a half-length
    complex FFT would halve the work and the scratch, and is left for
    later.
causal_mac — replaces `_mac_kernel` (`causal_mac_grid_pallas`).
    Per bin and frame: one 8-byte X read and one Y write against P complex
    multiply-adds (8P FLOP): ~16 FLOP per byte of device memory at P = 33.
    Each bin keeps its last P frame values and its P partition values in
    shared memory, so X is read from device memory once; the loop is then
    bound by shared-memory reads (16 B per multiply-add, ~24 TB/s
    measured, near the card's shared-memory bandwidth).
irfft_valid — replaces `_inv_kernel` (`irfft_valid_two_stage_pallas`).
    Mirror of frames_rfft: 256 KB of spectrum in, the scratch round trip,
    128 KB out per frame; bound the same way.  Only the valid second half
    of each frame is computed in the second pass and written.
"""
from __future__ import annotations

import torch

from ._build import load

launch_counts = {"frames_rfft": 0, "causal_mac": 0, "irfft_valid": 0}

# what csrc/frame_conv.cu supports: power-of-two partitions in this range
MIN_PART, MAX_PART = 512, 65536


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ------------------------------------------------------------ plain versions

def frames_rfft_plain(frames):
    """rfft of the overlap-save frames [frames[k-1] | frames[k]] (zero
    before frame 0): (..., K, p) real -> (..., K, p+1) complex."""
    prev = torch.cat([torch.zeros_like(frames[..., :1, :]),
                      frames[..., :-1, :]], dim=-2)
    return torch.fft.rfft(torch.cat([prev, frames], dim=-1), dim=-1)


def causal_mac_plain(X, H):
    """Y[..., f, b] = sum_{j < P, j <= f} X[..., f-j, b] * H[j, b], with j
    ascending.  X: (..., K, B) complex; H: (P, B) complex."""
    K = X.shape[-2]
    Y = X * H[0]
    for j in range(1, min(H.shape[0], K)):
        Y[..., j:, :] += X[..., :K - j, :] * H[j]
    return Y


def irfft_valid_plain(Y):
    """Valid (second) half of irfft(Y, 2p): (..., p+1) -> (..., p).

    The imaginary parts of DC and Nyquist are dropped first: pocketfft
    ignores them, cuFFT's C2R does not, and the kernel's Hermitian
    extension (like the JAX synthesis weights) ignores them."""
    p = Y.shape[-1] - 1
    Y = torch.cat([Y[..., :1].real.to(Y.dtype), Y[..., 1:p],
                   Y[..., p:].real.to(Y.dtype)], dim=-1)
    return torch.fft.irfft(Y, n=2 * p, dim=-1)[..., p:]


# ------------------------------------------------------------------ wrappers

def _check_cuda(t, name, dtype, ndim):
    if t.dtype != dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {dtype}, got "
                         f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_part(p):
    if p < MIN_PART or p > MAX_PART or p & (p - 1):
        raise ValueError(f"partition size {p}: the CUDA kernels take powers "
                         f"of two from {MIN_PART} to {MAX_PART}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc})")


def frames_rfft(frames):
    """frames (C, K, p) f32 -> X (C, K, p+1) complex64."""
    if frames.device.type == "cpu":
        return frames_rfft_plain(frames)
    _check_cuda(frames, "frames_rfft", torch.float32, 3)
    C, K, p = frames.shape
    _check_part(p)
    lib = load("frame_conv")
    X = torch.empty((C, K, p + 1), dtype=torch.complex64,
                    device=frames.device)
    scratch = torch.empty((C * K * 2 * p,), dtype=torch.complex64,
                          device=frames.device)
    with torch.cuda.device(frames.device):
        rc = lib.frames_rfft_f32(frames.data_ptr(), scratch.data_ptr(),
                                 X.data_ptr(), C, K, p, _stream(frames))
    _raise_on(rc, "frames_rfft")
    launch_counts["frames_rfft"] += 1
    return X


def causal_mac(X, H):
    """X (C, K, B) complex64, H (P, B) complex64 -> Y (C, K, B)."""
    if X.device.type == "cpu":
        return causal_mac_plain(X, H)
    _check_cuda(X, "causal_mac X", torch.complex64, 3)
    _check_cuda(H, "causal_mac H", torch.complex64, 2)
    if H.device != X.device:
        raise ValueError("causal_mac: X and H on different devices")
    C, K, B = X.shape
    P = H.shape[0]
    if H.shape[1] != B:
        raise ValueError(f"causal_mac: H has {H.shape[1]} bins, X has {B}")
    lib = load("frame_conv")
    if lib.frame_conv_mac_tile(P) == 0:
        raise ValueError(f"causal_mac: P={P} partitions exceed the "
                         "kernel's shared memory")
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        rc = lib.causal_mac_c64(X.data_ptr(), H.data_ptr(), Y.data_ptr(),
                                C, K, B, P, _stream(X))
    _raise_on(rc, "causal_mac")
    launch_counts["causal_mac"] += 1
    return Y


def irfft_valid(Y):
    """Y (C, K, p+1) complex64 -> y (C, K, p) f32."""
    if Y.device.type == "cpu":
        return irfft_valid_plain(Y)
    _check_cuda(Y, "irfft_valid", torch.complex64, 3)
    C, K, bins = Y.shape
    p = bins - 1
    _check_part(p)
    lib = load("frame_conv")
    y = torch.empty((C, K, p), dtype=torch.float32, device=Y.device)
    scratch = torch.empty((C * K * 2 * p,), dtype=torch.complex64,
                          device=Y.device)
    with torch.cuda.device(Y.device):
        rc = lib.irfft_valid_f32(Y.data_ptr(), scratch.data_ptr(),
                                 y.data_ptr(), C, K, p, _stream(Y))
    _raise_on(rc, "irfft_valid")
    launch_counts["irfft_valid"] += 1
    return y
