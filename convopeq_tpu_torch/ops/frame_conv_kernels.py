"""The overlap-save frame kernels of the partitioned convolution
(counterpart of convopeq_tpu/ops/pallas_gemm_fft.py and, in f64, of
convopeq_tpu/ops/pallas_dd_fft.py).

Each kernel has a wrapper, a plain PyTorch version and a launch count:

- A CPU tensor, or any tensor inside `dispatch.plain()`, takes the plain
  version (torch.fft and elementwise ops, f32 or f64).
- Any other tensor takes the hand-written kernel of csrc/frame_conv.cu for
  its dtype: f32 / complex64, or native f64 / complex128 (the TPU's
  double-f32 "dd" tier).  Any other dtype, a mixed call (complex64 X with
  complex128 H) or a shape the kernel does not take raises ValueError.
- `launch_counts[name]` grows by one at each kernel launch, and nowhere
  else, so a run can show that it went through the kernels; each dtype
  has its own count (`frames_rfft` / `frames_rfft_f64`, `causal_mac` /
  `causal_mac_c128`, `irfft_valid` / `irfft_valid_f64`).

Spectra are in natural bin order, (C, K, p+1) complex, where the JAX
kernels used the (k2, k1) stage grid: grid index k is bin k for k <= p.

What bounds each kernel at the headline shape (C = 64 channel-streams,
K = 88 frames, p = 32768, P = 33; design in csrc/frame_conv.cu; times
measured on an H100 80GB HBM3 at 700 W):

frames_rfft — replaces `_fwd_frames_kernel` (`rfft_frames_two_stage_pallas`)
    and, in f64, `_fwd_dd_kernel` (`pallas_dd_fft.py`).
    The real 2p-point frame [prev | cur] is packed into a p-point complex
    one (sample pairs as real and imaginary parts), transformed by the
    two-pass four-step FFT, and split into the real frame's p+1 bins in
    the second pass.  Per frame: 256 KB of sample pairs read (half of
    them the previous frame's, again), 256 KB of complex scratch out and
    back in, 256 KB of spectrum out (1 MB in all, against 1.5 MB for the
    full-length complex transform), against ~2.5 N log2 N = 2.6 MFLOP
    (N = 65536): a few FLOP per byte, under the card's f32 ridge (~20),
    so it is bound by memory traffic, the scratch round trip the largest
    part that a one-pass kernel could drop.  The [prev | cur] frame is
    read from the frames directly, never built.  In f64 every byte count
    doubles and the operations stay: under the f64 ridge of ~10 (34
    TFLOP/s over 3.35 TB/s), so it is bound by bytes too.
osa_rfft — replaces `_fwd_kernel` (`rfft_two_stage_pallas`): the same
    transform read from materialized (C, K, 2p) overlap-save frames, f32
    (pass 1 of frames_rfft with its load switched at compile time), so
    equal to frames_rfft bit for bit on the frames it was built from.
causal_mac — replaces `_mac_kernel` (`causal_mac_grid_pallas`) and, in
    c128, `_dd_mac_kernel`.
    Per bin and frame: one 8-byte X read and one Y write against P complex
    multiply-adds (8P FLOP): ~16 FLOP per byte of device memory at P = 33,
    near the f32 ridge (~20), so bytes and operations bind it about
    equally there (at P = 64 operations).  A thread walks the frames of
    its bin and channel eight output frames at a time, with eight
    accumulators and a window of eight X values in registers: one shared
    load of X (a ring of its bin's last P-1 frames) and one of H serve
    eight multiply-adds.  A block's warps are channels of the same 32
    bins, sharing H in shared memory (`frame_conv_mac_block`: how many,
    for the most warps an SM); X is read from device memory once.
irfft_valid — replaces `_inv_kernel` (`irfft_valid_two_stage_pallas`)
    and, in f64, `_inv_dd_kernel`.
    The forward's packing run backwards: the first pass combines bins k
    and p-k into the p-point spectrum of the packed frame (sample pairs
    as real and imaginary parts) and does the column FFTs, the second
    does the row FFTs of only the valid second half of each frame and
    writes it as sample pairs.  Per frame: 256 KB of spectrum read (each
    bin read again as its partner's, from L2 when a frame's blocks run
    together), 256 KB of complex scratch out and back in, 128 KB out
    (against 1.6 MB for the full-length inverse it replaced); bound by
    bytes the same way.
"""
from __future__ import annotations

import torch

from ._build import load
from .dispatch import use_kernel

launch_counts = {"frames_rfft": 0, "causal_mac": 0, "irfft_valid": 0,
                 "frames_rfft_f64": 0, "causal_mac_c128": 0,
                 "irfft_valid_f64": 0, "osa_rfft": 0}
F32_KERNELS = ("frames_rfft", "causal_mac", "irfft_valid")
F64_KERNELS = ("frames_rfft_f64", "causal_mac_c128", "irfft_valid_f64")

# the library entry of each wrapper by the dtype of its first input
_ENTRIES = {
    "frames_rfft": {torch.float32: "frames_rfft_f32",
                    torch.float64: "frames_rfft_f64"},
    "osa_rfft": {torch.float32: "osa_rfft_f32"},
    "causal_mac": {torch.complex64: "causal_mac_c64",
                   torch.complex128: "causal_mac_c128"},
    "irfft_valid": {torch.complex64: "irfft_valid_f32",
                    torch.complex128: "irfft_valid_f64"},
}
# the spectra's dtype of each signal dtype the kernels take
COMPLEX_OF = {torch.float32: torch.complex64,
              torch.float64: torch.complex128}
_REAL_OF = {c: r for r, c in COMPLEX_OF.items()}


def kernel_entry(op: str, dtype) -> str:
    """The csrc/frame_conv.cu entry that wrapper `op` launches for a CUDA
    input of `dtype`; ValueError for a dtype it has no kernel for."""
    entry = _ENTRIES[op].get(dtype)
    if entry is None:
        raise ValueError(f"{op}: the CUDA kernels take "
                         f"{' or '.join(map(str, _ENTRIES[op]))}, got {dtype}")
    return entry

# what csrc/frame_conv.cu supports: power-of-two partitions in this range
MIN_PART, MAX_PART = 512, 65536


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


def osa_rfft_plain(osa):
    """rfft of materialized overlap-save frames: (..., 2p) real ->
    (..., p+1) complex."""
    return torch.fft.rfft(osa, dim=-1)


# ------------------------------------------------------------------ wrappers

def _check_cuda(t, name, dtypes, ndim):
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: the CUDA kernel takes "
                         f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
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


def _launched(entry):
    """Count a launch of library entry `entry`: the f32 / complex64 kernels
    keep their unsuffixed names (frames_rfft_f32 -> frames_rfft)."""
    launch_counts[entry[:-4] if entry[-4:] in ("_f32", "_c64")
                  else entry] += 1


def _forward(inp, name, p):
    """Launch forward wrapper `name`'s entry on inp (C, K, *) -> X
    (C, K, p+1)."""
    entry = kernel_entry(name, inp.dtype)
    _check_cuda(inp, name, tuple(_ENTRIES[name]), 3)
    C, K = inp.shape[:2]
    _check_part(p)
    cdtype = COMPLEX_OF[inp.dtype]
    # the kernel reads each sample pair as one complex value
    if inp.data_ptr() % (2 * inp.element_size()):
        inp = inp.clone()
    lib = load("frame_conv")
    X = torch.empty((C, K, p + 1), dtype=cdtype, device=inp.device)
    scratch = torch.empty((C * K * p,), dtype=cdtype, device=inp.device)
    with torch.cuda.device(inp.device):
        rc = getattr(lib, entry)(inp.data_ptr(), scratch.data_ptr(),
                                 X.data_ptr(), C, K, p, _stream(inp))
    _raise_on(rc, name)
    _launched(entry)
    return X


def frames_rfft(frames):
    """frames (C, K, p) f32 or f64 -> X (C, K, p+1) complex64 or
    complex128."""
    if not use_kernel(frames):
        return frames_rfft_plain(frames)
    return _forward(frames, "frames_rfft", frames.shape[-1])


def osa_rfft(osa):
    """osa (C, K, 2p) f32 materialized overlap-save frames -> X (C, K, p+1)
    complex64."""
    if not use_kernel(osa):
        return osa_rfft_plain(osa)
    if osa.shape[-1] % 2:
        raise ValueError(f"osa_rfft: frame length {osa.shape[-1]} is odd")
    return _forward(osa, "osa_rfft", osa.shape[-1] // 2)


def causal_mac(X, H):
    """X (C, K, B), H (P, B), both complex64 or both complex128 -> Y
    (C, K, B)."""
    if not use_kernel(X):
        return causal_mac_plain(X, H)
    entry = kernel_entry("causal_mac", X.dtype)
    _check_cuda(X, "causal_mac X", (X.dtype,), 3)
    _check_cuda(H, "causal_mac H", (X.dtype,), 2)
    if H.device != X.device:
        raise ValueError("causal_mac: X and H on different devices")
    C, K, B = X.shape
    P = H.shape[0]
    if H.shape[1] != B:
        raise ValueError(f"causal_mac: H has {H.shape[1]} bins, X has {B}")
    lib = load("frame_conv")
    block = (lib.frame_conv_mac_block if X.dtype == torch.complex64
             else lib.frame_conv_mac_block_c128)
    if block(C, P) == 0:
        raise ValueError(f"causal_mac: P={P} partitions: the {X.dtype} "
                         f"kernel takes from 1 to as many as fit its "
                         f"shared memory (frame_conv_mac_block)")
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        rc = getattr(lib, entry)(X.data_ptr(), H.data_ptr(), Y.data_ptr(),
                                 C, K, B, P, _stream(X))
    _raise_on(rc, "causal_mac")
    _launched(entry)
    return Y


def irfft_valid(Y):
    """Y (C, K, p+1) complex64 or complex128 -> y (C, K, p) f32 or f64."""
    if not use_kernel(Y):
        return irfft_valid_plain(Y)
    entry = kernel_entry("irfft_valid", Y.dtype)
    _check_cuda(Y, "irfft_valid", (Y.dtype,), 3)
    C, K, bins = Y.shape
    p = bins - 1
    _check_part(p)
    lib = load("frame_conv")
    y = torch.empty((C, K, p), dtype=_REAL_OF[Y.dtype], device=Y.device)
    scratch = torch.empty((C * K * p,), dtype=Y.dtype, device=Y.device)
    with torch.cuda.device(Y.device):
        rc = getattr(lib, entry)(Y.data_ptr(), scratch.data_ptr(),
                                 y.data_ptr(), C, K, p, _stream(Y))
    _raise_on(rc, "irfft_valid")
    _launched(entry)
    return y
