"""The yardstick of the kernels: the card's peaks, and each kernel
launch's bytes and operations from its shapes.

Peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit): 3.35
TB/s of device memory, 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the
tensor cores.  A launch's least time is max(bytes / 3.35 TB/s, ops /
peak of its type), each input byte counted read once and each output
byte written once, whatever the kernel reads again.  The operation
counts are those of the algorithm the kernel runs (a p-point packed
complex FFT a real 2p-point frame; P complex multiply-adds a bin and a
frame; the quantizer's recurrence), not of what a library would do.
"""
from __future__ import annotations

import math

MEM_BYTES_S = 3.35e12
OPS_S = {4: 67e12, 8: 34e12}          # by the real itemsize: f32, f64

# the port's hand-written kernels as the profiler names them
FORWARD = ("fwd_packed_pass",)        # frames_rfft and osa_rfft, two passes
MAC = ("causal_mac_kernel",)
INVERSE = ("inv_packed_pass",)        # irfft_valid, two passes
FUSED = ("fused_packed_rows",)
QUANTIZER = ("ef_quantize_kernel",)
SOFT_CLIP = ("soft_clip_local2x_kernel",)
PORT_KERNELS = FORWARD + MAC + INVERSE + FUSED + QUANTIZER + SOFT_CLIP


def is_kernel(name: str, family) -> bool:
    return any(k in name for k in family)


def rfft_ops(p: int) -> float:
    """Operations of one real 2p-point transform as the kernels run it:
    the packed p-point complex FFT (2.5 p log2 p) and the split between it
    and the real frame's bins (~10 a bin)."""
    return 2.5 * p * math.log2(p) + 10 * p


def least_s(nbytes: float, ops: float, item: int = 4) -> float:
    """Least seconds of a launch: bound by bytes or by operations."""
    return max(nbytes / MEM_BYTES_S, ops / OPS_S[item])


def bound(nbytes: float, ops: float, item: int = 4):
    """(least ms, what binds it), as the port's kernel table states it."""
    t_b, t_o = nbytes / MEM_BYTES_S * 1e3, ops / OPS_S[item] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def frames_rfft(C: int, K: int, p: int, item: int = 4):
    """(bytes, ops): C x K frames of p samples in, C x K x (p+1) bins out."""
    return C * K * p * item + C * K * (p + 1) * 2 * item, C * K * rfft_ops(p)


def osa_rfft(C: int, K: int, p: int, item: int = 4):
    """(bytes, ops): C x K built 2p-sample frames in, their bins out."""
    return (C * K * 2 * p * item + C * K * (p + 1) * 2 * item,
            C * K * rfft_ops(p))


def causal_mac(C: int, K: int, p: int, P: int, item: int = 4):
    """(bytes, ops): X and Y of C x K x (p+1) bins and H of P x (p+1);
    8 operations a complex multiply-add, min(k+1, P) of them a frame k."""
    b = p + 1
    return (2 * C * K * b * 2 * item + P * b * 2 * item,
            8 * b * C * sum(min(k + 1, P) for k in range(K)))


def irfft_valid(C: int, K: int, p: int, item: int = 4):
    """(bytes, ops): C x K x (p+1) bins in, the valid p samples out."""
    return C * K * (p + 1) * 2 * item + C * K * p * item, C * K * rfft_ops(p)


def quantizer_ops(mode: str, order: int) -> int:
    """Operations a sample (every multiply, add, min, max and round)."""
    ops = 2 * order - 1                          # the feedback sum
    if mode == "psycho":
        return ops + 11
    ops += 14 + (2 if mode != "fixed" else 0)    # dither term, quantize
    if mode == "lattice":
        ops += 6 * order
    elif mode == "lattice_fir":
        ops += 2 * order + 4 * (order - 1)
    return ops


def quantizer(R: int, N: int, mode: str, order: int, item: int = 4):
    """(bytes, ops): x, two uniforms and q a sample; the state in and
    out."""
    return (R * N * 4 * item + 2 * R * order * item,
            R * N * quantizer_ops(mode, order))


# csrc/softclip.cu, a sample: the first FIR (16 multiplies, 15 adds) and
# its gain of 2, the second FIR and the direct branch's two gains of 0.5
# and its add, and each clip's test (|v| and the compare with the knee's
# start)
SOFT_CLIP_OPS = (16 + 15) + 1 + (16 + 15) + 2 + 1 + 2 * 2
# a clip whose |v| passes the knee's start: its sign, t and the
# smoothstep ks (8), z (4), z^2, the rational tanh's numerator and
# denominator (5 each) and its division, the clipped value (2), the mix
# (3), the asymmetry factor (5) and the product (2)
SOFT_CLIP_KNEE_OPS = 1 + 8 + 4 + 1 + 5 + 5 + 1 + 2 + 3 + 5 + 2


def soft_clip_local2x(R: int, N: int, item: int = 4):
    """(bytes, ops) of the local 2x soft clip over R rows of N samples:
    y read once and written once (8 B a sample in f32); SOFT_CLIP_OPS
    (70) a sample, what every sample needs whatever its value.  A value
    past the knee's start adds SOFT_CLIP_KNEE_OPS (37) in its clip, a
    share the shapes do not give; even with both clips of every sample
    past it (144 a sample) the operations take less time than the bytes,
    in f32 (0.528 against 0.587 ms at 512 x 480,000) and in f64, so the
    bytes bind whatever the signal."""
    return 2 * R * N * item, R * N * SOFT_CLIP_OPS
