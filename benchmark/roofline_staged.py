"""The yardstick of the staged chain's kernels: the bytes and operations
of the fused convolution, of the frame kernels over several layers, and
which traced launches belong to each (`benchmark/roofline.py` gives the
peaks, the per-launch counts and the kernels' names).

The fused convolution (`csrc/frame_conv.cu` `fused_conv_f32`) runs three
kernels a launch: the forward transform's first pass
(`fwd_packed_pass1<float2, false>`, the name the forward frame transform
`frames_rfft` also launches under), one row pass `fused_packed_rows`
(the split into the frame's p+1 bins, the causal MAC over
min(k+1, P) partitions, the pre-combine of the inverse) and the
inverse's second pass (`inv_packed_pass2<float2, true>`, under the
name of the inverse frame transform's).  On one stream they run in that
order, so the forward pass just before a `fused_packed_rows` and the
inverse pass just after it are the fused convolution's.
"""
from __future__ import annotations

from . import roofline as rl

FUSED_ROWS = "fused_packed_rows"


def fused_conv(C: int, K: int, p: int, P: int, item: int = 4):
    """(bytes, ops) of one launch over C x K frames of p samples: the
    frames read once and the output written once, plus H of P x (p+1)
    bins; a real 2p-point forward and inverse transform a frame and 8
    operations a complex multiply-add, min(k+1, P) of them a bin of
    frame k."""
    b = p + 1
    return (2 * C * K * p * item + P * b * 2 * item,
            2 * C * K * rl.rfft_ops(p)
            + 8 * b * C * sum(min(k + 1, P) for k in range(K)))


def layer_frames(N: int, p: int, offset: int) -> int:
    """The frames of p that a layer delayed by `offset` has to produce
    for N samples of output: ceil((N - offset) / p), none past N."""
    return max(0, -(-(N - offset) // p))


def nuc_frame_kernels_least_s(C: int, N: int, layers, item: int = 4):
    """Least seconds of one channel's NUC through the three frame
    kernels: a launch of each a layer (p, P, offset) over C rows, the
    layer's `layer_frames` frames (the work the function needs; the
    program computes all ceil(N / p) and drops the last offset
    samples)."""
    total = 0.0
    for p, P, off in layers:
        K = layer_frames(N, p, off)
        total += sum(rl.least_s(*f, item) for f in (
            rl.frames_rfft(C, K, p, item), rl.causal_mac(C, K, p, P, item),
            rl.irfft_valid(C, K, p, item)))
    return total


def nuc_mac_least_s(C: int, N: int, layers, item: int = 4):
    """Least seconds of one channel's NUC in the causal MAC alone, each
    layer over its `layer_frames` frames."""
    return sum(rl.least_s(*rl.causal_mac(C, layer_frames(N, p, off), p, P,
                                         item), item)
               for p, P, off in layers)


def split_fused(trace):
    """(device seconds of the fused convolution's kernels, device seconds
    of the frame kernels' own launches, fused launches) in a trace."""
    ev = sorted(trace.device, key=lambda e: e[1])
    rows = [rl.is_kernel(n, (FUSED_ROWS,)) for n, _, _ in ev]
    fused = frame = 0.0
    for i, (name, _, dur) in enumerate(ev):
        if rows[i] or (rl.is_kernel(name, rl.FORWARD) and i + 1 < len(ev)
                       and rows[i + 1]) or (
                rl.is_kernel(name, rl.INVERSE) and i > 0 and rows[i - 1]):
            fused += dur
        elif rl.is_kernel(name, rl.FORWARD + rl.MAC + rl.INVERSE):
            frame += dur
    return fused / 1e6, frame / 1e6, sum(rows)
