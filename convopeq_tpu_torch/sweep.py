"""Sweeps and A/B timings of the frame kernels on the card, each time
stated beside the card's name and power limit.

    python -m convopeq_tpu_torch.sweep rows         # f64 FFT row budget
    python -m convopeq_tpu_torch.sweep partition    # f64 headline partition
    python -m convopeq_tpu_torch.sweep ab DIR       # f32 kernels vs DIR's

- rows: csrc/frame_conv.cu built with -DFC_F64_ROW_ELEMS = 1024, 2048
  and 4096 (complex values per f64 FFT block), one nvcc each, in
  parallel; the f64 forward and inverse of each at the f64 paths' shapes,
  timed in turns (CUDA events, median of 7), outputs compared bit for
  bit across the builds.
- partition: the folded headline in f64 at 64 streams x 60 s with one
  layer of p = 8192 .. 65536 (`partition=int`): realtime factor (median
  of 3 calls after a warm-up).
- ab DIR: the f32 frame kernels and the fused kernel of this tree against
  those of the tree at DIR (another checkout's
  convopeq_tpu_torch/csrc/frame_conv.cu) on the same inputs: equal bit
  for bit or not, and their times in the order DIR, this, this, DIR.
"""
from __future__ import annotations

import statistics
import sys
from dataclasses import replace
from pathlib import Path

import torch

from . import headline
from .device import card_description
from .ops import _build
from .ops.frame_conv_kernels import COMPLEX_OF, _stream

# the f64 paths' transform shapes (C, K, p): the headline's table shape,
# and the prefilter chain's layers at 64 x 60 s (one channel a call)
ROW_SHAPES = [(8, 88, 32768), (64, 5625, 512), (64, 704, 4096),
              (128, 352, 8192)]


def time_ms(fn, reps=7):
    """Median ms of `reps` calls after a warm-up (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed (code {rc})")


def buffers(frames):
    """(X, y, scratch) of the transforms of frames (C, K, p)."""
    C, K, p = frames.shape
    cdtype = COMPLEX_OF[frames.dtype]
    return (torch.empty((C, K, p + 1), dtype=cdtype, device=frames.device),
            torch.empty_like(frames),
            torch.empty((C * K * 2 * p,), dtype=cdtype, device=frames.device))


def transforms(lib, frames, bufs=None):
    """(forward call, inverse call, X, y) of library `lib`'s entries
    frames_rfft_<f32|f64> / irfft_valid_<f32|f64> on frames (C, K, p) of
    that dtype, into `bufs` (X, y, scratch; allocated once when None)."""
    C, K, p = frames.shape
    X, y, scratch = buffers(frames) if bufs is None else bufs
    st = _stream(frames)
    suffix = "f32" if frames.dtype == torch.float32 else "f64"
    fwd_fn = getattr(lib, f"frames_rfft_{suffix}")
    inv_fn = getattr(lib, f"irfft_valid_{suffix}")

    def fwd():
        _check(fwd_fn(frames.data_ptr(), scratch.data_ptr(), X.data_ptr(), C,
                      K, p, st), "forward")

    def inv():
        _check(inv_fn(X.data_ptr(), scratch.data_ptr(), y.data_ptr(), C, K,
                      p, st), "inverse")
    return fwd, inv, X, y


def rows(card):
    base = _build.LIBRARIES["frame_conv"]
    variants = {n: replace(base, name=f"frame_conv_rows{n}",
                           flags=base.flags + (f"-DFC_F64_ROW_ELEMS={n}",))
                for n in (1024, 2048, 4096)}
    built = _build.build_all(variants)
    libs = {n: _build.bind(variants[n], built[n][0]) for n in variants}
    for n, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line and ("pass1" in line or "pass2" in line):
                print(f"  rows {n} ptxas: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for C, K, p in ROW_SHAPES:
        frames = torch.randn((C, K, p), generator=gen, device="cuda",
                             dtype=torch.float64)
        bufs = buffers(frames)              # shared: one set of buffers
        calls = {n: transforms(libs[n], frames, bufs) for n in libs}
        same, first = True, None
        for n, (fwd, inv, X, y) in calls.items():
            fwd()
            inv()
            torch.cuda.synchronize()
            if first is None:
                first = (X.clone(), y.clone())
            else:
                same = same and torch.equal(X, first[0]) and torch.equal(
                    y, first[1])
        times = {n: [] for n in libs}
        for n in [*libs, *reversed(libs)]:
            fwd, inv = calls[n][:2]
            times[n].append((time_ms(fwd), time_ms(inv)))
        ms = {n: [round(t, 4) for pair in v for t in pair]
              for n, v in times.items()}
        print(f"f64 rows C={C} K={K} p={p}: outputs equal across builds "
              f"{same}; forward / inverse ms by row budget {ms} [{card}]",
              flush=True)
        del frames, calls, bufs, first


def partition(card):
    batch, seconds = 64, 60.0
    x = headline.headline_input(batch, seconds, "cuda", torch.float64)
    for p in (8192, 16384, 32768, 65536):
        chain = headline.headline_chain("cuda", torch.float64, partition=p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = headline.measure(chain, x)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        parts = chain.convolver.plans[0].layers[0].num_parts
        med = statistics.median(walls)
        print(f"f64 headline {batch}x{seconds:g}s p={p} x{parts}: RTF "
              f"{batch * seconds / med:.1f} (median wall {med * 1e3:.2f} ms, "
              f"walls {[round(w * 1e3, 2) for w in walls]} ms), peak "
              f"{peak:.2f} GiB [{card}]", flush=True)
        del chain
        torch.cuda.empty_cache()


def ab(card, other: str):
    base = _build.LIBRARIES["frame_conv"]
    f32 = {k: v for k, v in base.signatures.items()
           if k in ("frames_rfft_f32", "irfft_valid_f32", "causal_mac_c64",
                    "fused_conv_f32")}
    source = Path(other).resolve() / "convopeq_tpu_torch" / "csrc" \
        / "frame_conv.cu"
    trees = {"before": replace(base, name="frame_conv_before", source=source,
                               signatures=f32),
             "after": replace(base, signatures=f32)}
    built = _build.build_all(trees)
    libs = {k: _build.bind(trees[k], built[k][0]) for k in trees}
    gen = torch.Generator(device="cuda").manual_seed(7)
    C, K, p, P = 8, 88, 32768, 33
    frames = torch.randn((C, K, p), generator=gen, device="cuda")
    H = torch.complex(torch.randn((P, p + 1), generator=gen, device="cuda"),
                      torch.randn((P, p + 1), generator=gen, device="cuda"))
    Cf, Kf, pf, Pf = 8, 352, 8192, 8
    ffr = torch.randn((Cf, Kf, pf), generator=gen, device="cuda")
    Hf = torch.complex(torch.randn((Pf, pf + 1), generator=gen,
                                   device="cuda"),
                       torch.randn((Pf, pf + 1), generator=gen,
                                   device="cuda"))
    calls, outs = {}, {}
    for k, lib in libs.items():
        fwd, inv, X, y = transforms(lib, frames)
        Y = torch.empty_like(X)
        yf = torch.empty_like(ffr)
        sf = torch.empty((Cf * Kf * 2 * pf,), dtype=torch.complex64,
                         device="cuda")
        st = _stream(frames)

        def mac(lib=lib, X=X, Y=Y, st=st):
            _check(lib.causal_mac_c64(X.data_ptr(), H.data_ptr(),
                                      Y.data_ptr(), C, K, p + 1, P, st),
                   "mac")

        def fused(lib=lib, yf=yf, sf=sf, st=st):
            _check(lib.fused_conv_f32(ffr.data_ptr(), Hf.data_ptr(),
                                      sf.data_ptr(), yf.data_ptr(), Cf, Kf,
                                      pf, Pf, st), "fused")

        def inv_y(lib=lib, Y=Y, y=y, st=st, sc=torch.empty(
                (C * K * 2 * p,), dtype=torch.complex64, device="cuda")):
            _check(lib.irfft_valid_f32(Y.data_ptr(), sc.data_ptr(),
                                       y.data_ptr(), C, K, p, st), "inverse")
        fwd()
        mac()
        inv_y()
        fused()
        torch.cuda.synchronize()
        outs[k] = [t.clone() for t in (X, Y, y, yf)]
        calls[k] = {"frames_rfft": fwd, "causal_mac": mac,
                    "irfft_valid": inv_y, "fused_conv": fused}
    equal = {name: torch.equal(a, b) for name, a, b in zip(
        ("frames_rfft", "causal_mac", "irfft_valid", "fused_conv"),
        outs["before"], outs["after"])}
    print(f"f32 kernels bit for bit equal to {other}'s: {equal} [{card}]")
    times = {k: {n: [] for n in calls[k]} for k in calls}
    for k in ("before", "after", "after", "before"):
        for n, fn in calls[k].items():
            times[k][n].append(round(time_ms(fn), 4))
    print(f"f32 kernel ms, order before, after, after, before (C={C} K={K} "
          f"p={p} P={P}; fused at C={Cf} K={Kf} p={pf} P={Pf}): {times} "
          f"[{card}]")


def main(argv):
    card = card_description()
    if argv[:1] == ["rows"]:
        rows(card)
    elif argv[:1] == ["partition"]:
        partition(card)
    elif argv[:1] == ["ab"] and len(argv) == 2:
        ab(card, argv[1])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
