"""Sweeps and A/B timings of the frame kernels on the card, each time
stated beside the card's name and power limit.

    python -m convopeq_tpu_torch.sweep rows         # f64 FFT row budget
    python -m convopeq_tpu_torch.sweep partition    # f64 headline partition
    python -m convopeq_tpu_torch.sweep ab DIR       # kernels vs DIR's

- rows: csrc/frame_conv.cu built with -DFC_F64_ROW_ELEMS = 1024, 2048
  and 4096 (complex values per f64 FFT block), one nvcc each, in
  parallel; the f64 forward and inverse of each at the f64 paths' shapes,
  timed in turns (CUDA events, median of 7), outputs compared bit for
  bit across the builds.
- partition: the folded headline in f64 at 64 streams x 60 s with one
  layer of p = 8192 .. 65536 (`partition=int`): realtime factor (median
  of 3 calls after a warm-up).
- ab DIR: the entries AB_ENTRIES of this tree's
  convopeq_tpu_torch/csrc/frame_conv.cu (the f32 forward, osa_rfft, the
  f64 forward, the c64 MAC, the f32 and f64 inverses, the fused kernel)
  against
  those of the tree at DIR, each on the same inputs in both builds: equal
  bit for bit or not, with max |after - before| / max |before|, and
  their times in the order DIR, this, this, DIR.
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
            torch.empty((C * K * p,), dtype=cdtype, device=frames.device))


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


def variants(macro, values, tag):
    """{value: bound library} of csrc/frame_conv.cu built with -Dmacro=value
    for each value, one nvcc each, in parallel; prints the passes' ptxas
    register lines."""
    base = _build.LIBRARIES["frame_conv"]
    libs = {n: replace(base, name=f"frame_conv_{tag}{n}",
                       flags=base.flags + (f"-D{macro}={n}",))
            for n in values}
    built = _build.build_all(libs)
    for n, (_, log) in built.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "registers" in line and any(
                    k in entry for k in ("pass1", "pass2", "rows")):
                print(f"  {tag} {n} ptxas: {entry}: {line.strip()}")
    return {n: _build.bind(libs[n], built[n][0]) for n in libs}


def rows(card):
    libs = variants("FC_F64_ROW_ELEMS", (1024, 2048, 4096), "rows")
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


AB_ENTRIES = ("frames_rfft_f32", "osa_rfft_f32", "frames_rfft_f64",
              "causal_mac_c64", "irfft_valid_f32", "irfft_valid_f64",
              "fused_conv_f32")


def _ab_calls(lib, ins, C, K, p, P, fused_shape):
    """{entry: (call, output)} of library `lib`'s AB_ENTRIES on the shared
    inputs `ins`, each into buffers of its own."""
    dev = ins["frames"].device
    st = _stream(ins["frames"])
    c64, c128 = torch.complex64, torch.complex128
    calls = {}

    def forward(entry, inp, cdtype):
        X = torch.empty((C, K, p + 1), dtype=cdtype, device=dev)
        # 2p values a frame: what a full-length forward (an older
        # tree's) needs; the packed one takes p of them
        sc = torch.empty((C * K * 2 * p,), dtype=cdtype, device=dev)
        fn = getattr(lib, entry)
        calls[entry] = (lambda: _check(fn(inp.data_ptr(), sc.data_ptr(),
                                          X.data_ptr(), C, K, p, st), entry),
                        X)
    forward("frames_rfft_f32", ins["frames"], c64)
    forward("osa_rfft_f32", ins["osa"], c64)
    forward("frames_rfft_f64", ins["frames64"], c128)
    X, H = ins["X"], ins["H"]
    Y = torch.empty_like(X)
    calls["causal_mac_c64"] = (lambda: _check(lib.causal_mac_c64(
        X.data_ptr(), H.data_ptr(), Y.data_ptr(), C, K, p + 1, P, st),
        "mac"), Y)
    # 2p scratch values a frame for every transform: what the
    # full-length ones (an older tree's) need
    y = torch.empty((C, K, p), device=dev)
    sc = torch.empty((C * K * 2 * p,), dtype=c64, device=dev)
    calls["irfft_valid_f32"] = (lambda: _check(lib.irfft_valid_f32(
        X.data_ptr(), sc.data_ptr(), y.data_ptr(), C, K, p, st),
        "inverse"), y)
    X128 = ins["X128"]
    y64 = torch.empty((C, K, p), dtype=torch.float64, device=dev)
    sc64 = torch.empty((C * K * 2 * p,), dtype=c128, device=dev)
    calls["irfft_valid_f64"] = (lambda: _check(lib.irfft_valid_f64(
        X128.data_ptr(), sc64.data_ptr(), y64.data_ptr(), C, K, p, st),
        "f64 inverse"), y64)
    Cf, Kf, pf, Pf = fused_shape
    ffr, Hf = ins["fused_frames"], ins["fused_H"]
    yf = torch.empty_like(ffr)
    sf = torch.empty((Cf * Kf * 2 * pf,), dtype=c64, device=dev)
    calls["fused_conv_f32"] = (lambda: _check(lib.fused_conv_f32(
        ffr.data_ptr(), Hf.data_ptr(), sf.data_ptr(), yf.data_ptr(), Cf, Kf,
        pf, Pf, st), "fused"), yf)
    return calls


def ab(card, other: str):
    base = _build.LIBRARIES["frame_conv"]
    sigs = {k: base.signatures[k] for k in AB_ENTRIES}
    source = Path(other).resolve() / "convopeq_tpu_torch" / "csrc" \
        / "frame_conv.cu"
    trees = {"before": replace(base, name="frame_conv_before", source=source,
                               signatures=sigs),
             "after": replace(base, signatures=sigs)}
    built = _build.build_all(trees)
    libs = {k: _build.bind(trees[k], built[k][0]) for k in trees}
    gen = torch.Generator(device="cuda").manual_seed(7)
    C, K, p, P = 8, 88, 32768, 33
    fused_shape = Cf, Kf, pf, Pf = 8, 352, 8192, 8

    def cplx(shape):
        return torch.complex(torch.randn(shape, generator=gen, device="cuda"),
                             torch.randn(shape, generator=gen, device="cuda"))
    frames = torch.randn((C, K, p), generator=gen, device="cuda")
    prev = torch.cat([torch.zeros_like(frames[:, :1]), frames[:, :-1]], 1)
    ins = {"frames": frames, "frames64": frames.double(),
           "osa": torch.cat([prev, frames], dim=-1),
           "X": cplx((C, K, p + 1)), "H": cplx((P, p + 1)),
           "fused_frames": torch.randn((Cf, Kf, pf), generator=gen,
                                       device="cuda"),
           "fused_H": cplx((Pf, pf + 1))}
    ins["X128"] = ins["X"].to(torch.complex128)
    calls = {k: _ab_calls(lib, ins, C, K, p, P, fused_shape)
             for k, lib in libs.items()}
    outs = {}
    for k in calls:
        for fn, _ in calls[k].values():
            fn()
        torch.cuda.synchronize()
        outs[k] = {n: out.clone() for n, (_, out) in calls[k].items()}
    for n in AB_ENTRIES:
        a, b = outs["before"][n], outs["after"][n]
        rel = float((b - a).abs().max() / a.abs().max())
        print(f"{n}: bit for bit equal to {other}'s {torch.equal(a, b)}, "
              f"max |after - before| / max |before| {rel:.3e} [{card}]")
    times = {k: {n: [] for n in AB_ENTRIES} for k in calls}
    for k in ("before", "after", "after", "before"):
        for n, (fn, _) in calls[k].items():
            times[k][n].append(round(time_ms(fn), 4))
    print(f"kernel ms, order before, after, after, before (C={C} K={K} "
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
