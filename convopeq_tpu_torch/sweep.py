"""Sweeps, A/B timings and probes of the kernels on the card, each time
stated beside the card's name and power limit.

    python -m convopeq_tpu_torch.sweep rows         # f64 FFT row budget
    python -m convopeq_tpu_torch.sweep partition    # f64 headline partition
    python -m convopeq_tpu_torch.sweep ab DIR [frame_conv|quantizer]
    python -m convopeq_tpu_torch.sweep probe [DIR]  # quantizer diagnosis
    python -m convopeq_tpu_torch.sweep probe mac [DIR]  # MAC diagnosis

- rows: csrc/frame_conv.cu built with -DFC_F64_ROW_ELEMS = 1024, 2048
  and 4096 (complex values per f64 FFT block), one nvcc each, in
  parallel; the f64 forward and inverse of each at the f64 paths' shapes,
  timed in turns (CUDA events, median of 7), outputs compared bit for
  bit across the builds.
- partition: the folded headline in f64 at 64 streams x 60 s with one
  layer of p = 8192 .. 65536 (`partition=int`): realtime factor (median
  of 3 calls after a warm-up).
- ab DIR [frame_conv|quantizer]: the entries AB_ENTRIES of this tree's
  convopeq_tpu_torch/csrc/frame_conv.cu (the f32 forward, osa_rfft, the
  f64 forward, the c64 and c128 MACs, also at AB_MAC_L1, the f32 and f64
  inverses, the fused kernel) against those of the tree at DIR, each on
  the same inputs in both
  builds: equal bit for bit or not, with max |after - before| / max
  |before|, and their times in the order DIR, this, this, DIR; then the
  quantizer (csrc/error_feedback_quantize.cu) the same way at QUANT_AB:
  lattice_fir at config6's shape and psycho at app_48k_psycho's, each in
  f32 and f64, and lattice_fir at config5d32's; q and state bit for
  bit.  Both by default, or the one named.
- probe [DIR]: the quantizer's diagnosis (csrc/ef_probe.cu): ptxas
  registers and spills of every instance, its loops in the SASS (the
  listings go to convopeq_tpu_torch/_build/sass/; the probe's rounding
  chains with their opcodes in order), the SM clock, cycles an
  instruction of dependent chains and a rounding of each form, the
  chain's latency a step by mode, type and rounding (`chain_cycles`),
  cycles a step of the step fed from registers and of the chain warp's
  loop over a stage with each rounding, and of the whole kernel at one
  warp (this tree's, and DIR's beside it when given).
- probe mac [DIR]: the MAC's diagnosis (csrc/mac_probe.cu): ptxas
  registers and spills of the MAC kernels, their loops in the SASS with
  the opcodes of the short ones in order, the SM clock, blocks and warps
  an SM of the ring MAC (the design this tree's MAC replaced) and of
  this tree's MAC at P = 12, 23, 33, 64, and at MAC_SHAPES in c64 and
  c128 the ring MAC's cycles a j-step (clock64 a block, one block alone
  and the whole grid, the kernel and its j loop alone), beside this
  tree's (and DIR's) entry timed with CUDA events: ms and complex
  multiply-adds a cycle an SM.
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
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
              "causal_mac_c64", "causal_mac_c128", "irfft_valid_f32",
              "irfft_valid_f64", "fused_conv_f32")
# the MACs' second A/B shape (C, K, p, P): the prefilter chain's L1
# (4096 x 64) at 60 s, 16 channel-streams
AB_MAC_L1 = (16, 704, 4096, 64)


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

    def mac(name, entry, X, H):
        Y = torch.empty_like(X)
        fn = getattr(lib, entry)
        C1, K1, B1 = X.shape
        calls[name] = (lambda: _check(fn(
            X.data_ptr(), H.data_ptr(), Y.data_ptr(), C1, K1, B1,
            H.shape[0], st), name), Y)
    for entry in ("causal_mac_c64", "causal_mac_c128"):
        sfx = "128" if entry.endswith("128") else ""
        mac(entry, entry, ins["X" + sfx], ins["H" + sfx])
        mac(f"{entry} L1", entry, ins["X_l1" + sfx], ins["H_l1" + sfx])
    # 2p scratch values a frame for every transform: what the
    # full-length ones (an older tree's) need
    X = ins["X"]
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


def ab(card, other: str, which=("frame_conv", "quantizer")):
    if "frame_conv" in which:
        ab_frame_conv(card, other)
    if "quantizer" in which:
        ab_quantizer(card, other)


def ab_frame_conv(card, other: str):
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
    C1, K1, p1, P1 = AB_MAC_L1
    ins["X_l1"], ins["H_l1"] = cplx((C1, K1, p1 + 1)), cplx((P1, p1 + 1))
    for k in ("X", "H", "X_l1", "H_l1"):
        ins[k + "128"] = ins[k].to(torch.complex128)
    calls = {k: _ab_calls(lib, ins, C, K, p, P, fused_shape)
             for k, lib in libs.items()}
    outs = {}
    for k in calls:
        for fn, _ in calls[k].values():
            fn()
        torch.cuda.synchronize()
        outs[k] = {n: out.clone() for n, (_, out) in calls[k].items()}
    for n in outs["after"]:
        a, b = outs["before"][n], outs["after"][n]
        rel = float((b - a).abs().max() / a.abs().max())
        print(f"{n}: bit for bit equal to {other}'s {torch.equal(a, b)}, "
              f"max |after - before| / max |before| {rel:.3e} [{card}]")
    times = {k: {n: [] for n in calls[k]} for k in calls}
    for k in ("before", "after", "after", "before"):
        for n, (fn, _) in calls[k].items():
            times[k][n].append(round(time_ms(fn), 4))
    print(f"kernel ms, order before, after, after, before (C={C} K={K} "
          f"p={p} P={P}; fused at C={Cf} K={Kf} p={pf} P={Pf}; the MACs' "
          f"L1 at (C, K, p, P) = {AB_MAC_L1}): {times} [{card}]")


# the quantizer's A/B shapes: (name, dtype, R, N, bits, mode,
# coefficients): config6's (24 bits, its own bank) and app_48k_psycho's
# (24 bits, the 48 kHz psycho table) in f32 and f64, and config5d32's
# (f64, 32 bits, the 48k factory bank)
QUANT_AB = (
    ("config6 f32", torch.float32, 512, 480_000, 24, "lattice_fir",
     "config6"),
    ("config6 f64", torch.float64, 512, 480_000, 24, "lattice_fir",
     "config6"),
    ("app f32", torch.float32, 128, 2_880_000, 24, "psycho", "psycho"),
    ("app f64", torch.float64, 128, 2_880_000, 24, "psycho", "psycho"),
    ("config5d32 f64", torch.float64, 128, 960_000, 32, "lattice_fir",
     "factory"))
# the launch entries of the shared form, which every tree has
SHARED_ENTRIES = ("error_feedback_quantize_f32",
                  "error_feedback_quantize_f64")


def _other_quantizer(other: str, name: str):
    """The quantizer library of the tree at `other`, bound to its shared
    form's launch entries only."""
    base = _build.LIBRARIES["error_feedback_quantize"]
    return replace(base, name=name, source=Path(other).resolve()
                   / "convopeq_tpu_torch" / "csrc"
                   / "error_feedback_quantize.cu",
                   signatures={k: base.signatures[k]
                               for k in SHARED_ENTRIES})


def _ab_coeffs(which):
    from . import parity
    from .config6 import config6_bank
    from .models import dither
    if which == "psycho":
        return dither.psycho_coeffs(48000.0, 24)
    return dither.lattice_coeffs(config6_bank() if which == "config6" else
                                 parity.factory_bank(48000.0, 24, 0))


def ab_quantizer(card, other: str):
    """The quantizer of this tree against the tree at `other`'s, at
    QUANT_AB, on one seeded input: outputs and states bit for bit, and
    the times in the order other, this, this, other."""
    from .models import dither
    trees = {"before": _other_quantizer(other,
                                        "error_feedback_quantize_before"),
             "after": _build.LIBRARIES["error_feedback_quantize"]}
    built = _build.build_all(trees)
    libs = {k: _build.bind(trees[k], built[k][0]) for k in trees}
    h = dither.K_OUTPUT_HEADROOM
    for name, dt, R, N, bits, mode, which in QUANT_AB:
        c = _ab_coeffs(which)
        scale, _ = dither.quant_scales(bits)
        gen = torch.Generator(device="cuda").manual_seed(17)
        x = torch.randn((R, N), generator=gen, device="cuda", dtype=dt) * 0.3
        u = torch.rand((R, N, 2), generator=gen, device="cuda", dtype=dt)
        s0 = (torch.rand((R, len(c)), generator=gen, device="cuda",
                         dtype=dt) * 2 - 1) * (2 * scale)
        outs = {k: _quantize(lib, x, u, c, scale, h, mode, s0)
                for k, lib in libs.items()}
        torch.cuda.synchronize()
        same = torch.equal(outs["before"][0], outs["after"][0]) and \
            torch.equal(outs["before"][1], outs["after"][1])
        del outs
        times = {k: [] for k in libs}
        for k in ("before", "after", "after", "before"):
            times[k].append(round(time_ms(lambda: _quantize(
                libs[k], x, u, c, scale, h, mode, s0), reps=3), 3))
        print(f"quantizer {name} {mode} R={R} N={N} {bits}-bit: q and "
              f"state bit for bit equal to {other}'s {same}; ms, order "
              f"before, after, after, before: {times} [{card}]", flush=True)
        del x, u, s0
        torch.cuda.empty_cache()


# ------------------------------------------------------ the quantizer probe

PROBE_LIB = _build.Library(
    "ef_probe", _build.LIBRARIES["error_feedback_quantize"].source.parent
    / "ef_probe.cu", _build.LIBRARIES["error_feedback_quantize"].flags, {
        "ef_probe_clock": [_build._P, _build._I],
        "ef_probe_step_f32": [_build._P] * 3 + [_build._I] * 2
        + [_build._DP, _build._I, _build._D, _build._D, _build._I,
           _build._I],
        "ef_probe_step_f64": [_build._P] * 3 + [_build._I] * 2
        + [_build._DP, _build._I, _build._D, _build._D, _build._I,
           _build._I],
        "ef_probe_ops": [_build._P, _build._I, _build._D, _build._D],
        "ef_probe_op_count": [],
    }, deps=(_build.LIBRARIES["error_feedback_quantize"].source,))
# csrc/ef_probe.cu's chains, in order: an instruction each, then one
# rounding to the grid (ef_round) each
ROUNDINGS = tuple(f"round{c} {t} {f}" for t in ("f32", "f64")
                  for c in ("", "+clamp") for f in ("rint", "fold"))
PROBE_OPS = ("FADD", "FMUL", "FMNMX.NAN", "FRND", "DADD", "DMUL", "DMNMX",
             "FRND.F64", "LDS chase", "FMUL+clamp", "DMUL+clamp") + ROUNDINGS
# The dependent chain of one step, by mode (order): (adds and multiplies,
# clamps, roundings) on the longest path from one step's err to the
# next's, where the rounding is ef_round: v to the grid, and the clamp of
# q in the modes that clamp it (quantize_kernels.CLAMPS_Q).  psycho:
# c0*s0, 11 adds of the feedback sum, (xh + d) + fb, the rounding, tmp -
# q.  fixed: c0*s0, ORDER-1 adds, y, the clamp of y, + d, the rounding,
# q - y and its clamp.  lattice: err through the 8 adds of the forward
# path, c8*f8 + s8 and its clamp into s8, then c8*s8 and the last add of
# the feedback sum, y and the tail as fixed15; lattice_fir the same with
# 7 forward adds (s8 takes stage 7's output).
CHAIN_OPS = {"psycho": (14, 0, 1), "fixed": (7, 2, 1), "fixed15": (19, 2, 1),
             "lattice": (15, 3, 1), "lattice_fir": (14, 3, 1)}


def chain_cycles(per_op):
    """{'<mode> <type> <rint|fold>': cycles a step} on the chain: CHAIN_OPS
    times the probe's cycles of an add (a multiply counts as one: both
    4.1 on an H100), of a clamp (the multiply-and-clamp less the
    multiply) and of one rounding of that form."""
    from .ops.quantize_kernels import CLAMPS_Q
    out = {}
    for t, add, mul, mul_clamp in (("f32", "FADD", "FMUL", "FMUL+clamp"),
                                   ("f64", "DADD", "DMUL", "DMUL+clamp")):
        for m, (n_add, n_clamp, n_round) in CHAIN_OPS.items():
            for form in ("rint", "fold"):
                rnd = per_op[f"round{'+clamp' if m in CLAMPS_Q else ''} "
                             f"{t} {form}"]
                out[f"{m} {t} {form}"] = round(
                    n_add * per_op[add] + n_clamp * (per_op[mul_clamp]
                                                     - per_op[mul])
                    + n_round * rnd, 1)
    return out


SASS_DIR = _build.BUILD_DIR / "sass"


def _tool(name):
    found = shutil.which(name)
    return found or str(Path(_build._nvcc()).parent / name)


def _short(mangled):
    """`ef_quantize_kernel<float, 4, 9>` and the like from a mangled name."""
    try:
        out = subprocess.run([_tool("cu++filt"), mangled], capture_output=True,
                             text=True, check=True).stdout.strip()
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return mangled      # no CUDA toolkit here
    for junk in ("(int)", "(anonymous namespace)::", "<unnamed>::"):
        out = out.replace(junk, "")
    out = out.replace("(bool)1", "true").replace("(bool)0", "false")
    return out.removeprefix("void ").split("(")[0]


def ptxas_report(log):
    """{kernel: 'N registers, stack, spills'} from nvcc -Xptxas=-v."""
    rep, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _short(line.split("'")[1])
        elif entry and "bytes stack frame" in line:
            rep[entry] = line.strip()
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            rep[entry] = f"{regs} registers, {rep.get(entry, '')}"
    return rep


def sass_loops(path, out_name, min_n=24, seq_max=0):
    """cuobjdump -sass of the library at `path` into SASS_DIR/out_name;
    returns {kernel: [loop, ...]} where each loop (a backward branch's
    span of at least `min_n` instructions) is a dict of its instruction
    count and its counts of the instructions named in `kinds`, and, for
    a loop of at most `seq_max` instructions, its opcodes in order
    (`seq`)."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    SASS_DIR.mkdir(parents=True, exist_ok=True)
    (SASS_DIR / out_name).write_text(text)
    kinds = ("LDL", "STL", "LDS", "STS", "LDGSTS", "BAR", "FRND", "SYNCS",
             "LDG", "STG", "FADD", "FMUL", "FFMA", "FMNMX", "DADD", "DMUL",
             "DFMA", "DSETP", "FSETP", "FSEL", "SEL", "LOP3", "MOV")
    loops, fn, ins = {}, None, []

    def flush():
        if fn is None:
            return
        found = []
        for i, (addr, op, args) in enumerate(ins):
            if op.split(".")[0] != "BRA" or "0x" not in args:
                continue
            target = int(args.split("0x")[1].split()[0].rstrip(";"), 16)
            if target >= addr:
                continue
            body = [o for a, o, _ in ins[:i + 1] if a >= target]
            if len(body) >= min_n:
                found.append({"from": hex(target), "to": hex(addr),
                              "n": len(body), **{
                                  k: sum(o.split(".")[0] == k for o in body)
                                  for k in kinds}})
                if len(body) <= seq_max:
                    found[-1]["seq"] = " ".join(body)
        loops[_short(fn)] = found
    for line in text.splitlines():
        if "Function :" in line:
            flush()
            fn, ins = line.split("Function :")[1].strip(), []
            continue
        line = line.strip()
        if not line.startswith("/*") or "*/" not in line:
            continue
        head, _, rest = line.partition("*/")
        try:
            addr = int(head.strip("/* "), 16)
        except ValueError:
            continue
        toks = rest.split("/*")[0].replace(";", " ").split()
        if toks and toks[0].startswith("@"):
            toks = toks[1:]
        if toks:
            ins.append((addr, toks[0], " ".join(toks[1:])))
    flush()
    return loops


def _probe_coeffs():
    from .config6 import SAMPLE_RATE, config6_bank
    from .models import dither
    k9 = dither.lattice_coeffs(config6_bank())
    return {"psycho": dither.psycho_coeffs(SAMPLE_RATE, 24),
            "fixed": dither.fixed4_coeffs(SAMPLE_RATE),
            "fixed15": dither.fixed15_coeffs(SAMPLE_RATE),
            "lattice": k9, "lattice_fir": k9}


def probe(card, other=None):
    """Step 1 of the quantizer's diagnosis; see the source note of
    csrc/ef_probe.cu.  With `other`, that tree's quantizer is built and
    timed beside this one's."""
    from .models import dither
    from .ops import quantize_kernels as qk
    base = _build.LIBRARIES["error_feedback_quantize"]
    libs = {"this": base, "probe": PROBE_LIB}
    if other is not None:
        libs["other"] = _other_quantizer(other,
                                         "error_feedback_quantize_other")
    built = _build.build_all(libs)
    for k, (path, log) in built.items():
        wanted = ("ef_probe_step", "ef_probe_tile", "ef_probe_ops") \
            if k == "probe" else ("ef_quantize_kernel",)
        for kern, line in ptxas_report(log).items():
            if any(n in kern for n in wanted):
                print(f"ptxas {k}: {kern}: {line}")
        # the probe's rounding chains with their opcodes in order
        for kern, found in sass_loops(path, f"{k}.sass",
                                      seq_max=200 if k == "probe" else 0
                                      ).items():
            if any(n in kern for n in wanted):
                print(f"sass {k}: {kern}: loops {found}")
    dll = {k: _build.bind(libs[k], built[k][0]) for k in libs}
    p = dll["probe"]
    dev = torch.device("cuda")

    out = torch.zeros(32, dtype=torch.int64, device=dev)
    _check(p.ef_probe_clock(out.data_ptr(), 2_000_000), "clock")
    clk, ns = out[:2].tolist()
    ghz = clk / ns
    print(f"SM clock: {clk} cycles in {ns} ns = {ghz * 1e3:.1f} MHz "
          f"[{card}]")

    reps = 2000
    _check(p.ef_probe_ops(out.data_ptr(), reps, 2.0 ** -23, 2.0 ** -31),
           "ops")
    n_ops = p.ef_probe_op_count()
    assert n_ops == len(PROBE_OPS), (n_ops, PROBE_OPS)
    cyc = out[:n_ops].tolist()
    per_op = {name: round(c / (16 * reps), 2) for name, c in
              zip(PROBE_OPS, cyc)}
    print(f"(c) cycles an instruction, dependent chains, and a rounding "
          f"(f32 at 2^-23, f64 at 2^-31): {per_op} [{card}]")
    chain = chain_cycles(per_op)
    print(f"the chain's latency, cycles a step (CHAIN_OPS x (c)): {chain} "
          f"[{card}]")
    for name, N, m, t in (("config6", 480_000, "lattice_fir", "f32"),
                          ("app_48k_psycho", 2_880_000, "psycho", "f32"),
                          ("config5d32", 960_000, "lattice_fir", "f64")):
        print(f"latency bound at {name}'s shape (N={N}, {m} {t}), ms, rint "
              f"/ fold: {N * chain[f'{m} {t} rint'] / ghz * 1e-6:.3f} / "
              f"{N * chain[f'{m} {t} fold'] / ghz * 1e-6:.3f} [{card}]")

    coeffs = _probe_coeffs()
    h = dither.K_OUTPUT_HEADROOM
    gen = torch.Generator(device=dev).manual_seed(21)
    n_reg = 96_000
    step_b, step_tile = {}, {}
    for dt in (torch.float32, torch.float64):
        scale = 2.0 ** -23 if dt == torch.float32 else 2.0 ** -31
        ins = torch.rand((32, 8, 3), generator=gen, device=dev, dtype=dt)
        ins[..., 0] = ins[..., 0] * 0.6 - 0.3
        res = torch.empty(32, dtype=dt, device=dev)
        fn = p.ef_probe_step_f32 if dt == torch.float32 else \
            p.ef_probe_step_f64
        for mode, c in coeffs.items():
            carr = (ctypes.c_double * len(c))(*[float(v) for v in c])
            for tile, got in ((0, step_b), (1, step_tile)):
                for fold in (0, 1):
                    _check(fn(ins.data_ptr(), res.data_ptr(), out.data_ptr(),
                              n_reg, qk.MODES[mode], carr, len(c), scale, h,
                              tile, fold), "step")
                    got[f"{mode} {str(dt)[6:]} {('rint', 'fold')[fold]}"] = \
                        round(int(out[0]) / n_reg, 1)
    print(f"(b) cycles a step, the step fed from registers (one warp, "
          f"N={n_reg}): {step_b} [{card}]")
    print(f"(a') cycles a step, the chain warp's loop over one stage in "
          f"shared memory, without the copy warp (one warp, N={n_reg}): "
          f"{step_tile} [{card}]")

    # (a) the kernel as it stands, timed with CUDA events, in SM cycles
    R1, n_a = 32, 96_000
    for k in [k for k in ("other", "this") if k in dll]:
        lib = dll[k]
        step_a = {}
        for dt in (torch.float32, torch.float64):
            scale = 2.0 ** -23 if dt == torch.float32 else 2.0 ** -31
            x = torch.randn((R1, n_a), generator=gen, device=dev,
                            dtype=dt) * 0.1
            u = torch.rand((R1, n_a, 2), generator=gen, device=dev, dtype=dt)
            for mode, c in coeffs.items():
                ms = time_ms(lambda: _quantize(lib, x, u, c, scale, h, mode),
                             reps=3)
                step_a[f"{mode} {str(dt)[6:]}"] = round(
                    ms * 1e6 * ghz / n_a, 1)
        print(f"(a) {k} tree's kernel, cycles a step (CUDA events x SM "
              f"clock; R={R1}, N={n_a}): {step_a} [{card}]")
    print(f"nvidia-smi clocks.sm, clocks.max.sm: {_smi_clocks()} [{card}]")


# ------------------------------------------------------------ the MAC probe

MAC_PROBE_LIB = _build.Library(
    "mac_probe", _build.LIBRARIES["frame_conv"].source.parent
    / "mac_probe.cu", _build.LIBRARIES["frame_conv"].flags, {
        "mac_probe_ring_c64": [_build._P] * 3 + [_build._I] * 6
        + [_build._P],
        "mac_probe_ring_c128": [_build._P] * 3 + [_build._I] * 6
        + [_build._P],
        "mac_probe_ring_occupancy": [_build._I, _build._I, _build._P],
        "mac_probe_occupancy": [_build._I, _build._I, _build._I,
                                _build._P],
        "mac_probe_form_c64": [_build._I] + [_build._P] * 3
        + [_build._I] * 4,
        "mac_probe_form_c128": [_build._I] + [_build._P] * 3
        + [_build._I] * 4,
    }, deps=(_build.LIBRARIES["frame_conv"].source,))
# the MAC's probe shapes (name, C, K, p, P): the A/B shape (the headline's
# table shape) and the prefilter chain's L1 (4096 x 64) at 60 s
MAC_SHAPES = (("A/B", 8, 88, 32768, 33), ("L1", 16, 704, 4096, 64))
MAC_PARTS = (12, 23, 33, 64)       # the P of the paths' MAC layers
# csrc/mac_probe.cu's other multiply-adds, by its form number
MAC_FORMS = ("four fused multiply-adds (MacFused)",
             "two fused multiply-adds (MacHalf)")
SMS = 132                          # streaming multiprocessors of an H100


def mac_steps(K, P):
    """j-steps of one output walk over K frames: sum_f min(f + 1, P)."""
    return sum(min(f + 1, P) for f in range(K))


def mac_tile_steps(K, P, frames=8):
    """j-steps of one warp of this tree's MAC over K frames, `frames`
    output frames a step: j = 0 .. min(P - 1, f0 + frames - 1) a tile."""
    return sum(min(P - 1, f0 + frames - 1) + 1
               for f0 in range(0, K, frames))


def probe_mac(card, other=None):
    """Step 1 of the MAC's diagnosis; see the source note of
    csrc/mac_probe.cu.  With `other`, that tree's MAC is timed beside this
    one's."""
    base = _build.LIBRARIES["frame_conv"]
    sigs = {k: base.signatures[k] for k in ("causal_mac_c64",
                                            "causal_mac_c128")}
    libs = {"this": replace(base, signatures=sigs), "probe": MAC_PROBE_LIB,
            "clock": PROBE_LIB}
    if other is not None:
        libs["other"] = replace(base, name="frame_conv_other", source=Path(
            other).resolve() / "convopeq_tpu_torch" / "csrc" /
            "frame_conv.cu", signatures=sigs)
    built = _build.build_all(libs)
    for k in ("this", "other", "probe"):
        if k not in built:
            continue
        path, log = built[k]
        for kern, line in ptxas_report(log).items():
            if "mac" in kern:
                print(f"ptxas {k}: {kern}: {line}")
        for kern, found in sass_loops(path, f"mac_{k}.sass", min_n=8,
                                      seq_max=160).items():
            if "mac" in kern:
                print(f"sass {k}: {kern}: loops {found}")
    dll = {k: _build.bind(libs[k], built[k][0]) for k in libs}
    dev = torch.device("cuda")
    out = torch.zeros(16, dtype=torch.int64, device=dev)
    _check(dll["clock"].ef_probe_clock(out.data_ptr(), 2_000_000), "clock")
    clk, ns = out[:2].tolist()
    ghz = clk / ns
    print(f"SM clock: {clk} cycles in {ns} ns = {ghz * 1e3:.1f} MHz "
          f"[{card}]")
    p = dll["probe"]
    occ = {}
    res = (ctypes.c_int * 4)()
    for c128 in (0, 1):
        for P in MAC_PARTS:
            _check(p.mac_probe_ring_occupancy(P, c128, res), "occupancy")
            blocks, threads, smem, bins = list(res)
            occ[(c128, P)] = (blocks, bins)
            print(f"ring MAC {'c128' if c128 else 'c64'} P={P}: {bins} bins "
                  f"a block, {threads} threads, {smem} B shared, {blocks} "
                  f"blocks an SM = {blocks * threads // 32} warps an SM "
                  f"[{card}]")
            for C in sorted({s[1] for s in MAC_SHAPES}):
                _check(p.mac_probe_occupancy(C, P, c128, res), "occupancy")
                blocks, threads, smem, chans = list(res)
                print(f"this tree's MAC {'c128' if c128 else 'c64'} C={C} "
                      f"P={P}: {chans} channels x 32 bins a block, "
                      f"{threads} threads, {smem} B shared, {blocks} blocks "
                      f"an SM = {blocks * threads // 32} warps an SM "
                      f"[{card}]")
    gen = torch.Generator(device=dev).manual_seed(23)
    for name, C, K, part, P in MAC_SHAPES:
        B = part + 1
        steps = mac_steps(K, P)
        for dt in (torch.complex64, torch.complex128):
            c128 = int(dt == torch.complex128)
            real = torch.float64 if c128 else torch.float32
            X = torch.randn((C, K, B, 2), generator=gen, device=dev,
                            dtype=real)
            H = torch.randn((P, B, 2), generator=gen, device=dev, dtype=real)
            X, H = torch.view_as_complex(X), torch.view_as_complex(H)
            Y = torch.empty_like(X)
            blocks, bins = occ[(c128, P)]
            grid = C * -(-B // bins)
            cyc = torch.zeros(grid, dtype=torch.int64, device=dev)
            fn = p.mac_probe_ring_c128 if c128 else p.mac_probe_ring_c64
            got = {}
            for loop_only in (0, 1):
                for one in (1, 0):
                    cyc.zero_()
                    _check(fn(X.data_ptr(), H.data_ptr(), Y.data_ptr(), C, K,
                              B, P, loop_only, one, cyc.data_ptr()), "ring")
                    torch.cuda.synchronize()
                    v = cyc[:1] if one else cyc
                    what = ("j loop alone" if loop_only else "kernel") + (
                        ", one block" if one else ", whole grid (mean, max)")
                    got[what] = (round(float(v.double().mean()) / steps, 2),
                                 round(float(v.max()) / steps, 2))
            rounds = -(-grid // (blocks * SMS))
            macs = C * B * steps
            timed = {}
            for k in [k for k in ("other", "this") if k in dll]:
                entry = getattr(dll[k], "causal_mac_c128" if c128
                                else "causal_mac_c64")
                ms = time_ms(lambda: _check(entry(
                    X.data_ptr(), H.data_ptr(), Y.data_ptr(), C, K, B, P,
                    _stream(X)), "mac"))
                timed[k] = (round(ms, 4), round(ms * 1e6 * ghz
                                                / (rounds * steps), 1),
                            round(macs / (ms * 1e6 * ghz * SMS), 2))
            form = p.mac_probe_form_c128 if c128 else p.mac_probe_form_c64
            for f, what in enumerate(MAC_FORMS):
                ms = time_ms(lambda: _check(form(
                    f, X.data_ptr(), H.data_ptr(), Y.data_ptr(), C, K, B,
                    P), what))
                timed[f"this, {what}"] = (round(ms, 4), None, round(
                    macs / (ms * 1e6 * ghz * SMS), 2))
            print(f"ring MAC {name} C={C} K={K} p={part} P={P} "
                  f"{str(dt)[6:]}: {steps} j-steps a thread, {grid} blocks, "
                  f"{blocks} an SM, {rounds} rounds; cycles a j-step "
                  f"(clock64, per block): {got}; the entries (ms, the ring "
                  f"MAC's cycles a j-step as ms x clock / (rounds x steps), "
                  f"complex multiply-adds a cycle an SM): {timed} [{card}]",
                  flush=True)
            del X, H, Y
            torch.cuda.empty_cache()
            mac_residency(card, dll["this"], p, name, C, K, P, dt, ghz, gen)
    print(f"nvidia-smi clocks.sm, clocks.max.sm: {_smi_clocks()} [{card}]")


def mac_residency(card, lib, probe_lib, name, C, K, P, dt, ghz, gen):
    """This tree's MAC at C, K, P with as many bins as make m blocks an SM
    (m = 1, 2, 3, as far as they fit at once): cycles a warp's 8-frame
    step from the time (CUDA events x SM clock); equal cycles at m = 1 and
    2 say one block's warps leave the SM's pipes idle."""
    c128 = int(dt == torch.complex128)
    res = (ctypes.c_int * 4)()
    _check(probe_lib.mac_probe_occupancy(C, P, c128, res), "occupancy")
    fit, _, _, chans = list(res)
    groups = -(-C // chans)
    entry = lib.causal_mac_c128 if c128 else lib.causal_mac_c64
    real = torch.float64 if c128 else torch.float32
    steps = mac_tile_steps(K, P)
    got = {}
    for m in range(1, min(fit, 3) + 1):
        B = 32 * SMS * m // groups
        X = torch.view_as_complex(torch.randn((C, K, B, 2), generator=gen,
                                              device="cuda", dtype=real))
        H = torch.view_as_complex(torch.randn((P, B, 2), generator=gen,
                                              device="cuda", dtype=real))
        Y = torch.empty_like(X)
        ms = time_ms(lambda: _check(entry(
            X.data_ptr(), H.data_ptr(), Y.data_ptr(), C, K, B, P,
            _stream(X)), "mac"))
        got[m] = (B, round(ms, 4), round(ms * 1e6 * ghz / steps, 1))
    print(f"this tree's MAC {name} C={C} K={K} P={P} {str(dt)[6:]}, "
          f"{chans} channels a block, {steps} 8-frame steps a warp: blocks "
          f"an SM m -> (bins, ms, cycles a warp's step): {got} [{card}]",
          flush=True)


def _smi_clocks():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _quantize(lib, x, u, c, scale, h, mode, state=None):
    """One launch of library `lib`'s quantizer entry (the signature of
    ops/quantize_kernels.py), returning (q, state out)."""
    from .ops import quantize_kernels as qk
    R, N = x.shape
    s_in = torch.zeros((R, len(c)), dtype=x.dtype, device=x.device) \
        if state is None else state
    q = torch.empty_like(x)
    s_out = torch.empty_like(s_in)
    fn = lib.error_feedback_quantize_f32 if x.dtype == torch.float32 \
        else lib.error_feedback_quantize_f64
    carr = (ctypes.c_double * len(c))(*[float(v) for v in c])
    _check(fn(x.data_ptr(), u.data_ptr(), s_in.data_ptr(), q.data_ptr(),
              s_out.data_ptr(), R, N, qk.MODES[mode], carr, len(c),
              float(scale), float(h),
              torch.cuda.current_stream(x.device).cuda_stream), "quantizer")
    return q, s_out


def main(argv):
    card = card_description()
    if argv[:1] == ["rows"]:
        rows(card)
    elif argv[:1] == ["partition"]:
        partition(card)
    elif argv[:1] == ["ab"] and len(argv) in (2, 3):
        ab(card, argv[1], argv[2:] or ("frame_conv", "quantizer"))
    elif argv[:2] == ["probe", "mac"] and len(argv) <= 3:
        probe_mac(card, argv[2] if len(argv) == 3 else None)
    elif argv[:1] == ["probe"] and len(argv) <= 2:
        probe(card, argv[1] if len(argv) == 2 else None)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
