"""Smoke run of convopeq_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

1. Environment: torch and CUDA versions, nvcc, the card's name and power
   limit.  Exits non-zero, printing no result, without a card.
2. Build: compiles csrc/frame_conv.cu with nvcc (first use).
3. Each kernel against its plain PyTorch version on the card, at the
   headline shapes (C = 8 channel-streams, K = 88 frames, p = 32768,
   P = 33, f32); max |diff| <= 2e-5 x max |plain| (x max(1, .) for the
   inverse), and both times (CUDA events, median of 7 after warm-up).
4. The folded chain at the 1M-tap headline IR: (a) 4 streams x 10 s in
   f32 through the kernels against the plain path in f64 on the card,
   relative RMS <= 2e-5, finite, every kernel launched; (b) 64 streams x
   60 s: realtime factor (median of 3 calls after warm-up, fenced by
   torch.cuda.synchronize()), spread and peak device memory.
5. A JSON line of the kernels, then the result line.
Any failure raises, and the script exits non-zero.
"""
import json
import statistics
import subprocess
import sys
import time

import torch

from convopeq_tpu_torch import headline
from convopeq_tpu_torch.ops import _build
from convopeq_tpu_torch.ops import frame_conv_kernels as fk

C, K, P_SIZE, NPARTS = 8, 88, 32768, 33
SOURCE = "convopeq_tpu_torch/csrc/frame_conv.cu"
REPLACES = {
    "frames_rfft": "convopeq_tpu/ops/pallas_gemm_fft.py:335",
    "causal_mac": "convopeq_tpu/ops/pallas_gemm_fft.py:543",
    "irfft_valid": "convopeq_tpu/ops/pallas_gemm_fft.py:158",
}


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def time_ms(fn, reps=7):
    """Median milliseconds of `reps` calls after one warm-up, each timed
    with CUDA events."""
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


def phase_environment():
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    return card


def phase_build(card):
    t0 = time.perf_counter()
    path, log = _build.build()
    fk_lib = _build.frame_conv_lib()
    check(fk_lib is not None, "library loads")
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name} [{card}]")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


def phase_kernels(card):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    frames = torch.randn((C, K, P_SIZE), generator=gen, device=dev)
    H = torch.complex(torch.randn((NPARTS, P_SIZE + 1), generator=gen,
                                  device=dev),
                      torch.randn((NPARTS, P_SIZE + 1), generator=gen,
                                  device=dev))
    X_plain = fk.frames_rfft_plain(frames)
    Y_plain = fk.causal_mac_plain(X_plain, H)
    y_plain = fk.irfft_valid_plain(Y_plain)
    cases = [
        ("frames_rfft", lambda: fk.frames_rfft(frames),
         lambda: fk.frames_rfft_plain(frames), X_plain),
        ("causal_mac", lambda: fk.causal_mac(X_plain, H),
         lambda: fk.causal_mac_plain(X_plain, H), Y_plain),
        ("irfft_valid", lambda: fk.irfft_valid(Y_plain),
         lambda: fk.irfft_valid_plain(Y_plain), y_plain),
    ]
    rows = {}
    for name, kern, plain, ref in cases:
        out = kern()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if name == "irfft_valid":
            scale = max(1.0, scale)
        tol = 2e-5 * scale
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        print(f"{name}: max|diff| {err:.3e} (tol {tol:.3e}, rel "
              f"{err / scale:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} "
              f"ms  (C={C} K={K} p={P_SIZE} P={NPARTS}) [{card}]")
        check(err <= tol and torch.isfinite(out).all(),
              f"{name} disagrees with its plain version")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return rows


def phase_slice(card):
    t0 = time.perf_counter()
    chain32 = headline.headline_chain("cuda", torch.float32)
    chain64 = headline.headline_chain("cuda", torch.float64)
    plan = chain32.convolver.plans[0].layers[0]
    print(f"prepare (host fold, x2): {time.perf_counter() - t0:.2f} s; "
          f"combined IR {plan.length} taps, p={plan.part_size} "
          f"x{plan.num_parts} [{card}]")

    # (a) fidelity against the plain path in f64, counting launches
    x = headline.headline_input(4, 10.0, "cuda")
    fk.reset_launch_counts()
    y32 = chain32(x)
    torch.cuda.synchronize()
    launches = dict(fk.launch_counts)
    y64 = chain64(x.double(), frame_mac="plain")
    rel = float(((y32.double() - y64).pow(2).mean()
                 / y64.pow(2).mean()).sqrt())
    finite = bool(torch.isfinite(y32).all())
    print(f"slice 4x10s f32 kernels vs f64 plain: rel RMS {rel:.3e} "
          f"(tol 2e-5), finite {finite}, shape {tuple(y32.shape)}, "
          f"launches {launches} [{card}]")
    check(y32.shape == x.shape and finite, "slice output finite, shaped")
    check(rel <= 2e-5, "slice matches the f64 plain path")
    check(all(v > 0 for v in launches.values()),
          "every kernel launched on the main path")
    del x, y32, y64, chain64

    # (b) throughput at 64 streams x 60 s
    batch, seconds = 64, 60.0
    x = headline.headline_input(batch, seconds, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = headline.measure(chain32, x, reps=3)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(walls)
    rtf = batch * seconds / med
    print(f"slice {batch}x{seconds:.0f}s f32: realtime factor {rtf:.1f} "
          f"(median wall {med * 1e3:.2f} ms; walls "
          f"{[round(w * 1e3, 2) for w in walls]} ms; RTF spread "
          f"{batch * seconds / max(walls):.1f}..{batch * seconds / min(walls):.1f})"
          f", peak device memory {peak / 2 ** 30:.2f} GiB [{card}]")
    return launches


def main():
    card = phase_environment()
    phase_build(card)
    rows = phase_kernels(card)
    launches = phase_slice(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name], **rows[name]}
        for name in ("frames_rfft", "causal_mac", "irfft_valid")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
