"""Smoke run of convopeq_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

1. Environment: torch and CUDA versions, nvcc, the card's name and power
   limit.  Exits non-zero, printing no result, without a card.
2. Build: compiles every csrc/*.cu library with nvcc, one process per
   source, all started together.
3. Each frame kernel against its plain PyTorch version on the card, at
   the headline shapes (C = 8 channel-streams, K = 88 frames, p = 32768,
   P = 33, f32); max |diff| <= 2e-5 x max |plain| (x max(1, .) for the
   inverse), and the kernel's, the plain version's and the library call's
   times (CUDA events, median of 7 after warm-up; the MAC's library call
   is `mac_library`, a grouped complex conv1d); then the device time
   of each pass of frames_rfft and irfft_valid in one call
   (torch.profiler, by kernel name), each beside the bytes it reads and
   writes and the rate that makes.
3b. The three f64 frame kernels against their plain f64 versions at the
   same shapes: max |diff| <= 1e-12 x max |plain|; times as in 3 (library:
   cuFFT D2Z of the built frames, Z2D of the full frame), the bound at
   the card's f64 rate, and the passes as in 3.
3c. The self-check path (bench.py's, which reaches the TPU's
   `_fwd_kernel`): `osa_rfft` of materialized (C, K, 2p) overlap-save
   frames, then `irfft_valid`; `osa_rfft` against torch.fft.rfft, 2e-5
   x max, and equal to `frames_rfft` of the same frames bit for bit.
4. The folded headline chain at the 1M-tap IR: (a) 4 streams x 10 s in
   f32 through the kernels against the plain path in f64 on the card,
   relative RMS <= 2e-5, finite, every frame kernel launched; (b) 64
   streams x 60 s: realtime factor (median of 3 calls after warm-up,
   fenced by torch.cuda.synchronize()), spread and peak device memory.
5. The quantizer kernel against its plain version on the card at R = 512
   rows x N = 2048 samples, all five modes in f32 and f64: max |diff| == 0
   and equal states out, and a call split at a ragged tile equal to the
   whole call; the ragged shapes R = 37 x N = 1001 (row spans not 16-B
   aligned), N = 20 (under a tile) and N = 1001 one value past alignment,
   bit for bit; the rint form (scales 0.75 x 2^-23 in f32 and 0.75 x
   2^-15 in f64, and 2^-31 in f32, where the modes that clamp q keep
   rint) bit for bit at R = 37 x N = 1001, with the launches that took it
   counted; the f64 kernel against the reference binary's vectors
   (tests/ref_harness/vectors/shapers.json, psycho.json) bit for bit; its
   time at config6's shape (R = 512, N = 480,000, f32, lattice_fir), with
   one warp and in f64, the time a step of each mode, the SM clock while
   it runs, and the chain warp's cycles a step from the time and that
   clock.
5b. The local 2x soft clip kernel (csrc/softclip.cu) against its plain
   version (two cuDNN conv1d FIRs and eager elementwise, TF32 off) on the
   card, at master384k_d24's call (R = 512 rows x N = 480,000, f32) and
   config6_f64's parity shape (8 rows x 3,840,000, f64), noise x 0.4,
   saturation 0.3: f32 relative RMS <= 3e-7 against the plain version in
   f64 (tests/test_torch_softclip_kernel.py's bound), the f32 plain
   version held to the same; f64 max |diff| <= 1e-12 x max |plain|; one
   launch a call; the kernel's and the plain version's times (CUDA
   events) beside the bound (bytes: x read once and y written once;
   operations: SOFT_CLIP_OPS a sample).
5c. The IIR cascade kernel (csrc/iir_cascade.cu) against its plain
   version (the DC blocker's Toeplitz GEMMs with their affine scan; the
   output filter's three `biquad_df2t_scan` calls, TF32 off) and against
   the FFT form (`iir_cascade_fft`, the plain path's reference) on the
   card, noise x 0.25: at app_48k_psycho's call (R = 128 rows x N =
   2,880,000, f32, 48 kHz) `dc_block` at 3 Hz and the EQ-last and
   convolver-last output filters; at master384k_d24's (512 x 480,000,
   f32, 384 kHz) `dc_block` at 3 Hz; at config3_staged's processing rate
   (8 x 1,920,000, f32, 192 kHz) `dc_block` at 1 Hz and the
   convolver-last output filter; at 8 x 2,880,000 in f64 the EQ-last
   output filter.  f32 relative RMS <= 1e-6 against either in f64
   (tests/test_torch_iir_cascade.py's bound), on the first 16 rows; f64
   relative RMS <= 1e-9 against the f64 plain version (whose 2x2 route
   sits up to ~7e-11 from the recurrence run in long double on such
   noise at 48 kHz) and <= 1e-12 against the FFT form (~1e-15 from it);
   one launch a `dc_block` and one an `output_filter_process` call; the
   kernel's and the plain version's times (CUDA events) beside the bound
   (bytes: x read once and y written once; operations: one sequential
   pass in f64, IIR_OPS a sample and section).
6. Bench config6 (384 kHz, 768k-tap IR, soft clip, lattice dither to 24
   bits): (a) 4 streams x 1.25 s: the pre-quantizer signal of the f32
   kernel path against the f64 plain path on the card, relative RMS
   <= 2e-5; the dithered output finite, on the 24-bit grid and within the
   fir ladder's bound; every one of the five kernels launched, the soft
   clip once; (b) 256
   streams x 1.25 s: realtime factor, spread, peak memory and the
   quantizer's share of the call.
7. The fused P <= 8 kernel against its plain version on the card at the
   shapes of the paths (C = 8; p = 8192, P = 8, K = 352: the
   prefilter at 60 s; p = 4096, P = 5, K = 118: the room IR's L1 at
   10 s; p = 65536, P = 8; p = 2048, P = 4, K = 469: the staged chain's blocked EQ at 20 s,
   bench_all's 4 streams; p = 8192, P = 4, K = 235: config3_staged's EQ
   at 192 kHz, 4 streams x 10 s): max |diff| <=
   1e-4 x max |plain| (tests/test_pallas.py's bound for the TPU kernel),
   finite; the kernel's, the plain version's, the three frame kernels'
   and the library transforms' times (CUDA events, median of 7), the
   bound, and the device time of each of its three launches (the packed
   forward's pass 1, the fused row pass, the packed inverse's pass 2) as
   in 3.  It runs right after 3c: placed after phase 6, torch.profiler
   traced no kernel of it on an H100.
7b. The three frame kernels of each type against their plain versions at
   the oversampled lines' partition sizes (config3_staged's NUC layers
   p 2048 x 12 and 16384 x 23, config3's p 8192 x 43; C 8, K 64), at the
   tolerances of 3 and 3b.
8. The prefilter chain (1M-tap IR as the reference's 3-layer NUC, the
   EQ, DC blockers, output filter and HC/LC curve folded into an
   8192 x 8 prefilter): (a) 4 streams x 10 s f32 kernels against the f64
   plain path on the card, relative RMS <= 2e-5, the fused kernel and
   the three frame kernels launched; (b) 64 x 60 s: realtime factor,
   spread, peak memory, and the device time of the prefilter pass and of
   each NUC layer (CUDA events).
9. (None: the two-level folded plan it ran is not ported.)
10. The room-correction convolver (24,000-tap IR, 32 direct taps,
   512 x 12 and 4096 x 5, spectrum filter on, mix 0.7 ramped from 1.0
   over 0.1 s): (a) 4 x 10 s fidelity as in 8a, the fused kernel
   launched; (b) the realtime factor at 256 x 10 s.
11. The f64 tier, one phase per line of `parity.LINE_NAMES` (the f64
   folded headline, the f64 prefilter chain, config5, config5d32,
   config5d24, config6 in f64): (a) fidelity of the f64 kernel path
   against the f64 plain path on the card (relative RMS <= 1e-12; the
   dithered config5d32 output <= 1e-9, config5d24's reported; config6
   before the quantizer), dithered outputs on their grid and within the
   fir ladder's bound, every f64 frame kernel launched and no f32 frame
   kernel nor the fused kernel; (b) realtime factor, spread and peak
   memory at the line's batch.
12. The staged chain at 1x (`staged.py`: bench_all's config1, config2,
   config4 with the analyzer tap, config5_staged): (a) each line in f32
   at 4 x 10 s against the f64 plain path on the card, relative RMS
   <= 2e-3 (the JAX package's f32 bound for the staged chain,
   tests/test_precision.py:48-90: the 18-20 Hz output-filter biquads),
   finite, and every kernel its plan routes to launched (the fused
   kernel for the blocked EQ and each layer of <= 8 partitions, the
   three f32 frame kernels for any other layer); (b) the f64 twins at
   <= 1e-12 against the same, beside how far the plain path moves under
   a 1-ulp input change (see staged.py), only f64 frame kernels
   launched; (c) the
   EQ's band cascade at 4 x 95,744 samples (187 blocks of 512, ~2 s):
   eq20 with saturation 0.3, the AGC on, bands in mid, side and left
   only, serial and parallel, `eq_process` in f32 against f64 <= 1e-5
   (tests/test_precision.py's eq_scan bound), and the device time of
   the cascade and of the AGC alone; (d) the realtime factor, spread
   and peak memory of the eight lines at 64 streams x 20 s.
13. Oversampling and config3: (a) the halfband cascades alone, r2, r4
   and r8 up -> down at 64 streams x 20 s of 48 kHz input, f32 against
   the same function in f64 on the card (relative RMS <= 1e-5,
   tests/test_precision.py's bound), each direction's device time in
   both types, and the round trip's DC gain (0.75 at r2, the reference's
   quirk); (b) bench config3 (`config3.py`: the 2 s IR resampled to
   192 kHz, the planner's gains, the whole 4x chain folded) in both
   orders, f32 through rows 1-3 (<= 2e-5) and f64 through rows 6-8 only
   (<= 1e-12) against the f64 plain path, with the realtime factor,
   spread and peak memory at 64 x 20 s, and the MAC at config3's shape
   (p 8192, P 43) against its plain version with its bounds by bytes and
   by operations; (c) the fold against the staged chain in f64 on the
   card (the staged NUC unfiltered, the fold without the HC/LC curve,
   4 x 10 s, both orders, relative RMS < 3e-9); (d) config3_staged
   (`staged.os_lines`: the same chain staged at 4x, the NUC at block
   2048) and its f64 twin with 12a-b's checks and limits, the plain
   soft clip at 4x (4 x 2 s, saturation
   0.3, f32 against the f64 plain path at the line's f32 limit), and
   both lines' realtime factor.
14. The serving runtime (`serve.py`, `runtime/streaming.py`) on
   tools/serving_bench.py's fixture (the 1M-tap IR and eq20 at 48 kHz,
   block 512): (a) each folded tier (the reference's 3-layer plan and the
   bigblock M16 plan, f32 FDL and f16 FDL, and f64) at 1 stream x 10 s
   against the f64 offline folded chain on the plain path on the card,
   past max(offset + 2p): f32 <= 2e-5, f16 <= 1e-3, f64 <= 1e-12, each
   with its forward (f32 `osa_rfft`, f64 `frames_rfft`) and inverse
   launched and no frame kernel of the other type; (b) the staged step
   (eq20, the unfolded 3-layer NUC) against the offline `process_chain`
   in f64 on the plain path at 5 s: 1x f32 <= 2e-3 and f64 <= 1e-9, 4x
   with the soft clip in f64 <= 1e-7;
   (c) the per-block serving points (`serve.measure_point`, 400 blocks,
   25 windows at least): median / p90 / p99 / max wall, xruns, streams x
   realtime, host time a block, device operations a block and busy share
   over one profiled window, peak memory, state bytes a stream, one JSON
   line each; (d) the forward and inverse frame kernels of each type at
   the serving shapes (C = 512, p = 512, 4096, 32768, 8192) against
   their plain versions, beside cuFFT's time for the same transform and
   their bound.
15. The application path (`ConvoPeqEngine`, the CLI, metering, limiter,
   analyzer view) on the README's Quick start at the headline's size: the
   1M-tap stereo IR written as a 32-bit float WAV and loaded by path,
   eq20, EQ -> conv, soft clip 0.3, auto gain, psycho dither to 24 bits,
   48 kHz, block 512.  (a) host seconds of the IR load as is, minimum and
   mixed phase (a fresh mixed-phase cache: the design runs; the branch it
   took); (b) 4 streams x 10 s, dither off, `process` in f32 and f64
   through the kernels against the f64 plain path (2e-3, 1e-12), then
   dither on: on the 24-bit grid, and every f32 kernel of the chain (the
   three frame kernels, the fused kernel, the quantizer) launched in the
   f32 call, the f64 frame kernels and the quantizer in the f64 call;
   (c) 64 streams x 20 s with dither, f32 and f64: realtime factor, spread,
   peak memory; (d) soft clip on -> off between two calls: the fade window
   is crossfade_mix of the two chains; (e) `process_streaming`, 1 stream x
   400 blocks: folded (soft clip off) against the f64 folded offline
   chain (2e-5, osa_rfft launched) and staged against the f64 engine
   (2e-3), the median block wall and the xruns; (f) loudness (momentary,
   short-term, integrated) and true peak of (c)'s outputs: f32 against
   f64 on the card (0.01 LU, 1e-5), f64 card against CPU on 2 streams
   (1e-9 LU, 1e-12), the ms of each; (g) the CLI in a subprocess on 30 s
   of stereo, its lines echoed, out.wav read back; (h) the max-plus peak
   limiter on (c)'s f32 output and the analyzer view fed 512-sample
   blocks.  Prints its own seconds.
16. The last modules (`runtime/native_serving.py` over the native
   library, the CLI's --serve, `models/learner.py` with the quantizer's
   per-row form, live learning, `runtime/evidence.py`, `parallel/`):
   (a) 3 streams x 12 blocks through NativeServingLoop over the folded
   f32 serving chain (the 1M-tap fixture), a producer thread a stream:
   every window equal to the direct step on its gathered input bit for
   bit, each stream's blocks committed in order; (b) `serve.py --native`'s
   points (256 streams of bigblock_M16 f16, 25 windows of 170.67 ms; the
   folded tier per block at 1 and 32 streams): served blocks, underruns,
   xruns, overflows, drops, average and maximum wall against the budget,
   streams x realtime, host-to-device and device-to-host MB a window, a
   JSON line each; (c) the CLI with --serve on 10 s of stereo (the
   room-correction IR, EQ bypassed): out.wav equal to process_streaming
   of an engine with the same flags, bit for bit; (d) one learner
   generation at 48 kHz / 16 bits / mode 0 (eval_blocks 1) and 384 kHz /
   24 bits / mode 5 (eval_blocks 16): one quantizer launch a generation,
   the per-row kernel's errors equal to the plain version on the card and
   to 18 launches of the shared form bit for bit, the costs from each
   equal, the generation's wall split into simulation (device) and
   evaluator (host), the per-row kernel's time at R 144 x N 4,096 and
   65,536 beside its bounds; (e) live learning in an ADAPTIVE9 16-bit
   engine streaming folded until two generations complete: a bank
   published mid-stream, the median block wall and xruns with learning
   off and on; (f) the evidence export of that engine: the manifest
   verifies, an edited artifact fails it, the payload tier names the
   card; (g) `parallel.dryrun_multichip(4)` over CPU gloo processes.
   Prints its own seconds.
17. A JSON line of the kernels (launches: the f32 frame kernels' and the
   fused kernel's from the prefilter chain's run of phase 8a, the
   quantizer's and the soft clip's from config6's of phase 6a, the f64
   kernels' from the f64
   headline's of phase 11a, osa_rfft's from the folded serving run of
   14a; every path's counts beside them (the self-check path's of 3c
   included), the staged lines', config3's and the
   serving paths' included (serve_folded, serve_folded_f64:
   14a's 3-layer f32 and f64 runs; serve_staged: 14b's 1x f32 run); the
   MACs' rows also carry their time at config3's shape, the transforms'
   their times at the serving shapes; engine, engine_f64 and
   engine_streaming: 15b's dithered f32 and f64 `process` and 15e's
   folded stream; learner: 16d's two generations, serve_native: 16b's
   folded 32-stream point; the quantizer's row carries its per-row
   form's times from 16d), the card's name and power limit, then the
   result line.
Any failure raises, and the script exits non-zero.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from convopeq_tpu_torch import cli as cli_mod
from convopeq_tpu_torch import (config3, config6, headline, nuc3, parity,
                                serve, staged, train_banks)
from convopeq_tpu_torch.device import card_description, resolve_device
from convopeq_tpu_torch.engine import engine as engine_mod
from convopeq_tpu_torch.models import dither, learner, metering
from convopeq_tpu_torch.models import eq as eq_model
from convopeq_tpu_torch.models.analyzer_view import AnalyzerView
from convopeq_tpu_torch.models.chain import (
    StagedChain, prepare_folded_convolver,
    prepare_folded_convolver_oversampled, process_chain, process_chain_fused)
from convopeq_tpu_torch.models.convolver import stereo_prepare
from convopeq_tpu_torch.models.gain_planner import EQ_THEN_CONVOLVER
from convopeq_tpu_torch.models.nuc import FilterSpec
from convopeq_tpu_torch.models.output_filter import (
    output_filter_process, output_filter_sections)
from convopeq_tpu_torch.ops import _build, dispatch
from convopeq_tpu_torch.ops.dc_blocker import dc_block, dc_blocker_alphas
from convopeq_tpu_torch.ops import frame_conv_kernels as fk
from convopeq_tpu_torch.ops import fused_conv_kernels as fc
from convopeq_tpu_torch.ops import iir_cascade as ic
from convopeq_tpu_torch.ops import oversample
from convopeq_tpu_torch.ops import quantize_kernels as qk
from convopeq_tpu_torch.ops import softclip as sc
from convopeq_tpu_torch.ops.limiter import peak_limiter
from convopeq_tpu_torch.ops.partitioned_conv import uniform_partitioned_conv
from convopeq_tpu_torch.parallel import dryrun
from convopeq_tpu_torch.runtime import evidence, native_serving
from convopeq_tpu_torch.runtime.crossfade import crossfade_mix
from convopeq_tpu_torch.utils import wavio

C, K, P_SIZE, NPARTS = 8, 88, 32768, 33
QR, QN = 512, 2048                  # quantizer check shape (the plain loop)
VECTORS = Path(__file__).resolve().parent / "tests" / "ref_harness" / "vectors"
FRAME_CU = "convopeq_tpu_torch/csrc/frame_conv.cu"
SOURCES = {"frames_rfft": FRAME_CU, "causal_mac": FRAME_CU,
           "irfft_valid": FRAME_CU,
           "error_feedback_quantize":
               "convopeq_tpu_torch/csrc/error_feedback_quantize.cu",
           "fused_conv": FRAME_CU, "frames_rfft_f64": FRAME_CU,
           "causal_mac_c128": FRAME_CU, "irfft_valid_f64": FRAME_CU,
           "osa_rfft": FRAME_CU,
           "soft_clip_local2x": "convopeq_tpu_torch/csrc/softclip.cu",
           "iir_cascade": "convopeq_tpu_torch/csrc/iir_cascade.cu"}
REPLACES = {
    "frames_rfft": "convopeq_tpu/ops/pallas_gemm_fft.py:335",
    "causal_mac": "convopeq_tpu/ops/pallas_gemm_fft.py:543",
    "irfft_valid": "convopeq_tpu/ops/pallas_gemm_fft.py:158",
    "error_feedback_quantize": "convopeq_tpu/ops/pallas_kernels.py:116",
    "fused_conv": "convopeq_tpu/ops/pallas_gemm_fft.py:677",
    "frames_rfft_f64": "convopeq_tpu/ops/pallas_dd_fft.py:356",
    "causal_mac_c128": "convopeq_tpu/ops/pallas_dd_fft.py:586",
    "irfft_valid_f64": "convopeq_tpu/ops/pallas_dd_fft.py:465",
    "osa_rfft": "convopeq_tpu/ops/pallas_gemm_fft.py:133",
    "soft_clip_local2x": "none: XLA fused convopeq_tpu/ops/softclip.py:48 "
                         "on the TPU",
    "iir_cascade": "none: XLA ops on the TPU (convopeq_tpu/ops/dc_blocker.py "
                   "dc_block's Toeplitz products, convopeq_tpu/ops/"
                   "scan_iir.py biquad_df2t_scan's routes)",
}
# fused kernel check shapes (C, K, p, P): the prefilter at 60 s, the
# room IR's L1 at 10 s, the largest partition the kernel takes (its row
# pass at 256 threads a block), the staged chain's blocked EQ (eq20: tail
# 7,903 taps) at 20 s, and config3_staged's EQ at 192 kHz (tail 31,612
# taps) at 10 s
FUSED_SHAPES = [(8, 352, 8192, 8), (8, 118, 4096, 5), (8, 44, 65536, 8),
                (8, 469, 2048, 4), (8, 235, 8192, 4)]
# frame kernel check shapes (p, P) of the oversampled lines: the staged
# NUC's layers at block 2048 (config3_staged) and config3's folded layer
LAYER_SHAPES = [(2048, 12), (8192, 43), (16384, 23)]
# one H100 SXM (NVIDIA's data sheet): device memory rate, f32 and f64
# rates outside the tensor cores
MEM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
F64_OPS_S = 34e12


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


def rfft_ops(p):
    """Operations of one real 2p-point transform as the kernels run it:
    the packed p-point complex FFT (2.5 p log2 p) and the split between it
    and the real frame's bins (~10 a bin)."""
    return 2.5 * p * math.log2(p) + 10 * p


def bound(nbytes, ops, ops_s=F32_OPS_S):
    """(least ms, what binds it) for `nbytes` moved and `ops` operations
    at `ops_s` a second (f32 by default)."""
    t_bytes, t_ops = nbytes / MEM_BYTES_S * 1e3, ops / ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mac_library(X, H):
    """causal_mac's function as one PyTorch call, the MAC rows' library
    yardstick (used nowhere in the port): a grouped complex conv1d over
    the frame axis, one group a bin, H flipped so that the
    cross-correlation runs j ascending back from frame f.  X (C, K, B),
    H (P, B) -> Y (C, K, B)."""
    P, K = H.shape[0], X.shape[1]
    return torch.nn.functional.conv1d(
        X.transpose(1, 2), H.flip(0).T.unsqueeze(1), padding=P - 1,
        groups=X.shape[2])[..., :K].transpose(1, 2)


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    card = card_description()
    print(card)
    return card


def phase_build(card):
    t0 = time.perf_counter()
    built = _build.build_all()
    for name in built:
        check(_build.load(name) is not None, f"library {name} loads")
    print(f"build (one nvcc a source, in parallel): "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{[p.name for p, _ in built.values()]} [{card}]")
    for _, log in built.values():
        for line in log.splitlines():
            spills = "spill" in line and " 0 bytes spill stores, 0 bytes " \
                "spill loads" not in f" {line.strip()}"
            if "registers" in line or "Compiling entry" in line or spills:
                print("  ptxas:", line.strip())


def phase_kernels(card, dtype=torch.float32):
    """The three frame kernels of `dtype` (f32: rows 1-3, f64: rows 6-8)
    against their plain versions at C, K, P_SIZE, NPARTS."""
    dev = torch.device("cuda")
    f64 = dtype == torch.float64
    gen = torch.Generator(device=dev).manual_seed(7)
    frames = torch.randn((C, K, P_SIZE), generator=gen, device=dev,
                         dtype=dtype)
    H = torch.complex(torch.randn((NPARTS, P_SIZE + 1), generator=gen,
                                  device=dev, dtype=dtype),
                      torch.randn((NPARTS, P_SIZE + 1), generator=gen,
                                  device=dev, dtype=dtype))
    X_plain = fk.frames_rfft_plain(frames)
    Y_plain = fk.causal_mac_plain(X_plain, H)
    y_plain = fk.irfft_valid_plain(Y_plain)
    osa = torch.cat([torch.cat([torch.zeros_like(frames[:, :1]),
                                frames[:, :-1]], dim=1), frames], dim=-1)
    B = P_SIZE + 1
    n_fft = 2 * P_SIZE
    fft_ops = C * K * rfft_ops(P_SIZE)
    mac_ops = 8 * B * C * sum(min(k + 1, NPARTS) for k in range(K))
    item = frames.element_size()
    spec_bytes, sig_bytes = C * K * B * 2 * item, C * K * P_SIZE * item
    rate = F64_OPS_S if f64 else F32_OPS_S
    names = fk.F64_KERNELS if f64 else fk.F32_KERNELS
    cases = [
        (names[0], lambda: fk.frames_rfft(frames),
         lambda: fk.frames_rfft_plain(frames), X_plain,
         lambda: torch.fft.rfft(osa, dim=-1),
         bound(sig_bytes + spec_bytes, fft_ops, rate)),
        (names[1], lambda: fk.causal_mac(X_plain, H),
         lambda: fk.causal_mac_plain(X_plain, H), Y_plain,
         lambda: mac_library(X_plain, H),
         bound(2 * spec_bytes + NPARTS * B * 2 * item, mac_ops, rate)),
        (names[2], lambda: fk.irfft_valid(Y_plain),
         lambda: fk.irfft_valid_plain(Y_plain), y_plain,
         lambda: torch.fft.irfft(Y_plain, n=n_fft, dim=-1),
         bound(spec_bytes + sig_bytes, fft_ops, rate)),
    ]
    rows = {}
    for name, kern, plain, ref, library, (bound_ms, bound_by) in cases:
        out = kern()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if name == "irfft_valid":
            scale = max(1.0, scale)
        tol = (1e-12 if f64 else 2e-5) * scale
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        library_ms = time_ms(library) if library else None
        print(f"{name}: max|diff| {err:.3e} (tol {tol:.3e}, rel "
              f"{err / scale:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} "
              f"ms  library {library_ms} ms  bound {bound_ms:.4f} ms "
              f"({bound_by})  (C={C} K={K} p={P_SIZE} P={NPARTS}, "
              f"{str(dtype)[6:]}) [{card}]")
        check(err <= tol and torch.isfinite(out).all(),
              f"{name} disagrees with its plain version")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
    rows[names[0]]["passes"] = pass_times(
        card, lambda: fk.frames_rfft(frames), frames,
        ("fwd_packed_pass1", "fwd_packed_pass2"))
    rows[names[2]]["passes"] = pass_times(
        card, lambda: fk.irfft_valid(Y_plain), frames,
        ("inv_packed_pass1", "inv_packed_pass2"))
    return rows


# real values of the frames' type that each transform pass reads and
# writes a frame of p samples: the packed forward reads p sample pairs and
# writes p complex values (pass 1), then reads them and writes p+1 bins
# (pass 2); the packed inverse reads each of the p+1 bins twice (as bin k
# and as partner p-k) and writes p complex values (pass 1), then reads
# them and writes p/2 sample pairs (pass 2); the fused row pass reads and
# writes p complex values (the fused kernel runs the forward's pass 1,
# that pass and the inverse's pass 2)
PASS_VALUES = {"fwd_packed_pass1": lambda p: 2 * p + 2 * p,
               "fwd_packed_pass2": lambda p: 2 * p + 2 * (p + 1),
               "inv_packed_pass1": lambda p: 4 * (p + 1) + 2 * p,
               "inv_packed_pass2": lambda p: 2 * p + p,
               "fused_packed_rows": lambda p: 2 * p + 2 * p}


def pass_times(card, fn, frames, expect):
    """Device time of each pass of one call fn() (torch.profiler, by
    kernel name), with the bytes the pass reads and writes and its rate;
    printed on one line and returned as {pass: {ms, bytes, GB/s}}.  Fails
    when a pass in `expect`, which fn() launches, was not traced (after
    three tries when the profiler traced nothing at all)."""
    frames_n = frames.shape[0] * frames.shape[1]
    p, item = frames.shape[-1], frames.element_size()
    # torch.profiler now and then delivers no device event at all from a
    # call (seen once in phase 7 on an H100): trace the call again then,
    # up to three times; a trace that has kernels but misses a pass fails
    for _ in range(3):
        _wall, prof = headline.profile_call(fn)
        if prof:
            break
    out, parts = {}, []
    for name, values in PASS_VALUES.items():
        hits = [r for r in prof if name in r[0]]
        if not hits:
            continue
        ms = sum(r[1] for r in hits)
        nbytes = frames_n * values(p) * item
        out[name] = {"ms": ms, "bytes": nbytes, "GB_s": nbytes / ms / 1e6}
        parts.append(f"{name} {ms:.4f} ms, {nbytes / 1e6:.2f} MB, "
                     f"{nbytes / ms / 1e6:.0f} GB/s")
    print(f"passes of one call ({str(frames.dtype)[6:]}, C={frames.shape[0]}"
          f" K={frames.shape[1]} p={p}; torch.profiler device time, bytes as "
          f"each pass reads and writes them): {'; '.join(parts)} [{card}]")
    missed = [name for name in expect if name not in out]
    check(not missed, f"torch.profiler traced no {missed} of a call that "
          f"launches them ({len(prof)} device kernels traced: "
          f"{[r[0][:60] for r in prof[:3]]})")
    return out


def phase_self_check(card):
    """bench.py's self-check path on the port: osa_rfft of materialized
    overlap-save frames, then irfft_valid, counted; then osa_rfft against
    torch.fft.rfft and against frames_rfft of the same frames."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    frames = torch.randn((C, K, P_SIZE), generator=gen, device=dev)
    osa = torch.cat([torch.cat([torch.zeros_like(frames[:, :1]),
                                frames[:, :-1]], dim=1), frames], dim=-1)
    dispatch.reset_launches()
    X = fk.osa_rfft(osa)
    total = float(fk.irfft_valid(X).sum())
    torch.cuda.synchronize()
    launches = dispatch.launches()
    ref = fk.osa_rfft_plain(osa)
    scale = float(ref.abs().max())
    err = float((X - ref).abs().max())
    X_frames = fk.frames_rfft(frames)
    err_frames = float((X - X_frames).abs().max())
    same = bool(torch.equal(X, X_frames))
    ms = time_ms(lambda: fk.osa_rfft(osa))
    plain_ms = time_ms(lambda: fk.osa_rfft_plain(osa))
    library_ms = time_ms(lambda: torch.fft.rfft(osa, dim=-1))
    n_fft = 2 * P_SIZE
    bound_ms, bound_by = bound(C * K * n_fft * 4 + C * K * (P_SIZE + 1) * 8,
                               C * K * rfft_ops(P_SIZE))
    print(f"self-check path (osa_rfft -> irfft_valid), sum {total:.6e}: "
          f"osa_rfft max|diff| {err:.3e} vs torch.fft.rfft, {err_frames:.3e} "
          f"vs frames_rfft (tol {2e-5 * scale:.3e}; bit for bit {same})  "
          f"kernel {ms:.3f} ms  "
          f"plain {plain_ms:.3f} ms  library {library_ms:.3f} ms  bound "
          f"{bound_ms:.4f} ms ({bound_by}), launches {launches} (C={C} "
          f"K={K} p={P_SIZE}) [{card}]")
    check(err <= 2e-5 * scale and same
          and bool(torch.isfinite(X).all()) and math.isfinite(total),
          "osa_rfft agrees with torch.fft.rfft and equals frames_rfft")
    check(launches["osa_rfft"] == 1 and launches["irfft_valid"] == 1,
          "the self-check path launched osa_rfft and irfft_valid")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}, launches


def phase_layer_shapes(card):
    """7b: the three frame kernels of each type against their plain
    versions at the partition sizes of the oversampled lines (LAYER_SHAPES,
    C 8, K 64), at phase 3's and 3b's tolerances."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        names = fk.F64_KERNELS if f64 else fk.F32_KERNELS
        for p, P in LAYER_SHAPES:
            frames = torch.randn((8, 64, p), generator=gen, device=dev,
                                 dtype=dtype)
            H = torch.complex(
                torch.randn((P, p + 1), generator=gen, device=dev,
                            dtype=dtype),
                torch.randn((P, p + 1), generator=gen, device=dev,
                            dtype=dtype))
            X_plain = fk.frames_rfft_plain(frames)
            Y_plain = fk.causal_mac_plain(X_plain, H)
            y_plain = fk.irfft_valid_plain(Y_plain)
            errs = []
            for name, out, ref in (
                    (names[0], fk.frames_rfft(frames), X_plain),
                    (names[1], fk.causal_mac(X_plain, H), Y_plain),
                    (names[2], fk.irfft_valid(Y_plain), y_plain)):
                err = float((out - ref).abs().max())
                scale = float(ref.abs().max())
                if name.startswith("irfft_valid"):
                    scale = max(1.0, scale)
                tol = (1e-12 if f64 else 2e-5) * scale
                errs.append(f"{name} {err:.3e} (tol {tol:.3e})")
                check(err <= tol and bool(torch.isfinite(out).all()),
                      f"{name} disagrees with its plain version at p={p} "
                      f"P={P}")
            print(f"frame kernels at p={p} P={P} (C=8 K=64, "
                  f"{str(dtype)[6:]}): max|diff| {'; '.join(errs)} [{card}]")
            del frames, H, X_plain, Y_plain, y_plain


def phase_headline(card):
    t0 = time.perf_counter()
    chain32 = headline.headline_chain("cuda", torch.float32)
    chain64 = headline.headline_chain("cuda", torch.float64)
    plan = chain32.convolver.plans[0].layers[0]
    print(f"headline prepare (host fold, x2): {time.perf_counter() - t0:.2f}"
          f" s; combined IR {plan.length} taps, p={plan.part_size} "
          f"x{plan.num_parts} [{card}]")

    # (a) fidelity against the plain path in f64, counting launches
    x = headline.headline_input(4, 10.0, "cuda")
    dispatch.reset_launches()
    y32 = chain32(x)
    torch.cuda.synchronize()
    launches = dispatch.launches()
    with dispatch.plain():
        y64 = chain64(x.double())
    rel = float(((y32.double() - y64).pow(2).mean()
                 / y64.pow(2).mean()).sqrt())
    finite = bool(torch.isfinite(y32).all())
    print(f"headline 4x10s f32 kernels vs f64 plain: rel RMS {rel:.3e} "
          f"(tol 2e-5), finite {finite}, shape {tuple(y32.shape)}, "
          f"launches {launches} [{card}]")
    check(y32.shape == x.shape and finite, "headline output finite, shaped")
    check(rel <= 2e-5, "headline matches the f64 plain path")
    check(all(launches[n] > 0 for n in fk.F32_KERNELS),
          "every frame kernel launched on the headline path")
    del x, y32, y64, chain64

    # (b) throughput at 64 streams x 60 s
    batch, seconds = 64, 60.0
    x = headline.headline_input(batch, seconds, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = headline.measure(chain32, x, reps=3)
    peak = torch.cuda.max_memory_allocated()
    return report_rtf("headline", batch, seconds, walls, peak, card)


def report_rtf(name, batch, seconds, walls, peak, card, kind="f32"):
    """Prints the realtime factor of `walls` and returns it."""
    med = statistics.median(walls)
    print(f"{name} {batch}x{seconds:g}s {kind}: realtime factor "
          f"{batch * seconds / med:.1f} (median wall {med * 1e3:.2f} ms; "
          f"walls {[round(w * 1e3, 2) for w in walls]} ms; RTF spread "
          f"{batch * seconds / max(walls):.1f}.."
          f"{batch * seconds / min(walls):.1f}), peak device memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")
    return batch * seconds / med


def quantizer_ops(mode, order):
    """f32 operations a sample (every multiply, add, min, max and round)."""
    ops = 2 * order - 1                          # the feedback sum
    if mode == "psycho":
        return ops + 11
    ops += 14 + (2 if mode != "fixed" else 0)    # dither term, quantize
    if mode == "lattice":
        ops += 6 * order
    elif mode == "lattice_fir":
        ops += 2 * order + 4 * (order - 1)
    return ops


def quantizer_bound(R, N, mode, order, itemsize):
    """x, two uniforms and q a sample; the state in and out."""
    return bound(R * N * 4 * itemsize + 2 * R * order * itemsize,
                 R * N * quantizer_ops(mode, order))


def phase_quantizer(card):
    dev = torch.device("cuda")
    k9 = dither.lattice_coeffs(config6.config6_bank())
    sr = config6.SAMPLE_RATE
    coeffs = {"psycho": dither.psycho_coeffs(sr, 24),
              "fixed": dither.fixed4_coeffs(sr),
              "fixed15": dither.fixed15_coeffs(sr),
              "lattice": k9, "lattice_fir": k9}
    h = dither.K_OUTPUT_HEADROOM
    row = {}
    for dt in (torch.float32, torch.float64):
        bits = 24 if dt == torch.float32 else 16
        scale, _ = dither.quant_scales(bits)
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn((QR, QN), generator=gen, device=dev, dtype=dt) * 0.3
        u = torch.rand((QR, QN, 2), generator=gen, device=dev, dtype=dt)
        for mode, c in coeffs.items():
            s0 = (torch.rand((QR, len(c)), generator=gen, device=dev,
                             dtype=dt) * 2 - 1) * (2 * scale)
            q, s = qk.error_feedback_quantize(x, u, c, scale, h, mode, s0)
            torch.cuda.synchronize()
            qp, sp = qk.error_feedback_quantize_plain(x, u, c, scale, h,
                                                      mode, s0)
            err = float((q - qp).abs().max())
            serr = float((s - sp).abs().max())
            # a call split inside a tile, carrying the state, is the call
            q1, s1 = qk.error_feedback_quantize(x[:, :1000].contiguous(),
                                                u[:, :1000].contiguous(), c,
                                                scale, h, mode, s0)
            q2, s2 = qk.error_feedback_quantize(x[:, 1000:].contiguous(),
                                                u[:, 1000:].contiguous(), c,
                                                scale, h, mode, s1)
            split_eq = bool(torch.equal(torch.cat([q1, q2], dim=1), q)
                            and torch.equal(s2, s))
            print(f"quantizer {mode} {str(dt)[6:]} {bits}-bit R={QR} N={QN}: "
                  f"max|diff| {err:.3e}, state max|diff| {serr:.3e}, "
                  f"split call equal {split_eq} [{card}]")
            check(err == 0.0 and serr == 0.0 and torch.equal(q, qp)
                  and torch.equal(s, sp),
                  f"quantizer {mode} {dt} equals its plain version")
            check(split_eq, f"quantizer {mode} {dt} carries its state")
            if dt == torch.float32 and mode == "lattice_fir":
                ms = time_ms(lambda: qk.error_feedback_quantize(
                    x, u, c, scale, h, mode, s0))
                plain_ms = time_ms(lambda: qk.error_feedback_quantize_plain(
                    x, u, c, scale, h, mode, s0), reps=3)
                bound_ms, bound_by = quantizer_bound(QR, QN, mode, len(c), 4)
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None}
                print(f"quantizer lattice_fir f32 R={QR} N={QN}: kernel "
                      f"{ms:.3f} ms  plain {plain_ms:.1f} ms  bound "
                      f"{bound_ms:.4f} ms ({bound_by}) [{card}]")

    # ragged shapes, both types, every mode: rows whose spans are not
    # 16-B aligned (R = 37, N = 1001), fewer samples than a tile, and
    # every row one value past 16-B alignment (the copy warp's element
    # copies)
    for dt in (torch.float32, torch.float64):
        bits = 24 if dt == torch.float32 else 16
        scale, _ = dither.quant_scales(bits)
        gen = torch.Generator(device=dev).manual_seed(14)
        for R_, N_, off in ((37, 1001, 0), (37, 20, 0), (37, 1001, 1)):
            xb = torch.randn(R_ * N_ + off, generator=gen, device=dev,
                             dtype=dt) * 0.3
            ub = torch.rand(2 * (R_ * N_ + off), generator=gen, device=dev,
                            dtype=dt)
            x, u = xb[off:].view(R_, N_), ub[2 * off:].view(R_, N_, 2)
            for mode, c in coeffs.items():
                s0 = (torch.rand((R_, len(c)), generator=gen, device=dev,
                                 dtype=dt) * 2 - 1) * (2 * scale)
                q, s = qk.error_feedback_quantize(x, u, c, scale, h, mode, s0)
                qp, sp = qk.error_feedback_quantize_plain(x, u, c, scale, h,
                                                          mode, s0)
                check(torch.equal(q, qp) and torch.equal(s, sp),
                      f"quantizer {mode} {dt} R={R_} N={N_} offset {off} "
                      f"equals its plain version")
        print(f"quantizer {str(dt)[6:]} {bits}-bit, all five modes at R=37 "
              f"N=1001, N=20 and N=1001 one value past alignment: q and "
              f"state equal to the plain version bit for bit [{card}]")

    # the rint form: a scale that is not a power of two, and f32 at 32
    # bits (2^23 scale < 1: the modes that clamp q keep rint), with the
    # launches that took it counted
    gen = torch.Generator(device=dev).manual_seed(15)
    for dt, scale, want in (
            (torch.float32, 0.75 * 2.0 ** -23, set(coeffs)),
            (torch.float64, 0.75 * 2.0 ** -15, set(coeffs)),
            (torch.float32, 2.0 ** -31, set(qk.CLAMPS_Q))):
        x = torch.randn((37, 1001), generator=gen, device=dev, dtype=dt) * 0.3
        u = torch.rand((37, 1001, 2), generator=gen, device=dev, dtype=dt)
        for mode, c in coeffs.items():
            s0 = (torch.rand((37, len(c)), generator=gen, device=dev,
                             dtype=dt) * 2 - 1) * (2 * scale)
            dispatch.reset_launches()
            q, s = qk.error_feedback_quantize(x, u, c, scale, h, mode, s0)
            rint = qk.launch_counts["error_feedback_quantize_rint"]
            qp, sp = qk.error_feedback_quantize_plain(x, u, c, scale, h,
                                                      mode, s0)
            check(torch.equal(q, qp) and torch.equal(s, sp),
                  f"quantizer {mode} {dt} scale {scale!r} equals its plain "
                  f"version")
            check(rint == (mode in want), f"quantizer {mode} {dt} scale "
                  f"{scale!r}: {rint} rint launches")
    print(f"quantizer rint form (scale 0.75 x 2^-23 f32, 0.75 x 2^-15 f64, "
          f"2^-31 f32), all five modes at R=37 N=1001: q and state equal "
          f"to the plain version bit for bit, rint launches as chosen "
          f"[{card}]")

    # the f64 kernel against the reference binary (built -ffp-contract=off)
    v = json.loads((VECTORS / "shapers.json").read_text())
    pv = json.loads((VECTORS / "psycho.json").read_text())
    cases = []
    for ch, side in ((0, "l"), (1, "r")):
        n = len(v[f"input_{side}"])
        xo = dither.xoshiro_uniforms(2 * n, channel=ch).reshape(n, 2)
        seeds15 = dither.fixed15_xoshiro_seeds(v["sample_rate"], 16, ch)
        xf15 = dither.xoshiro_uniforms(2 * n, seeds=seeds15).reshape(n, 2)
        for bits in (16, 24):
            cases.append((f"fixed4_{bits}bit_{side}", v, side, xo,
                          dict(shaper_type=dither.FIXED4, bit_depth=bits)))
        cases.append((f"fixed15_16bit_{side}", v, side, xf15,
                      dict(shaper_type=dither.FIXED15, bit_depth=16)))
        cases.append((f"lattice_16bit_{side}", v, side, xo,
                      dict(shaper_type=dither.ADAPTIVE9, bit_depth=16,
                           adaptive_coeffs=[0.2, -0.15, 0.1, -0.08, 0.06,
                                            -0.04, 0.03, -0.02, 0.01],
                           lattice_ladder="reference")))
        up = dither.psycho_fallback_uniforms(2 * n, ch,
                                             pv["seed"]).reshape(n, 2)
        for khz, bits in ((48, 16), (48, 24), (384, 24)):
            cases.append((f"psycho_{khz}k_{bits}bit_{side}", pv, side, up,
                          dict(shaper_type=dither.PSYCHOACOUSTIC,
                               bit_depth=bits, sample_rate=khz * 1000.0)))
    for key, src, side, u, kw in cases:
        kw.setdefault("sample_rate", float(src.get("sample_rate", 48000)))
        x = torch.tensor(src[f"input_{side}"], dtype=torch.float64,
                         device=dev)
        q = dither.apply_dither(x, uniforms=torch.from_numpy(u).to(dev),
                                headroom=src["headroom"], **kw)
        got = q.cpu().numpy()
        check(np.array_equal(got, np.asarray(src[key])),
              f"f64 kernel reproduces the reference binary's {key}")
    print(f"quantizer f64 kernel: {len(cases)} reference-binary vectors of "
          f"2048 samples reproduced bit for bit [{card}]")

    # the kernel at config6's shape
    R, N = 2 * config6.BATCH, int(config6.SAMPLE_RATE * config6.SECONDS)
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((R, N), generator=gen, device=dev) * 0.1
    u = torch.rand((R, N, 2), generator=gen, device=dev)
    scale, _ = dither.quant_scales(config6.BIT_DEPTH)
    ms = time_ms(lambda: qk.error_feedback_quantize(
        x, u, k9, scale, h, "lattice_fir"), reps=5)
    b_ms, b_by = quantizer_bound(R, N, "lattice_fir", len(k9), 4)
    print(f"quantizer lattice_fir f32 at config6's shape R={R} N={N}: "
          f"{ms:.3f} ms ({R * N / ms / 1e6:.3f} G samples/s), bound "
          f"{b_ms:.3f} ms ({b_by}), {N / ms:.0f} steps/ms "
          f"[{card}]")
    # one warp instead of 16, and f64: what the loop over time costs
    ms_warp = time_ms(lambda: qk.error_feedback_quantize(
        x[:32], u[:32], k9, scale, h, "lattice_fir"), reps=3)
    x64, u64 = x.double(), u.double()
    ms_f64 = time_ms(lambda: qk.error_feedback_quantize(
        x64, u64, k9, scale, h, "lattice_fir"), reps=3)
    print(f"quantizer lattice_fir N={N}: f32 R=32 (one warp) {ms_warp:.3f} "
          f"ms, f64 R={R} {ms_f64:.3f} ms; {ms / N * 1e6:.1f} ns a step at "
          f"f32 R={R} [{card}]")
    step_ns = {mode: time_ms(lambda: qk.error_feedback_quantize(
        x, u, c, scale, h, mode), reps=3) / N * 1e6
        for mode, c in coeffs.items()}
    print(f"quantizer f32 R={R} N={N}, ns a step by mode: "
          f"{ {m: round(v, 1) for m, v in step_ns.items()} } [{card}]")
    # the SM clock while ~1 s of quantizer calls is queued on the card
    for _ in range(8):
        qk.error_feedback_quantize(x, u, k9, scale, h, "lattice_fir")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    print(f"SM clock during the quantizer (now, max): {clocks} [{card}]")
    mhz = float(clocks.split()[0])
    print(f"chain warp at config6's shape: {ms / N * mhz * 1e3:.1f} cycles "
          f"a step ({ms / N * 1e6:.1f} ns at {mhz:.0f} MHz); f32 R=32 "
          f"{ms_warp / N * mhz * 1e3:.1f}, f64 R={R} "
          f"{ms_f64 / N * mhz * 1e3:.1f} [{card}]")
    row.update(config6_ms=ms, config6_bound_ms=b_ms)
    return row


# soft clip check shapes (R, N, dtype): master384k_d24's call (256 stereo
# streams x 1.25 s at 384 kHz) and config6_f64's parity shape (4 stereo
# streams x 10 s)
SOFT_CLIP_SHAPES = [(512, 480_000, torch.float32),
                    (8, 3_840_000, torch.float64)]
# operations of one soft clip (ops/softclip.py `soft_clip`) where |v|
# passes the knee's start: |v|, the test, the sign (3); t and ks (8); the
# rational tanh's argument (4), numerator and denominator (11) and
# quotient (1); clipped (2), mixed (3), factor (5) and y (2)
CLIP_OPS = 39
# operations a sample of soft_clip_local2x: two 16-tap FIRs (a multiply
# and an add a tap), two clips, the scalings by 2 and 0.5 and the sum
SOFT_CLIP_OPS = 2 * 2 * 16 + 2 * CLIP_OPS + 4


def phase_soft_clip(card):
    """5b: the kernel against its plain version at SOFT_CLIP_SHAPES;
    returns the f32 row with the f64 row under "f64"."""
    dev = resolve_device("cuda")        # TF32 off for the plain version
    gen = torch.Generator(device=dev).manual_seed(21)
    params = sc.soft_clip_params(0.3)
    rows = {}
    for R, N, dt in SOFT_CLIP_SHAPES:
        x = torch.randn((R, N), generator=gen, device=dev, dtype=dt) * 0.4
        dispatch.reset_launches()
        y = sc.soft_clip_local2x(x, *params)
        torch.cuda.synchronize()
        check(sc.launch_counts["soft_clip_local2x"] == 1,
              f"soft clip {R}x{N}: one launch ({sc.launch_counts})")
        plain = sc.soft_clip_local2x_plain(x, *params)
        f32 = dt == torch.float32
        if f32:
            ref = sc.soft_clip_local2x_plain(x.double(), *params)
            err = parity.rel_rms(y, ref)
            err_plain = parity.rel_rms(plain, ref)
            del ref
            what = (f"rel RMS vs the plain version in f64 {err:.3e} (tol "
                    f"3e-7; the f32 plain version {err_plain:.3e})")
            ok = err <= 3e-7 and err_plain <= 3e-7
        else:
            err = float((y - plain).abs().max() / plain.abs().max())
            what = f"max|diff| / max|plain| {err:.3e} (tol 1e-12)"
            ok = err <= 1e-12
        finite = bool(torch.isfinite(y).all())
        del y, plain
        kernel_ms = time_ms(lambda: sc.soft_clip_local2x(x, *params))
        plain_ms = time_ms(lambda: sc.soft_clip_local2x_plain(x, *params),
                           reps=3)
        least, by = bound(2 * R * N * x.element_size(),
                          R * N * SOFT_CLIP_OPS,
                          F32_OPS_S if f32 else F64_OPS_S)
        name = str(dt)[6:]
        print(f"soft_clip_local2x {R}x{N} {name}: {what}, finite {finite}; "
              f"kernel {kernel_ms:.3f} ms, bound {least:.3f} ms ({by}; "
              f"{2 * R * N * x.element_size() / 1e9:.3f} GB, "
              f"{R * N * SOFT_CLIP_OPS / 1e9:.2f} GFLOP), "
              f"{100 * least / kernel_ms:.1f}% of it; plain (cuDNN conv1d "
              f"+ eager) {plain_ms:.3f} ms [{card}]")
        check(ok and finite, f"soft clip {R}x{N} {name} matches the plain "
              f"version")
        rows[name] = {"shape": [R, N], "error": err, "kernel_ms": kernel_ms,
                      "bound_ms": least, "bound_by": by,
                      "plain_ms": plain_ms}
        del x
        torch.cuda.empty_cache()
    return {**rows["float32"], "f64": rows["float64"]}


# IIR cascade check shapes (R, N, dtype, sample rate, cascades):
# app_48k_psycho's call (64 stereo streams x 60 s at 48 kHz: its two DC
# blockers and its output filter), master384k_d24's (256 stereo streams
# x 1.25 s at 384 kHz: its output DC blocker), config3_staged's at its
# processing rate (4 stereo streams x 10 s at 192 kHz: the 1 Hz DC
# blocker and the output filter) and an f64 one
IIR_SHAPES = [(128, 2_880_000, torch.float32, 48000.0,
               ("dc_block", "eq_last", "conv_last")),
              (512, 480_000, torch.float32, 384000.0, ("dc_block",)),
              (8, 1_920_000, torch.float32, 192000.0,
               ("dc_block_1hz", "conv_last")),
              (8, 2_880_000, torch.float64, 48000.0, ("eq_last",))]
IIR_CHECK_ROWS = 16             # rows held to the plain version in f64
# f64 operations a sample and section of one sequential pass: a TDF2
# biquad's 5 multiplies and adds (fused or not); the DC pair's 6
IIR_OPS = {"dc_block": 6, "biquad": 5}


# the DC blockers' cutoffs (Hz) by cascade name
IIR_DC_CUTOFFS = {"dc_block": 3.0, "dc_block_1hz": 1.0}


def iir_sections(name, sr):
    """The cascade `name` of IIR_SHAPES at sample rate sr."""
    if name in IIR_DC_CUTOFFS:
        alphas = dc_blocker_alphas(sr, IIR_DC_CUTOFFS[name])
        return (ic.dc_section(*alphas),)
    return output_filter_sections(sr, name == "conv_last")


def iir_call(name, x, sr):
    """The program's call of cascade `name`: `dc_block` or
    `output_filter_process`."""
    if name in IIR_DC_CUTOFFS:
        return dc_block(x, sr, IIR_DC_CUTOFFS[name])[0]
    return output_filter_process(x, sr, name == "conv_last")


def phase_iir_cascade(card):
    """5c: the kernel against its plain version and the FFT form at
    IIR_SHAPES; returns app's output-filter row, the other rows under
    their names."""
    dev = resolve_device("cuda")        # TF32 off for the plain version
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = {}
    for R, N, dt, sr, names in IIR_SHAPES:
        x = torch.randn((R, N), generator=gen, device=dev, dtype=dt) * 0.25
        f32 = dt == torch.float32
        for name in names:
            sections = iir_sections(name, sr)
            dispatch.reset_launches()
            y = iir_call(name, x, sr)
            torch.cuda.synchronize()
            check(ic.launch_counts["iir_cascade"] == 1,
                  f"iir {name} {R}x{N}: one launch ({ic.launch_counts})")
            xs = x[:IIR_CHECK_ROWS].double()
            yc = y[:IIR_CHECK_ROWS].double()
            ref, _ = ic.iir_cascade_plain(xs, sections)
            err = parity.rel_rms(yc, ref)
            del ref
            err_fft = parity.rel_rms(yc, ic.iir_cascade_fft(xs, sections))
            tol, tol_fft = (1e-6, 1e-6) if f32 else (1e-9, 1e-12)
            what = (f"rel RMS vs the plain version in f64 {err:.3e} (tol "
                    f"{tol:g}), vs the FFT form in f64 {err_fft:.3e} (tol "
                    f"{tol_fft:g}), {IIR_CHECK_ROWS} rows")
            ok = err <= tol and err_fft <= tol_fft
            finite = bool(torch.isfinite(y).all())
            del y, xs, yc
            kernel_ms = time_ms(lambda: iir_call(name, x, sr))
            plain_ms = time_ms(lambda: ic.iir_cascade_plain(x, sections),
                               reps=3)
            nbytes = 2 * R * N * x.element_size()
            ops = R * N * sum(IIR_OPS["dc_block" if s.kind == "dc"
                                      else "biquad"] for s in sections)
            least, by = bound(nbytes, ops, F64_OPS_S)
            label = f"{name}_{sr / 1000:g}k_{str(dt)[6:]}"
            print(f"iir_cascade {label} {R}x{N}: {what}, finite {finite}; "
                  f"kernel {kernel_ms:.3f} ms, bound {least:.3f} ms ({by}; "
                  f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP f64), "
                  f"{100 * least / kernel_ms:.1f}% of it; plain "
                  f"({len(sections)} section(s), GEMMs and scans) "
                  f"{plain_ms:.3f} ms [{card}]")
            check(ok and finite,
                  f"iir {label} matches the plain version and the FFT form")
            rows[label] = {"shape": [R, N], "error": err,
                           "error_fft": err_fft, "kernel_ms": kernel_ms,
                           "bound_ms": least, "bound_by": by,
                           "plain_ms": plain_ms}
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
    main = rows.pop("eq_last_48k_float32")
    return {**main, **rows}


def ladder_bound_lsb(k9):
    """|q - y h| in LSB for the fir ladder: |feedback| <= sum|k| times the
    state bound prod(1 + |k|) x 2 LSB, plus the rounding and the TPDF
    dither (< 1.5 LSB)."""
    k = np.abs(k9)
    return float(k.sum() * np.prod(1.0 + k) * 2.0 + 1.5)


def phase_config6(card):
    t0 = time.perf_counter()
    chain32 = config6.config6_chain("cuda", torch.float32)
    chain64 = config6.config6_chain("cuda", torch.float64)
    plan = chain32.convolver.plans[0].layers[0]
    k9 = config6.config6_bank()
    print(f"config6 prepare (host fold, x2): {time.perf_counter() - t0:.2f} "
          f"s; combined IR {plan.length} taps, p={plan.part_size} "
          f"x{plan.num_parts}; bank {np.round(k9, 6).tolist()} [{card}]")

    # (a) 4 streams: pre-quantizer fidelity, the dithered output, launches
    x = config6.config6_input(4, config6.SECONDS, "cuda")
    gen = torch.Generator(device=x.device).manual_seed(8)
    dispatch.reset_launches()
    y32 = chain32(x)
    q = config6.dither(y32, k9, gen)
    torch.cuda.synchronize()
    launches = dispatch.launches()
    with dispatch.plain():
        y64 = chain64(x.double())
    rel = float(((y32.double() - y64).pow(2).mean()
                 / y64.pow(2).mean()).sqrt())
    print(f"config6 pre-quantizer 4x{config6.SECONDS:g}s f32 kernels vs f64 "
          f"plain: rel RMS {rel:.3e} (tol 2e-5), shape {tuple(y32.shape)} "
          f"[{card}]")
    check(bool(torch.isfinite(y32).all()) and y32.shape == x.shape,
          "config6 pre-quantizer finite, shaped")
    check(rel <= 2e-5, "config6 pre-quantizer matches the f64 plain path")
    lsb = 2.0 ** (config6.BIT_DEPTH - 1)
    grid = q.double() * lsb
    dev_lsb = (q.double() - y32.double() * dither.K_OUTPUT_HEADROOM) * lsb
    lim = ladder_bound_lsb(dither.lattice_coeffs(k9))
    rms_lsb = float(dev_lsb.pow(2).mean().sqrt())
    max_lsb = float(dev_lsb.abs().max())
    print(f"config6 dithered output: RMS of q - y h {rms_lsb:.4f} LSB, max "
          f"{max_lsb:.4f} LSB (ladder bound {lim:.4f}), RMS of q "
          f"{float(grid.pow(2).mean().sqrt()):.1f} LSB, launches "
          f"{launches} [{card}]")
    check(bool(torch.isfinite(q).all()) and q.shape == x.shape,
          "config6 output finite, shaped")
    check(bool((grid == torch.round(grid)).all()), "output on the 24-bit grid")
    check(max_lsb <= lim, "output within the fir ladder's bound")
    check(all(launches[n] > 0 for n in [*fk.F32_KERNELS,
                                         "error_feedback_quantize"]),
          "every kernel of the config6 path launched")
    check(launches["error_feedback_quantize_rint"] == 0,
          "config6's quantizer rounds by the folded add pair")
    check(launches["soft_clip_local2x"] == 1,
          f"one soft clip launch in the config6 call ({launches})")
    del x, y32, y64, q, chain64, grid, dev_lsb

    # (b) 256 streams x 1.25 s
    batch = config6.BATCH
    x = config6.config6_input(batch, config6.SECONDS, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = config6.measure(chain32, x, k9, reps=3)
    peak = torch.cuda.max_memory_allocated()
    report_rtf("config6", batch, config6.SECONDS, walls, peak, card)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    y = chain32(x)
    ev[1].record()
    u = torch.rand(y.shape + (2,), generator=gen, dtype=y.dtype,
                   device=y.device)
    ev[2].record()
    dither.apply_dither(y, dither.ADAPTIVE9, config6.SAMPLE_RATE,
                        config6.BIT_DEPTH, uniforms=u, adaptive_coeffs=k9)
    ev[3].record()
    torch.cuda.synchronize()
    chain_ms, rng_ms, quant_ms = (ev[i].elapsed_time(ev[i + 1])
                                  for i in range(3))
    total = chain_ms + rng_ms + quant_ms
    print(f"config6 {batch}x{config6.SECONDS:g}s call split (CUDA events): "
          f"chain {chain_ms:.2f} ms, uniforms {rng_ms:.2f} ms, quantizer "
          f"{quant_ms:.2f} ms = {100 * quant_ms / total:.1f}% of "
          f"{total:.2f} ms [{card}]")
    return launches


def phase_fused_kernel(card):
    """The fused kernel against its plain version at FUSED_SHAPES; the
    row of the first shape (the prefilter's) goes into the JSON line."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for C_, K_, p, P in FUSED_SHAPES:
        frames = torch.randn((C_, K_, p), generator=gen, device=dev)
        H = torch.complex(
            torch.randn((P, p + 1), generator=gen, device=dev),
            torch.randn((P, p + 1), generator=gen, device=dev))
        ref = fc.fused_conv_plain(frames, H)
        out = fc.fused_conv(frames, H)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= 1e-4 * scale and bool(torch.isfinite(out).all()),
              f"fused_conv disagrees with its plain version at p={p} P={P}")
        osa = torch.cat([torch.cat([torch.zeros_like(frames[:, :1]),
                                    frames[:, :-1]], dim=1), frames], dim=-1)
        ms = time_ms(lambda: fc.fused_conv(frames, H))
        plain_ms = time_ms(lambda: fc.fused_conv_plain(frames, H))
        three_ms = time_ms(lambda: fk.irfft_valid(fk.causal_mac(
            fk.frames_rfft(frames), H)))
        library_ms = time_ms(lambda: torch.fft.irfft(
            torch.fft.rfft(osa, dim=-1), n=2 * p, dim=-1))
        ops = (C_ * K_ * 2 * rfft_ops(p)
               + 8 * (p + 1) * C_ * sum(min(k + 1, P) for k in range(K_)))
        bound_ms, bound_by = bound(2 * C_ * K_ * p * 4 + P * (p + 1) * 8, ops)
        print(f"fused_conv C={C_} K={K_} p={p} P={P}: max|diff| {err:.3e} "
              f"(tol {1e-4 * scale:.3e}, rel {err / scale:.3e})  kernel "
              f"{ms:.3f} ms  three frame kernels {three_ms:.3f} ms  plain "
              f"{plain_ms:.3f} ms  library rfft+irfft {library_ms:.3f} ms  "
              f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        passes = pass_times(card, lambda: fc.fused_conv(frames, H), frames,
                            ("fwd_packed_pass1", "fused_packed_rows",
                             "inv_packed_pass2"))
        rows.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms, "three_kernel_ms": three_ms,
                     "passes": passes})
        del frames, H, ref, out, osa
    return rows[0]


def fidelity(name, run32, run64, x, card, must_launch):
    """Runs run32(x) with the counts set to 0 just before and read just
    after, then run64(x in f64) on the plain path; checks the relative
    RMS, the shape, finiteness and that every kernel in `must_launch`
    was launched.  Returns the counts."""
    dispatch.reset_launches()
    y32 = run32(x)
    torch.cuda.synchronize()
    launches = dispatch.launches()
    with dispatch.plain():
        y64 = run64(x.double())
    rel = float(((y32.double() - y64).pow(2).mean()
                 / y64.pow(2).mean()).sqrt())
    finite = bool(torch.isfinite(y32).all())
    print(f"{name} {x.shape[0]}x{x.shape[-1] / 48000:g}s f32 kernels vs f64 "
          f"plain: rel RMS {rel:.3e} (tol 2e-5), finite {finite}, shape "
          f"{tuple(y32.shape)}, launches {launches} [{card}]")
    check(y32.shape == x.shape and finite, f"{name} output finite, shaped")
    check(rel <= 2e-5, f"{name} matches the f64 plain path")
    check(all(launches[n] > 0 for n in must_launch),
          f"{name}: every kernel of its path launched ({must_launch})")
    return launches


def phase_prefilter(card):
    t0 = time.perf_counter()
    chain32 = nuc3.prefilter_chain("cuda", torch.float32)
    chain64 = nuc3.prefilter_chain("cuda", torch.float64)
    layers = chain32.convolver.plans[0].layers
    plan = [(lp.part_size, lp.num_parts, round(lp.gain, 4)) for lp in layers]
    print(f"prefilter chain prepare (x2): {time.perf_counter() - t0:.2f} s; "
          f"prefilter {chain32.prefilter_part} x "
          f"{chain32.prefilter_spectra.shape[0]}; NUC {plan} [{card}]")
    x = headline.headline_input(4, 10.0, "cuda")
    launches = fidelity(
        "prefilter chain", chain32, chain64, x, card,
        ["fused_conv", "frames_rfft", "causal_mac", "irfft_valid"])
    del x, chain64

    batch, seconds = 64, 60.0
    x = headline.headline_input(batch, seconds, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = headline.measure(chain32, x, reps=3)
    peak = torch.cuda.max_memory_allocated()
    rtf = report_rtf("prefilter chain", batch, seconds, walls, peak, card)

    # device time of the prefilter pass and of each NUC layer (both
    # channels), each on the input it sees in the chain
    Hg, pg = chain32.prefilter_spectra, chain32.prefilter_part
    state = chain32.convolver.state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    xp = uniform_partitioned_conv(x, Hg, pg)
    ev[1].record()
    torch.cuda.synchronize()
    split = {f"prefilter {pg}x{Hg.shape[0]}": ev[0].elapsed_time(ev[1])}
    for li, lp in enumerate(layers):
        ev[0].record()
        for ch, side in enumerate((state.left, state.right)):
            uniform_partitioned_conv(xp[:, ch], side.layer_spectra[li],
                                     lp.part_size)
        ev[1].record()
        torch.cuda.synchronize()
        split[f"L{li} {lp.part_size}x{lp.num_parts}"] = \
            ev[0].elapsed_time(ev[1])
    print(f"prefilter chain {batch}x{seconds:g}s device ms by pass (CUDA "
          f"events): { {k: round(v, 3) for k, v in split.items()} }, sum "
          f"{sum(split.values()):.2f} ms [{card}]")
    # the prefilter's frames through the fused kernel and through the
    # three frame kernels, at this shape
    n = x.shape[-1]
    K_ = -(-n // pg)
    frames = torch.nn.functional.pad(x, (0, K_ * pg - n)).reshape(-1, K_, pg)
    fused_ms = time_ms(lambda: fc.fused_conv(frames, Hg), reps=3)
    three_ms = time_ms(lambda: fk.irfft_valid(fk.causal_mac(
        fk.frames_rfft(frames), Hg)), reps=3)
    print(f"prefilter pass C={frames.shape[0]} K={K_} p={pg} "
          f"P={Hg.shape[0]}: fused kernel {fused_ms:.3f} ms, three frame "
          f"kernels {three_ms:.3f} ms [{card}]")
    return launches, rtf


def phase_roomcorr(card):
    conv32 = nuc3.roomcorr_convolver("cuda", torch.float32)
    conv64 = nuc3.roomcorr_convolver("cuda", torch.float64)
    plan = conv32.plans[0]
    print(f"room-correction convolver: {plan.direct_taps} direct taps, "
          f"layers {[(lp.part_size, lp.num_parts) for lp in plan.layers]}, "
          f"mix {nuc3.ROOM_MIX} ramped from {nuc3.ROOM_MIX_FROM} over "
          f"{nuc3.ROOM_RAMP_SECONDS} s [{card}]")
    x = headline.headline_input(4, 10.0, "cuda")
    launches = fidelity(
        "room-correction convolver",
        lambda v: nuc3.roomcorr_process(conv32, v),
        lambda v: nuc3.roomcorr_process(conv64, v), x, card,
        ["fused_conv", "frames_rfft", "causal_mac", "irfft_valid"])
    del x, conv64
    batch, seconds = 256, 10.0
    x = headline.headline_input(batch, seconds, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = headline.measure(lambda v: nuc3.roomcorr_process(conv32, v), x,
                             reps=3)
    peak = torch.cuda.max_memory_allocated()
    report_rtf("room-correction convolver", batch, seconds, walls, peak, card)
    return launches


def phase_parity(card):
    """Phase 11: each f64 line of `parity.LINE_NAMES`; returns its counts
    by line."""
    by_path = {}
    for name in parity.LINE_NAMES:
        t0 = time.perf_counter()
        line = parity.make_line(name)
        prep = time.perf_counter() - t0
        x, u = parity.fidelity_signal(line)
        dispatch.reset_launches()
        y, q = line.run(x, u)
        torch.cuda.synchronize()
        launches = dispatch.launches()
        with dispatch.plain():
            y_ref, q_ref = line.run(x, u)
        out = line.compared(y, q)
        rel = parity.rel_rms(out, line.compared(y_ref, q_ref))
        finite = bool(torch.isfinite(out).all())
        what = "dithered output" if line.dithered_fidelity else "chain output"
        print(f"{name} {x.shape[0]}x{line.fid[1]:g}s f64 kernels vs f64 "
              f"plain ({what}): rel RMS {rel:.3e} (tol {line.limit or 'reported'}), "
              f"finite {finite}, shape {tuple(out.shape)}, prepare "
              f"{prep:.2f} s, launches {launches} [{card}]")
        check(out.shape == x.shape and finite, f"{name} output finite, shaped")
        if line.limit is not None:
            check(rel <= line.limit, f"{name} matches the f64 plain path")
        check(all(launches[n] > 0 for n in fk.F64_KERNELS),
              f"{name}: every f64 frame kernel launched")
        check(all(launches[n] == 0 for n in [*fk.F32_KERNELS, "fused_conv"]),
              f"{name}: no f32 frame kernel and no fused kernel launched")
        if q is not None:
            check(launches["error_feedback_quantize"] > 0,
                  f"{name}: the quantizer launched")
            lsb = 2.0 ** (line.bits - 1)
            grid = q * lsb
            # the quantizer clamps to full scale [-1, 1 - 1 LSB]: the
            # ladder bounds q against y h clamped the same way
            yh = y * dither.K_OUTPUT_HEADROOM
            clipped = float(((yh < -1.0) | (yh > 1.0 - 1.0 / lsb)).double()
                            .mean())
            dev_lsb = (q - yh.clamp(-1.0, 1.0 - 1.0 / lsb)) * lsb
            lim = ladder_bound_lsb(dither.lattice_coeffs(line.k9))
            max_lsb = float(dev_lsb.abs().max())
            print(f"{name} dithered output ({line.bits} bits): RMS of q - y h "
                  f"{float(dev_lsb.pow(2).mean().sqrt()):.4f} LSB, max "
                  f"{max_lsb:.4f} LSB (ladder bound {lim:.4f}; y h past "
                  f"full scale in {100 * clipped:.4f}% of samples) [{card}]")
            check(bool(torch.isfinite(q).all())
                  and bool((grid == torch.round(grid)).all()),
                  f"{name}: dithered output on the {line.bits}-bit grid")
            check(max_lsb <= lim, f"{name}: within the fir ladder's bound")
        by_path[name] = launches
        del x, u, y, q, y_ref, q_ref, out
        xt = parity.timed_signal(line)
        row = parity.measure_rtf(line, xt)
        report_rtf(name, xt.shape[0], line.rtf[1], row["walls_s"],
                   row["peak_gib"] * 2 ** 30, card, "f64")
        del line, xt
        torch.cuda.empty_cache()
    return by_path


def staged_must_launch(line):
    """The kernels a staged f32 line's plan routes to: the fused kernel
    for the blocked EQ (eq20 at 48 kHz: p = 2048, P = 4) and for each
    layer of <= 8 partitions, the three f32 frame kernels for any other
    layer."""
    names = set()
    if line.chain.eq_params is not None and not line.chain.cfg.eq_bypassed:
        names.add("fused_conv")
    if line.chain.convolver is not None:
        for lp in line.chain.convolver.plans[0].layers:
            names |= ({"fused_conv"} if fc.fused_conv_supported(
                lp.part_size, lp.num_parts) else set(fk.F32_KERNELS))
    return sorted(names)


def check_staged_line(line, twin, card):
    """12a-b for one staged line: `line` in f32 through the kernels and
    its f64 `twin` through the f64 kernels, each at staged.FIDELITY_SHAPE
    against the twin's f64 plain path; returns both runs' counts."""
    batch, seconds = staged.FIDELITY_SHAPE
    must = staged_must_launch(line)
    # (a) f32 through the kernels against the f64 plain path
    x = staged.signal(batch, seconds, "cuda")
    y, rel, launches = staged.fidelity(line, twin, x)
    finite = bool(torch.isfinite(y).all())
    print(f"{line.name} {batch}x{seconds:g}s f32 kernels vs f64 plain: rel "
          f"RMS {rel:.3e} (tol {line.limit:g}), finite {finite}, shape "
          f"{tuple(y.shape)}, launches {launches} (must: {must}) "
          f"[{card}]")
    check(y.shape == x.shape and finite, f"{line.name} output finite, shaped")
    check(rel <= line.limit, f"{line.name} matches the f64 plain path")
    check(all(launches[n] > 0 for n in must),
          f"{line.name}: every kernel of its plan launched ({must})")
    # (b) the f64 twin through the f64 kernels against the same
    y64, rel64, launches64 = staged.fidelity(twin, twin, x.double())
    finite = bool(torch.isfinite(y64).all())
    floor = staged.ulp_floor(twin, x)
    print(f"{twin.name} {batch}x{seconds:g}s f64 kernels vs f64 plain: "
          f"rel RMS {rel64:.3e} (tol {twin.limit:g}; the plain path "
          f"moves {floor:.3e} under a 1-ulp input change), finite "
          f"{finite}, launches {launches64} [{card}]")
    check(y64.shape == x.shape and finite,
          f"{twin.name} output finite, shaped")
    check(rel64 <= twin.limit, f"{twin.name} matches the f64 plain path")
    check(all(launches64[n] == 0 for n in [*fk.F32_KERNELS, "fused_conv"]),
          f"{twin.name}: no f32 frame kernel and no fused kernel")
    if twin.chain.convolver is not None:
        check(all(launches64[n] > 0 for n in fk.F64_KERNELS),
              f"{twin.name}: every f64 frame kernel launched")
    return launches, launches64


def staged_rtf(line, card):
    """12d for one line: its realtime factor, spread and peak memory at
    staged.RTF_SHAPE."""
    batch, seconds = staged.RTF_SHAPE
    xt = staged.signal(batch, seconds, "cuda", line.dtype)
    row = staged.measure_rtf(line, xt)
    report_rtf(line.name, batch, seconds, row["walls_s"],
               row["peak_gib"] * 2 ** 30, card,
               "f64" if line.dtype == torch.float64 else "f32")
    del xt
    torch.cuda.empty_cache()
    return row


def phase_staged(card):
    """Phase 12: the staged lines, f32 and their f64 twins; returns the
    counts by line."""
    t0 = time.perf_counter()
    lines32 = staged.staged_lines("cuda", torch.float32)
    lines64 = staged.staged_lines("cuda", torch.float64)
    plans = {name: [(lp.part_size, lp.num_parts)
                    for lp in line.chain.convolver.plans[0].layers]
             for name, line in lines32.items() if line.chain.convolver}
    print(f"staged lines prepare (f32, f64): {time.perf_counter() - t0:.2f} "
          f"s; convolver layers {plans} [{card}]")
    by_path = {}
    for name in staged.LINE_NAMES:
        twin = lines64[name + "_f64"]
        by_path[name], by_path[twin.name] = check_staged_line(
            lines32[name], twin, card)
    phase_staged_cascade(card)
    # (d) throughput of the eight lines
    for line in [*lines32.values(), *lines64.values()]:
        staged_rtf(line, card)
    return by_path


CASCADE_N = 187 * 512          # ~2 s at 48 kHz in whole AGC blocks


def cascade_params(structure):
    """eq20 with saturation 0.3 and the AGC on; band 5 in mid, band 12 in
    side, band 16 left only."""
    p = staged.eq20()
    p.saturation = 0.3
    p.agc_enabled = True
    p.structure = structure
    p.set_band(5, mode=eq_model.MID)
    p.set_band(12, mode=eq_model.SIDE)
    p.set_band(16, mode=eq_model.LEFT)
    return p


def phase_staged_cascade(card):
    """12c: the band cascade (saturated bands, AGC) on the card, f32
    against f64, with the device time of the call and of the AGC."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((4, 2, CASCADE_N), generator=gen, device=dev) * 0.25
    sr = staged.SAMPLE_RATE
    for structure, tag in ((eq_model.SERIAL, "serial"),
                           (eq_model.PARALLEL, "parallel")):
        p = cascade_params(structure)
        y32 = eq_model.eq_process(x, p, sr)
        y64 = eq_model.eq_process(x.double(), p, sr)
        rel = parity.rel_rms(y32, y64)
        finite = bool(torch.isfinite(y32).all())
        ms = time_ms(lambda: eq_model.eq_process(x, p, sr), reps=3)
        bands = eq_model.eq_process_bands(x, p, sr)
        agc_ms = time_ms(lambda: eq_model.agc_apply(x, bands, sr, 512),
                         reps=3)
        print(f"EQ cascade ({tag}, saturation 0.3, AGC, mid/side/left bands)"
              f" 4x{CASCADE_N} f32 vs f64: rel RMS {rel:.3e} (tol 1e-05), "
              f"finite {finite}; eq_process {ms:.2f} ms a call, of it the "
              f"AGC ({CASCADE_N // 512} blocks) {agc_ms:.2f} ms (CUDA "
              f"events, median of 3) [{card}]")
        check(finite and y32.shape == x.shape, f"EQ cascade {tag} finite")
        check(rel <= 1e-5, f"EQ cascade {tag} f32 matches f64")


CASCADE_SHAPE = (64, 20.0)     # streams, seconds of 48 kHz input


def phase_cascade(card):
    """13a: the halfband cascades alone, r2, r4 and r8 up -> down in f32
    and f64 on the card: the f32 output against the f64 one (the same
    function on the card, limit 1e-5: tests/test_precision.py:142-144),
    each direction's device time (CUDA events, median of 3) and the round
    trip's DC gain (0.75 at r2, the reference's quirk)."""
    batch, seconds = CASCADE_SHAPE
    x = staged.signal(batch, seconds, "cuda")
    for ratio in (2, 4, 8):
        st = oversample.make_stages(ratio)
        up = lambda v: oversample.oversample_up(v, st)
        rt = lambda v: oversample.oversample_down(up(v), st)
        y32 = rt(x)
        y64 = rt(x.double())
        rel = parity.rel_rms(y32, y64)
        finite = bool(torch.isfinite(y32).all())
        del y32, y64
        ms = {}
        for dt in (torch.float32, torch.float64):
            xd = x.to(dt)
            u = up(xd)
            tag = "f64" if dt == torch.float64 else "f32"
            ms[f"up_{tag}"] = time_ms(lambda: up(xd), reps=3)
            ms[f"down_{tag}"] = time_ms(
                lambda: oversample.oversample_down(u, st), reps=3)
            del xd, u
        one = torch.ones((1, 4096), dtype=torch.float64, device="cuda")
        dc = float(rt(one)[0, -256:].mean())
        print(f"oversampling r{ratio} ({[s_.taps for s_ in st]} taps) "
              f"{batch}x{seconds:g}s up -> down: f32 vs f64 rel RMS "
              f"{rel:.3e} (tol 1e-05), finite {finite}; device ms "
              f"{ {k: round(v, 3) for k, v in ms.items()} }; round-trip DC "
              f"gain {dc:.6f} [{card}]")
        check(finite and rel <= 1e-5, f"r{ratio} cascade f32 matches f64")
        if ratio == 2:
            check(abs(dc - 0.75) <= 1e-6, "r2 round trip DC gain 0.75")
        torch.cuda.empty_cache()
    del x


def mac_at_shape(card, C_, K_, p, P, dtype):
    """The MAC of `dtype` at one path's shape against its plain version:
    times (CUDA events, median of 7) beside the library call's, and the
    bound by bytes and by operations; returns the row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    B = p + 1
    X = torch.complex(*(torch.randn((C_, K_, B), generator=gen, device=dev,
                                    dtype=dtype) for _ in range(2)))
    H = torch.complex(*(torch.randn((P, B), generator=gen, device=dev,
                                    dtype=dtype) for _ in range(2)))
    f64 = dtype == torch.float64
    ref = fk.causal_mac_plain(X, H)
    out = fk.causal_mac(X, H)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= (1e-12 if f64 else 2e-5) * scale,
          "causal_mac at config3's shape disagrees with its plain version")
    item = X.real.element_size()
    nbytes = 2 * C_ * K_ * B * 2 * item + P * B * 2 * item
    ops = 8 * B * C_ * sum(min(k + 1, P) for k in range(K_))
    rate = F64_OPS_S if f64 else F32_OPS_S
    row = {"shape": [C_, K_, p, P], "max_abs_err": err,
           "ms": time_ms(lambda: fk.causal_mac(X, H)),
           "plain_ms": time_ms(lambda: fk.causal_mac_plain(X, H), reps=3),
           "library_ms": time_ms(lambda: mac_library(X, H), reps=3),
           "bytes_ms": nbytes / MEM_BYTES_S * 1e3,
           "operations_ms": ops / rate * 1e3}
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, rate)
    name = "causal_mac_c128" if f64 else "causal_mac"
    print(f"{name} at config3's shape (C={C_} K={K_} p={p} P={P}): max|diff| "
          f"{err:.3e} (rel {err / scale:.3e}); kernel {row['ms']:.3f} ms, "
          f"plain {row['plain_ms']:.3f}, library {row['library_ms']:.3f}, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
          f"{row['bytes_ms']:.4f}, operations {row['operations_ms']:.4f}) "
          f"[{card}]")
    return row


def phase_config3(card):
    """13b: bench config3 in both orders through `config3.py`'s lines, in
    f32 (rows 1-3 launched) and f64 (rows 6-8 only), against the f64
    plain path (2e-5, 1e-12), with RTF, spread and peak memory at 64 x
    20 s, and the MAC at config3's shape; 13c: the fold against the
    staged chain in f64 on the card (the staged NUC unfiltered, the fold
    without the HC/LC curve, 4 x 10 s, both orders, < 3e-9).  Returns
    the counts by line and the MAC rows."""
    t0 = time.perf_counter()
    setup = staged.config3_setup()
    t_setup = time.perf_counter() - t0
    lines32 = config3.config3_lines("cuda", torch.float32, setup)
    lines64 = config3.config3_lines("cuda", torch.float64, setup)
    pin = setup.planner_input
    print(f"config3 set-up: {t_setup:.2f} s (IR {setup.ir.shape} -> "
          f"{setup.ir_hf.shape} at 192 kHz, planner input "
          f"{pin.eq_max_gain_db:.3f} dB / Q {pin.eq_max_q} / "
          f"{pin.ir_freq_peak_gain_db:.3f} dB); folds (x4) "
          f"{time.perf_counter() - t0 - t_setup:.2f} s; "
          f"{ {n: l.info for n, l in lines32.items()} } [{card}]")
    by_path = {}
    batch, seconds = staged.FIDELITY_SHAPE
    for line in [*lines32.values(), *lines64.values()]:
        f64 = line.dtype == torch.float64
        reference = lines64[line.name.removesuffix("_f64") + "_f64"]
        x = staged.signal(batch, seconds, "cuda", line.dtype)
        y, rel, launches = staged.fidelity(line, reference, x)
        finite = bool(torch.isfinite(y).all())
        print(f"{line.name} {batch}x{seconds:g}s {'f64' if f64 else 'f32'} "
              f"kernels vs f64 plain: rel RMS {rel:.3e} (tol {line.limit:g}),"
              f" finite {finite}, shape {tuple(y.shape)}, launches "
              f"{launches} [{card}]")
        check(y.shape == x.shape and finite, f"{line.name} output finite")
        check(rel <= line.limit, f"{line.name} matches the f64 plain path")
        own, other = ((fk.F64_KERNELS, [*fk.F32_KERNELS, "fused_conv"])
                      if f64 else (fk.F32_KERNELS, fk.F64_KERNELS))
        check(all(launches[n] > 0 for n in own)
              and all(launches[n] == 0 for n in other),
              f"{line.name}: its frame kernels launched, no others")
        by_path[line.name] = launches
        del x, y
    # 13c: the fold against the staged chain, f64 on the card
    x = staged.signal(batch, seconds, "cuda", torch.float64)
    conv = stereo_prepare(torch.as_tensor(setup.ir_hf), 2048,
                          FilterSpec(staged.CONFIG3_RATE),
                          apply_spectrum_filter=False, device="cuda")
    for name, (order, tag) in config3.ORDERS.items():
        cfg, _g = staged.config3_config(order, pin)
        state = prepare_folded_convolver_oversampled(
            setup.ir_hf, config3.BLOCK_SIZE,
            FilterSpec(staged.CONFIG3_RATE), cfg, staged.eq20(), dtype=torch.float64,
            fold_spectrum_curve=False, device="cuda")
        y_fold = process_chain_fused(x, cfg, state)
        y_staged = process_chain(x, cfg, staged.eq20(), conv)
        rel = parity.rel_rms(y_fold, y_staged)
        print(f"config3 {tag} fold vs staged chain (f64, NUC unfiltered, no"
              f" HC/LC curve) {batch}x{seconds:g}s: rel RMS {rel:.3e} (tol "
              f"3e-09) [{card}]")
        check(rel < 3e-9, f"config3 {tag}: the fold matches the staged chain")
        del state, y_fold, y_staged
    del x, conv
    # RTF of the four lines
    for line in [*lines32.values(), *lines64.values()]:
        staged_rtf(line, card)
    # the MAC at config3's shape: 64 streams x 20 s, p 8192, P 43
    lp = next(iter(lines32.values())).chain.convolver.plans[0].layers[0]
    K_ = -(-int(staged.RTF_SHAPE[1] * staged.SAMPLE_RATE) // lp.part_size)
    mac_rows = {
        "causal_mac": mac_at_shape(card, 2 * staged.RTF_SHAPE[0], K_,
                                   lp.part_size, lp.num_parts,
                                   torch.float32),
        "causal_mac_c128": mac_at_shape(card, 2 * staged.RTF_SHAPE[0], K_,
                                        lp.part_size, lp.num_parts,
                                        torch.float64)}
    return by_path, mac_rows


def phase_config3_staged(card):
    """13d: config3_staged and its f64 twin through `staged.py`'s line
    (12a-b's checks, then the RTF), and the plain soft clip at 4x: 4 x
    2 s with soft_clip_enabled, saturation 0.3, f32 through the kernels
    against the f64 plain path, the line's f32 limit."""
    t0 = time.perf_counter()
    line = staged.os_lines("cuda", torch.float32)["config3_staged"]
    twin = staged.os_lines("cuda", torch.float64)["config3_staged_f64"]
    print(f"config3_staged prepare (f32, f64): {time.perf_counter() - t0:.2f}"
          f" s; {line.info} [{card}]")
    by_path = {}
    by_path[line.name], by_path[twin.name] = check_staged_line(line, twin,
                                                               card)
    cfg = dataclasses.replace(line.chain.cfg, soft_clip_enabled=True,
                              saturation_amount=0.3)
    clip32 = StagedChain(cfg, line.chain.eq_params, line.chain.convolver.state)
    clip64 = StagedChain(cfg, twin.chain.eq_params, twin.chain.convolver.state)
    x = staged.signal(4, 2.0, "cuda")
    dispatch.reset_launches()
    y = clip32(x)
    torch.cuda.synchronize()
    launches = dispatch.launches()
    with dispatch.plain():
        rel = parity.rel_rms(y, clip64(x.double()))
    finite = bool(torch.isfinite(y).all())
    print(f"config3_staged with the soft clip at 4x (saturation 0.3) 4x2s "
          f"f32 kernels vs f64 plain: rel RMS {rel:.3e} (tol "
          f"{line.limit:g}), finite {finite}, launches {launches} [{card}]")
    check(finite and y.shape == x.shape and rel <= line.limit,
          "config3_staged with the soft clip matches the f64 plain path")
    del x, y, clip32, clip64
    for ln in (line, twin):
        staged_rtf(ln, card)
    return by_path

FOLDED_TIERS = ("folded", "folded_f16", "bigblock_M16", "bigblock_M16_f16",
                "folded_f64", "bigblock_M16_f64")
# 14c: (tier, stream counts), 400 blocks a point (the staged tier, four
# times over its budget a block, 50)
SERVING_POINTS = (("folded", (1, 32, 256, 1024)),
                  ("folded_f16", (256, 1024)),
                  ("bigblock_M16", (256, 1024)),
                  ("bigblock_M16_f16", (256, 1024)),
                  ("folded_f64", (1, 256, 1024)),
                  ("staged", (1, 32)))
SERVING_BLOCKS = 400
STAGED_BLOCKS = 50
STAGED_SECONDS = 2.5            # 14b: 1 stream, at each of its three runs
SERVING_PARTS = (512, 4096, 32768, 8192)   # 14d: the layers' partitions
SERVING_C = 512


def serving_launch_check(name, launches, dtype):
    """A serving run of `dtype` launched its forward and inverse frame
    kernels and no kernel of the other type (nor the fused kernel)."""
    if dtype == torch.float64:
        own = ("frames_rfft_f64", "irfft_valid_f64")
        other = (*fk.F32_KERNELS, "osa_rfft", "fused_conv")
    else:
        own = ("osa_rfft", "irfft_valid")
        other = (*fk.F64_KERNELS, "fused_conv")
    check(all(launches[n] > 0 for n in own)
          and all(launches[n] == 0 for n in other),
          f"{name}: launched {own}, none of {other} ({launches})")


def phase_serving_fidelity(card, fixture, cache):
    """14a: each folded tier against the f64 offline folded chain on the
    plain path; returns the f32 and f64 3-layer tiers' counts."""
    counts = {}
    t0 = time.perf_counter()
    dispatch.reset_launches()
    for row in serve.fidelity(FOLDED_TIERS, 10.0, "cuda", fixture, cache):
        launches = {**dispatch.launches(), **row["launches"]}
        _, dtype, fdl, _ = serve.TIERS[row["tier"]]
        print(f"serve {row['tier']} 1x{row['seconds']:g}s streamed vs the "
              f"f64 offline folded chain (plain path), past "
              f"{row['skip_s']:.3f} s: rel RMS {row['rel_rms']:.3e} (tol "
              f"{row['limit']:g}), finite {row['finite']}, layers "
              f"{row['layers']}, launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]")
        check(row["finite"] and row["rel_rms"] <= row["limit"],
              f"serve {row['tier']} matches the f64 offline folded chain")
        serving_launch_check(f"serve {row['tier']}", launches, dtype)
        counts[row["tier"]] = launches
    print(f"14a: {time.perf_counter() - t0:.1f} s [{card}]")
    return counts["folded"], counts["folded_f64"]


def phase_serving_staged(card, fixture):
    """14b: the staged step against the offline process_chain in f64 on
    the plain path: 1x f32 (2e-3) and f64 (1e-9), 4x with the soft clip
    in f64 (1e-7), 1 stream x STAGED_SECONDS each (L2 of the 1M-tap NUC,
    at 5.58 s, is heard in 14a's folded runs).  Returns the 1x f32 run's
    counts."""
    t0 = time.perf_counter()
    counts = None
    for dtype, os_factor, seconds, clip, limit in (
            (torch.float32, 1, STAGED_SECONDS, False, 2e-3),
            (torch.float64, 1, STAGED_SECONDS, False, 1e-9),
            (torch.float64, 4, STAGED_SECONDS, True, 1e-7)):
        dispatch.reset_launches()
        row, fk_counts = serve.staged_fidelity(dtype, os_factor, seconds,
                                               "cuda", fixture, clip)
        launches = {**dispatch.launches(), **fk_counts}
        print(f"serve staged step {row['dtype']} at {os_factor}x (soft clip "
              f"{clip}) 1x{row['seconds']:g}s vs offline process_chain f64 "
              f"plain: rel RMS {row['rel_rms']:.3e} (tol {limit:g}), finite "
              f"{row['finite']}, layers {row['layers']}, launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]")
        check(row["finite"] and row["rel_rms"] <= limit,
              f"the staged step at {os_factor}x {row['dtype']} matches the "
              "offline chain")
        serving_launch_check(f"staged step {row['dtype']} {os_factor}x",
                             launches, dtype)
        if counts is None:
            counts = launches
        torch.cuda.empty_cache()
    print(f"14b: {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


def phase_serving_points(card, fixture, cache):
    """14c: the per-block serving points (`serve.measure_point`, profiled
    over one window)."""
    t0 = time.perf_counter()
    rows = []
    for tier, streams in SERVING_POINTS:
        chain = cache.pop(tier, None) or serve.build_chain(
            tier, "cuda", fixture)
        blocks = STAGED_BLOCKS if tier == "staged" else SERVING_BLOCKS
        for ns in streams:
            row = serve.measure_point(chain, ns, blocks, profile=True,
                                      tier=tier)
            print(json.dumps({"serving_point": row, "card": card}))
            check(row["finite"], f"serve {tier} x{ns} output finite")
            rows.append(row)
        del chain
        torch.cuda.empty_cache()
    print(f"14c: {time.perf_counter() - t0:.1f} s [{card}]")
    return rows


def phase_serving_kernels(card):
    """14d: the forward and inverse frame kernels at the serving shapes
    (C = 512 frames, K = 1; the f64 forward on the stacked pair, K = 2, as
    the f64 step runs it, beside the bound and cuFFT's time of the one
    frame it keeps) against their plain versions, each beside cuFFT's
    time for the same transform (torch.fft, CUDA events, median of 7) and
    its bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        rate = F64_OPS_S if f64 else F32_OPS_S
        item = 8 if f64 else 4
        for p in SERVING_PARTS:
            k_fwd = 2 if f64 else 1
            x = torch.randn((SERVING_C, k_fwd, p), generator=gen,
                            device=dev, dtype=dtype)
            osa = torch.randn((SERVING_C, 1, 2 * p), generator=gen,
                              device=dev, dtype=dtype)
            if f64:
                # the stacked (prev, cur) pair: frames [0 | prev] and
                # [prev | cur]; cuFFT takes them built
                fwd_name = "frames_rfft_f64"
                fwd = lambda: fk.frames_rfft(x)
                ref_fwd = fk.frames_rfft_plain(x)
                osa = torch.cat([torch.cat([torch.zeros_like(x[:, :1]),
                                            x[:, :1]], dim=1), x], dim=-1)
                frames_n, in_vals = SERVING_C * k_fwd, p
            else:
                fwd_name = "osa_rfft"
                fwd = lambda: fk.osa_rfft(osa)
                ref_fwd = fk.osa_rfft_plain(osa)
                frames_n, in_vals = SERVING_C, 2 * p
            lib_fwd = lambda: torch.fft.rfft(osa, dim=-1)
            Y = ref_fwd[:, -1:].contiguous()
            inv_name = "irfft_valid_f64" if f64 else "irfft_valid"
            inv = lambda: fk.irfft_valid(Y)
            ref_inv = fk.irfft_valid_plain(Y)
            lib_inv = lambda: torch.fft.irfft(Y, n=2 * p, dim=-1)
            spec_b = (p + 1) * 2 * item
            for name, kern, ref, lib, nbytes, n_fr in (
                    (fwd_name, fwd, ref_fwd, lib_fwd,
                     frames_n * (in_vals * item + spec_b), frames_n),
                    (inv_name, inv, ref_inv, lib_inv,
                     SERVING_C * (spec_b + p * item), SERVING_C)):
                got = kern()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                tol = (1e-12 if f64 else 2e-5) * scale
                check(err <= tol and bool(torch.isfinite(got).all()),
                      f"{name} at the serving shape p={p} disagrees")
                b_ms, b_by = bound(nbytes, n_fr * rfft_ops(p), rate)
                row = {"p": p, "C": SERVING_C, "K": n_fr // SERVING_C,
                       "max_abs_err": err, "ms": time_ms(kern),
                       "library_ms": time_ms(lib), "bound_ms": b_ms,
                       "bound_by": b_by}
                one = ""
                if name == "frames_rfft_f64":
                    # the step keeps only the pair's second frame: the
                    # bound and cuFFT's time of that one frame a channel
                    osa1 = osa[:, 1:].contiguous()
                    row["bound_ms_one_frame"], row["bound_by_one_frame"] = \
                        bound(SERVING_C * (2 * p * item + spec_b),
                              SERVING_C * rfft_ops(p), rate)
                    row["library_ms_one_frame"] = time_ms(
                        lambda: torch.fft.rfft(osa1, dim=-1))
                    one = (f"; the one frame the step keeps: cuFFT "
                           f"{row['library_ms_one_frame']:.4f} ms, bound "
                           f"{row['bound_ms_one_frame']:.4f} ms "
                           f"({row['bound_by_one_frame']})")
                print(f"{name} at the serving shape (C={SERVING_C} "
                      f"K={row['K']} p={p}): max|diff| {err:.3e} (tol "
                      f"{tol:.3e}); kernel {row['ms']:.4f} ms, cuFFT "
                      f"{row['library_ms']:.4f} ms, bound "
                      f"{b_ms:.4f} ms ({b_by}){one} [{card}]")
                out.setdefault(name, []).append(row)
            del x, osa, Y
    return out


def phase_serving(card):
    """Phase 14: the serving runtime (`serve.py`, `runtime/streaming.py`);
    returns (counts by serving path, 14d's rows by kernel)."""
    t0 = time.perf_counter()
    fixture = serve.serving_fixture()
    cache = {}
    by_path = {}
    by_path["serve_folded"], by_path["serve_folded_f64"] = \
        phase_serving_fidelity(card, fixture, cache)
    by_path["serve_staged"] = phase_serving_staged(card, fixture)
    phase_serving_points(card, fixture, cache)
    cache.clear()
    torch.cuda.empty_cache()
    shapes = phase_serving_kernels(card)
    print(f"phase 14 (serving): {time.perf_counter() - t0:.1f} s [{card}]")
    return by_path, shapes


# ------------------------------------------------------------ phase 15
APP_FIDELITY = (4, 10.0)        # streams, seconds
APP_RTF = (64, 20.0)
APP_STREAM_BLOCKS = 400
APP_CLI_SECONDS = 30.0
APP_LIMITS = {torch.float32: 2e-3, torch.float64: 1e-12}
APP_KERNELS = {torch.float32: (*fk.F32_KERNELS, "fused_conv",
                               "error_feedback_quantize"),
               torch.float64: (*fk.F64_KERNELS, "error_feedback_quantize")}


def app_engine(ir_path, dtype, cache_dir, phase=engine_mod.PHASE_AS_IS):
    """The README's Quick start at the headline's size: the 1M-tap stereo
    IR loaded by path (target its length), eq20, EQ -> conv, soft clip
    0.3, auto gain, psycho dither to 24 bits, 48 kHz, block 512."""
    eng = engine_mod.ConvoPeqEngine(headline.SAMPLE_RATE,
                                    headline.BLOCK_SIZE, dtype=dtype,
                                    device="cuda",
                                    mixed_phase_cache_dir=cache_dir)
    eng.set_eq(headline.headline_eq())
    eng.set_soft_clip(True, 0.3)
    eng.set_auto_gain(True)
    eng.set_dither(dither.PSYCHOACOUSTIC, 24)
    eng.load_impulse_response(ir_path, phase_mode=phase,
                              target_seconds=headline.IR_LEN
                              / headline.SAMPLE_RATE)
    return eng


def app_eq_flags():
    """eq20 as the CLI's --eq flags (every band peaking at its default
    frequency and Q)."""
    p = headline.headline_eq()
    names = {v: k for k, v in cli_mod.BAND_TYPES.items()}
    flags = []
    for b in range(len(p.gains_db)):
        flags += ["--eq", f"{b}:{names[int(p.band_types[b])]}:"
                  f"{float(p.freqs[b])!r}:{float(p.gains_db[b])!r}:"
                  f"{float(p.qs[b])!r}"]
    return flags


def app_plain(eng64, x):
    """The f64 plain path of the engine's chain on x (dither off)."""
    with dispatch.plain():
        y, _ = eng64.process(x, return_chain_output=True)
    return y


def app_on_grid(y, bits=24):
    g = y.double() * 2.0 ** (bits - 1)
    return bool(torch.isfinite(y).all()) and bool((g == g.round()).all())


def phase_app_load(card, tmp):
    """15a: the IR written as a 32-bit float WAV and loaded by path, as
    is, minimum and mixed phase (fresh mixed-phase cache: the design
    runs); host seconds of each load."""
    ir_path = tmp / "ir.wav"
    wavio.write_wav(ir_path, headline.headline_ir(), int(headline.SAMPLE_RATE))
    secs = {}
    for name, phase in (("as_is", engine_mod.PHASE_AS_IS),
                        ("minimum", engine_mod.PHASE_MINIMUM),
                        ("mixed", engine_mod.PHASE_MIXED)):
        t0 = time.perf_counter()
        eng = app_engine(ir_path, torch.float32, tmp / f"mp_{name}", phase)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        check(np.all(np.isfinite(eng._ir_prepared)),
              f"15a: the {name} IR is finite")
        extra = (f", branches {eng.mixed_phase_branches}"
                 if name == "mixed" else "")
        print(f"15a IR load {name}: {secs[name]:.2f} s host, peak latency "
              f"{eng._ir_peak_latency}, scale {eng._ir_scale:.6g}{extra} "
              f"[{card}]")
        if name == "mixed":
            check(len(eng.mixed_phase_branches) == 2 and all(
                b in ("allpass", "fallback")
                for b in eng.mixed_phase_branches),
                "15a: mixed phase designed for both channels")
        del eng
    return ir_path, secs


def phase_app_fidelity(card, eng32, eng64):
    """15b: dither off, f32 and f64 through the kernels against the f64
    plain path; then dither on (the counted runs): on the 24-bit grid."""
    batch, seconds = APP_FIDELITY
    x = staged.signal(batch, seconds, "cuda")
    for eng in (eng32, eng64):
        eng.set_dither(dither.PSYCHOACOUSTIC, 0)
    ref = app_plain(eng64, x)
    counts = {}
    for eng, dt in ((eng32, torch.float32), (eng64, torch.float64)):
        y = eng.process(x)
        rel = float(((y.double() - ref).pow(2).mean()
                     / ref.pow(2).mean()).sqrt())
        print(f"15b engine {batch}x{seconds:g}s {str(dt)[6:]} kernels, "
              f"dither off, vs f64 plain: rel RMS {rel:.3e} (tol "
              f"{APP_LIMITS[dt]:g}), finite {bool(torch.isfinite(y).all())} "
              f"[{card}]")
        check(y.shape == x.shape and bool(torch.isfinite(y).all()),
              "15b: engine output finite, shaped")
        check(rel <= APP_LIMITS[dt], f"15b: {dt} engine vs the plain path")
        del y
    for eng, dt in ((eng32, torch.float32), (eng64, torch.float64)):
        eng.set_dither(dither.PSYCHOACOUSTIC, 24)
        dispatch.reset_launches()
        yd = eng.process(x)
        torch.cuda.synchronize()
        counts[dt] = dispatch.launches()
        must = APP_KERNELS[dt]
        print(f"15b engine {str(dt)[6:]} dithered: on the 24-bit grid "
              f"{app_on_grid(yd)}, launches {counts[dt]} (must: {must}) "
              f"[{card}]")
        check(app_on_grid(yd), "15b: dithered output on the 24-bit grid")
        check(all(counts[dt][n] > 0 for n in must),
              f"15b: every kernel of the {dt} engine launched")
        del yd
    return counts[torch.float32], counts[torch.float64]


def phase_app_rate(card, eng32, eng64):
    """15c: process with dither at 64 x 20 s, f32 and f64: RTF (median of
    3 after a warm-up), spread, peak memory, and the device time of one
    call by kernel (the ten largest); returns the outputs."""
    batch, seconds = APP_RTF
    outs = {}
    for eng, dt in ((eng32, torch.float32), (eng64, torch.float64)):
        x = staged.signal(batch, seconds, "cuda", dt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = headline.measure(eng.process, x, reps=3)
        peak = torch.cuda.max_memory_allocated()
        report_rtf("15c engine", batch, seconds, walls, peak, card,
                   str(dt)[6:])
        wall, rows = headline.profile_call(lambda: eng.process(x))
        busy = sum(r[1] for r in rows)
        print(f"15c engine {str(dt)[6:]} profiled call: wall {wall:.2f} ms, "
              f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), "
              f"{sum(r[2] for r in rows)} device ops; the largest "
              f"[{card}]:")
        for kernel, ms, count in rows[:10]:
            print(f"  {ms:9.3f} ms  x{count:<4d} {kernel[:100]}")
        outs[dt] = eng.process(x)
        check(app_on_grid(outs[dt]), "15c: output on the 24-bit grid")
        del x
    return outs


def phase_app_crossfade(card, eng32):
    """15d: soft clip on -> off between two process calls (dither off):
    the fade window is crossfade_mix of the old chain's output (on the
    window plus its forward horizon, as the engine runs it) and the new
    chain's, bit for bit; and the old chain's output there is its output
    on the whole input within the staged f32 bound (2e-3 relative RMS:
    the scans' trees round differently at another length)."""
    eng32.set_dither(dither.PSYCHOACOUSTIC, 0)
    eng32.crossfade_enabled = True
    x = staged.signal(4, 2.0, "cuda", seed=5)
    eng32.process(x)
    old = eng32._published
    eng32.set_soft_clip(False)
    y = eng32.process(x)
    ev = [e for e in eng32.telemetry.events if e.category == "crossfade"]
    check(bool(ev), "15d: the structural change crossfaded")
    ft = ev[-1].detail["fade_ms"] * 1e-3
    n = int(round(ft * headline.SAMPLE_RATE))
    y_old = old["fn"](x[..., :n + old["margin"]], old["conv"])[..., :n]
    y_new = eng32._published["fn"](x, eng32._conv_state)
    want = crossfade_mix(y_old, y_new[..., :n], headline.SAMPLE_RATE, ft)
    y_full = old["fn"](x, old["conv"])[..., :n]
    rel = float(((y_old - y_full).double().pow(2).mean()
                 / y_full.double().pow(2).mean()).sqrt())
    exact = bool(torch.equal(y[..., :n], want))
    after = bool(torch.equal(y[..., n:], y_new[..., n:]))
    print(f"15d crossfade soft clip on -> off: {n} samples "
          f"({ev[-1].detail['triggers']}), window equal to the mix {exact}, "
          f"after it equal {after}, the old chain on the window vs the "
          f"whole input rel RMS {rel:.3e} (tol 2e-3), finite "
          f"{bool(torch.isfinite(y).all())} [{card}]")
    check(bool(torch.isfinite(y).all()) and exact and after and rel <= 2e-3,
          "15d: the fade window is the mix of the two chains")
    eng32.crossfade_enabled = False
    eng32.set_soft_clip(True, 0.3)
    eng32.set_dither(dither.PSYCHOACOUSTIC, 24)


def phase_app_streaming(card, eng32, eng64):
    """15e: process_streaming at 1 stream x 400 blocks, dither off: folded
    (soft clip off: the fold needs an LTI chain) against the f64 folded
    offline chain on the plain path, <= 2e-5; staged (the Quick start
    chain) against the f64 engine's process, <= 2e-3; the median block
    wall and the xruns."""
    n = APP_STREAM_BLOCKS * headline.BLOCK_SIZE
    x = staged.signal(1, n / headline.SAMPLE_RATE, "cuda", seed=6)
    for eng in (eng32, eng64):
        eng.set_dither(dither.PSYCHOACOUSTIC, 0)
        eng.set_soft_clip(False)
    cfg = eng64._effective_config()
    folded = prepare_folded_convolver(
        torch.from_numpy(eng64._ir_prepared), headline.BLOCK_SIZE,
        eng64.filter_spec, cfg, eng64.eq_params, dtype=torch.float64,
        partition=None, device="cuda")
    with dispatch.plain():
        refs = {"folded": process_chain_fused(x.double(), cfg, folded)}
    del folded
    for eng in (eng32, eng64):
        eng.set_soft_clip(True, 0.3)
    refs["staged"] = eng64.process(x)
    counts = {}
    for name, tol in (("folded", 2e-5), ("staged", 2e-3)):
        eng32.set_soft_clip(name == "staged", 0.3)
        ref = refs[name]
        dispatch.reset_launches()
        y, _ = eng32.process_streaming(x, folded=name == "folded")
        torch.cuda.synchronize()
        counts[name] = dispatch.launches()
        walls = eng32.last_stream_walls
        rel = float(((y.double() - ref).pow(2).mean()
                     / ref.pow(2).mean()).sqrt())
        rep = eng32.telemetry_report()
        print(f"15e streaming {name} 1 x {APP_STREAM_BLOCKS} blocks: rel RMS "
              f"{rel:.3e} vs the f64 offline chain (tol {tol:g}), median "
              f"block wall {statistics.median(walls) * 1e3:.3f} ms (max "
              f"{max(walls) * 1e3:.3f}; budget "
              f"{headline.BLOCK_SIZE / headline.SAMPLE_RATE * 1e3:.2f}), "
              f"xruns {rep['xruns']} of {rep['steps']} steps so far, "
              f"launches {counts[name]} [{card}]")
        check(bool(torch.isfinite(y).all()) and rel <= tol,
              f"15e: {name} streaming matches the offline chain")
    check(counts["folded"]["osa_rfft"] > 0
          and counts["folded"]["irfft_valid"] > 0,
          "15e: the folded step launched osa_rfft and irfft_valid")
    for eng in (eng32, eng64):
        eng.set_soft_clip(True, 0.3)
        eng.set_dither(dither.PSYCHOACOUSTIC, 24)
    return counts["folded"]


def app_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_app_metering(card, outs):
    """15f: momentary, short-term and integrated loudness and true peak of
    15c's outputs on the card: f32 against the same computation in f64
    on the f32 output; f64 on the card against the CPU on two streams."""
    sr = headline.SAMPLE_RATE
    fns = {"momentary": lambda y: metering.loudness_momentary(y, sr),
           "short_term": lambda y: metering.loudness_short_term(y, sr),
           "integrated": lambda y: metering.loudness_integrated(y, sr),
           "true_peak": metering.true_peak}
    y32, y64 = outs[torch.float32], outs[torch.float64]
    for name, fn in fns.items():
        got, ms = app_time(lambda: fn(y32))
        ref, ms64 = app_time(lambda: fn(y32.double()))
        if name == "true_peak":
            err = float((got.double() - ref).abs().max() / ref.abs().max())
            tol = 1e-5
        else:
            err = float((got.double() - ref).abs().max())
            tol = 0.01
        print(f"15f {name} f32: {ms:.1f} ms, max |diff| vs f64 on the card "
              f"{err:.3e} ({'relative' if name == 'true_peak' else 'LU'}, "
              f"tol {tol:g}); f64 {ms64:.1f} ms [{card}]")
        check(bool(torch.isfinite(got[got > -np.inf]).all())
              and err <= tol, f"15f: f32 {name} within its tolerance")
        sub = y64[:2]
        got64, ms_sub = app_time(lambda: fn(sub))
        cpu = fn(sub.cpu())
        if name == "true_peak":
            err64 = float((got64.cpu() - cpu).abs().max() / cpu.abs().max())
            tol64 = 1e-12
        else:
            err64 = float((got64.cpu() - cpu).abs().max())
            tol64 = 1e-9
        print(f"15f {name} f64 (2 streams): card vs CPU max |diff| "
              f"{err64:.3e} (tol {tol64:g}), {ms_sub:.1f} ms [{card}]")
        check(err64 <= tol64, f"15f: f64 {name}, card vs CPU")


def phase_app_cli(card, tmp, ir_path):
    """15g: the CLI end to end in a subprocess on 30 s of stereo, the
    Quick start's flags (the whole 1M-tap IR: --ir-seconds its length)."""
    n = int(APP_CLI_SECONDS * headline.SAMPLE_RATE)
    x = staged.signal(1, APP_CLI_SECONDS, "cuda", seed=7)[0].cpu().numpy()
    wavio.write_wav(tmp / "in.wav", x, int(headline.SAMPLE_RATE))
    cmd = [sys.executable, "-m", "convopeq_tpu_torch.cli",
           str(tmp / "in.wav"), str(tmp / "out.wav"), "--ir", str(ir_path),
           "--ir-seconds", repr(headline.IR_LEN / headline.SAMPLE_RATE),
           *app_eq_flags(), "--softclip", "0.3", "--auto-gain",
           "--dither", "psycho:24", "--measure"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    for line in run.stdout.strip().splitlines():
        print(f"15g cli: {line}")
    print(f"15g cli exit {run.returncode} in {secs:.1f} s [{card}]")
    check(run.returncode == 0, f"15g: the CLI exited 0 ({run.stderr[-2000:]})")
    y = wavio.read_wav(tmp / "out.wav").samples
    check(y.shape == (2, n) and bool(np.isfinite(y).all()),
          "15g: out.wav has the input's length and is finite")


def phase_app_views(card, outs):
    """15h: the max-plus limiter on 15c's f32 output and the analyzer
    view fed 512-sample blocks of its first stream."""
    y = outs[torch.float32]
    (lim, env), ms = app_time(lambda: peak_limiter(y, headline.SAMPLE_RATE))
    print(f"15h peak_limiter (max-plus) {tuple(y.shape)}: {ms:.1f} ms, "
          f"finite {bool(torch.isfinite(lim).all())}, max |y| "
          f"{float(lim.abs().max()):.4f} [{card}]")
    check(bool(torch.isfinite(lim).all()) and bool(torch.isfinite(env).all()),
          "15h: limiter output finite")
    view = AnalyzerView(headline.SAMPLE_RATE)
    blocks = y[0].split(headline.BLOCK_SIZE, dim=-1)
    t0 = time.perf_counter()
    for blk in blocks:
        view.push(blk)
    ms = (time.perf_counter() - t0) * 1e3
    bars = view.bars()
    ok = all(np.isfinite(v).all() for v in bars.values())
    print(f"15h AnalyzerView {len(blocks)} blocks of 512: {ms:.1f} ms "
          f"({ms / len(blocks):.3f} ms a push), bars finite {ok} [{card}]")
    check(ok, "15h: analyzer bars finite")


def phase_app(card):
    """Phase 15: the application path (ConvoPeqEngine, the CLI, metering,
    limiter, analyzer view); returns the counts by path."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        ir_path, _ = phase_app_load(card, tmp)
        eng32 = app_engine(ir_path, torch.float32, tmp / "mp32")
        eng64 = app_engine(ir_path, torch.float64, tmp / "mp64")
        # each check sets the config it needs: no fade from the last one
        # (15d turns it on for its own check)
        eng32.crossfade_enabled = eng64.crossfade_enabled = False
        by_path = {}
        by_path["engine"], by_path["engine_f64"] = \
            phase_app_fidelity(card, eng32, eng64)
        outs = phase_app_rate(card, eng32, eng64)
        phase_app_crossfade(card, eng32)
        by_path["engine_streaming"] = phase_app_streaming(card, eng32, eng64)
        phase_app_metering(card, outs)
        phase_app_views(card, outs)
        del outs, eng32, eng64
        torch.cuda.empty_cache()
        phase_app_cli(card, tmp, ir_path)
    print(f"phase 15 (application path): {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    return by_path


# ------------------------------------------------------------ phase 16
NATIVE_EQUIV = (3, 12)          # streams, blocks (16a)
SERVE_CLI_SECONDS = 10.0        # 16c
# 16d: (sample rate, bits, learning mode, eval_blocks)
LEARN_POINTS = ((48000.0, 16, 0, 1), (384000.0, 24, 5, 16))
LIVE_CHUNK_BLOCKS = 64          # 16e: blocks a process_streaming call
LIVE_BOUND_S = 120.0
# the f64 lattice_fir step's chain of dependent operations, in cycles at
# the card's measured latencies (csrc/error_feedback_quantize.cu's note)
F64_FIR_CHAIN_CYCLES = 221


def replay_check(chain, recorded, popped, n_streams, n_blocks):
    """The serving loop's recorded windows (input, output) replayed
    through the direct step from a fresh state, bit for bit; each
    stream's committed blocks the f32 casts of the outputs at the windows
    it was ready in, its inputs in order.  Returns the windows."""
    state = chain.init_state((n_streams,))
    for xin, y in recorded:
        state, yd = chain.step(state, xin)
        check(torch.equal(yd, y), "16a: a served window equals the direct "
              "step on its gathered input, bit for bit")
    for i in range(n_streams):
        ready = [y[i] for xin, y in recorded if float(xin[i].abs().max()) > 0]
        check(len(ready) == len(popped[i]) == n_blocks,
              f"16a: stream {i}: {n_blocks} blocks committed and popped")
        for y, out in zip(ready, popped[i]):
            check(np.array_equal(out, y.float().cpu().numpy()),
                  f"16a: stream {i}'s popped block equals its window")
    return len(recorded)


def phase_native_equivalence(card, chain):
    """16a: 3 streams x 12 blocks through NativeServingLoop over the
    folded f32 chain, a producer thread a stream, against the direct
    step on the same gathered blocks."""
    import threading
    n_streams, n_blocks = NATIVE_EQUIV
    gen = torch.Generator().manual_seed(16)
    x = (torch.randn((n_streams, n_blocks, 2, chain.block_size),
                     generator=gen) * 0.25).numpy()
    loop = native_serving.NativeServingLoop(chain, n_streams)
    recorded = []
    step = chain.step

    def recording_step(state, block):
        state, y = step(state, block)
        recorded.append((block.clone(), y.clone()))
        return state, y

    chain.step = recording_step

    def produce(i):
        for k in range(n_blocks):
            while not loop.push(i, x[i, k]):
                time.sleep(1e-4)

    threads = [threading.Thread(target=produce, args=(i,))
               for i in range(n_streams)]
    for t in threads:
        t.start()
    popped = {i: [] for i in range(n_streams)}
    deadline = time.monotonic() + 60.0
    try:
        while sum(map(len, popped.values())) < n_streams * n_blocks:
            check(time.monotonic() < deadline, "16a: served in 60 s")
            loop.serve_window()
            for i in range(n_streams):
                b = loop.pop(i)
                while b is not None:
                    popped[i].append(b)
                    b = loop.pop(i)
    finally:
        del chain.step
        for t in threads:
            t.join(timeout=10)
    windows = replay_check(chain, recorded, popped, n_streams, n_blocks)
    st = loop.stats()
    print(f"16a native plane {n_streams} streams x {n_blocks} blocks, "
          f"folded f32, producer threads: {windows} windows, every one "
          f"equal to the direct step bit for bit, {st['served_blocks']} "
          f"blocks committed in order, underruns {st['underruns']} [{card}]")


def phase_native_points(card, fixture, folded):
    """16b: serve.py --native's points; returns the folded 32-stream
    point's launch counts."""
    counts = None
    for tier, ns, nwin in serve.NATIVE_POINTS:
        chain = folded if tier == "folded" else serve.build_chain(
            tier, "cuda", fixture)
        dispatch.reset_launches()
        row = serve.native_point(chain, ns, nwin, tier=tier)
        launches = dispatch.launches()
        if tier == "folded" and ns == 32:
            counts = launches
        print(f"16b native {tier} x{ns}: {row['windows_served']} windows of "
              f"{row['window_samples']} ({row['window_budget_ms']:.2f} ms), "
              f"served {row['served_blocks']} blocks, underruns "
              f"{row['underruns']}, xruns {row['xruns']}, overflows "
              f"{row['in_overflows']}, drops {row['out_drops']}; wall avg "
              f"{row['avg_wall_ms']:.3f} / max {row['max_wall_ms']:.3f} ms "
              f"against {row['budget_ms']:.2f}, of it the dispatcher's host "
              f"part {row['host_ms_per_window']:.3f} ms (its thread's CPU "
              f"{row['host_cpu_ms_per_window']:.3f} ms); "
              f"{row['streams_x_realtime']:.1f} streams x realtime; H2D and "
              f"D2H "
              f"{row['h2d_mb_per_window']:.2f} MB a window; launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]")
        print(json.dumps({"native_serving": row, "card": card}))
        check(row["windows_served"] >= nwin,
              f"16b: {tier} x{ns} served its {nwin} windows")
        if tier != "folded":
            del chain
            torch.cuda.empty_cache()
    check(counts["osa_rfft"] > 0 and counts["irfft_valid"] > 0,
          "16b: the folded native point launched osa_rfft and irfft_valid")
    return counts


def phase_serve_cli(card, tmp):
    """16c: the CLI with --serve on 10 s of stereo (the room-correction
    IR, EQ bypassed: the staged step), out.wav against process_streaming
    of an engine with the same flags on the same input, bit for bit."""
    sr = headline.SAMPLE_RATE
    n = int(SERVE_CLI_SECONDS * sr)
    x = staged.signal(1, SERVE_CLI_SECONDS, "cuda", seed=9)[0].cpu().numpy()
    wavio.write_wav(tmp / "serve_in.wav", x, int(sr))
    wavio.write_wav(tmp / "room.wav", nuc3.room_ir(), int(sr), bits=64,
                    float_format=True)
    cmd = [sys.executable, "-m", "convopeq_tpu_torch.cli",
           str(tmp / "serve_in.wav"), str(tmp / "serve_out.wav"), "--ir",
           str(tmp / "room.wav"), "--serve"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    for line in run.stdout.strip().splitlines():
        print(f"16c cli: {line}")
    check(run.returncode == 0, f"16c: the CLI exited 0 ({run.stderr[-2000:]})")
    eng = engine_mod.ConvoPeqEngine(sr, headline.BLOCK_SIZE, device="cuda")
    eng.load_impulse_response(str(tmp / "room.wav"))
    eng.set_bypass(eq=True)
    eng.set_processing_order(EQ_THEN_CONVOLVER)
    eng.set_oversampling(1)
    eng.set_wet_dry_mix(1.0)
    eng.set_auto_gain(False)
    xin = wavio.read_wav(tmp / "serve_in.wav").samples.astype(np.float32)
    xin = np.pad(xin, [(0, 0), (0, (-n) % headline.BLOCK_SIZE)])
    y, _ = eng.process_streaming(torch.from_numpy(xin)[None].cuda())
    want = y[0, :, :n].float().cpu().numpy().astype(np.float64)
    got = wavio.read_wav(tmp / "serve_out.wav").samples
    diff = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    print(f"16c cli --serve 1 x {SERVE_CLI_SECONDS:g} s (exit "
          f"{run.returncode}, {secs:.1f} s): out.wav vs process_streaming "
          f"max |diff| {diff:.3e}, median block wall of process_streaming "
          f"{statistics.median(eng.last_stream_walls) * 1e3:.3f} ms [{card}]")
    check(diff == 0.0, "16c: --serve equals process_streaming bit for bit")


def population_rows(lrn, K, audio):
    """The signal rows, uniforms and per-row coefficients of the learner's
    one population call (models/learner.simulate_shaper_error_population):
    (x (R, N), u (R, N, 2), coefficients (R, 9)) on the card, R = P x L x
    2, and the (L, 2, N) blocks."""
    _, sim, u = lrn._population_inputs(audio)
    P = K.shape[0]
    R, N = P * sim.shape[0] * sim.shape[1], sim.shape[-1]
    xs = torch.from_numpy(sim).cuda().expand((P,) + sim.shape) \
        .reshape(R, N).contiguous()
    us = u.expand((P,) + u.shape).reshape(R, N, 2).contiguous()
    k = dither.lattice_coeffs(np.broadcast_to(
        K[:, None, None, :], (P,) + sim.shape[:-1] + (9,))).reshape(R, 9)
    return xs, us, torch.from_numpy(np.ascontiguousarray(k)).cuda(), sim


def population_plain(lrn, K, audio):
    """The population's errors through the quantizer's plain version on
    the card, on the rows of the learner's one call."""
    xs, us, kr, sim = population_rows(lrn, K, audio)
    scale, _ = dither.quant_scales(lrn.bit_depth)
    q, _ = qk.error_feedback_quantize_plain(
        xs, us, kr, scale, dither.K_OUTPUT_HEADROOM, "lattice_fir")
    return q.reshape((K.shape[0],) + sim.shape).cpu().numpy() \
        - sim[None] * dither.K_OUTPUT_HEADROOM


def phase_learner(card):
    """16d: one generation at each LEARN_POINTS point: the errors its one
    per-row launch gave the evaluator against the plain version on the
    card and against 18 launches of the shared form, bit for bit (the
    costs are the evaluator's, a deterministic function of the errors, so
    equal errors give equal costs); the generation's wall split into
    simulation (device) and evaluator (host); the per-row kernel's time
    at the learner's shapes beside its bounds.  Returns the generations'
    launch counts and the time rows."""
    counts = None
    rows = {}
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    for sr, bits, mode, eb in LEARN_POINTS:
        lrn = learner.NoiseShaperLearner(sr, bits, mode, seed=0, workers=4,
                                         eval_blocks=eb, device="cuda")
        audio = train_banks.program_material(sr)
        cands = lrn.opt.sample()
        K = np.stack([learner.CmaEs.to_parcor(c) for c in cands])
        _, sim, u = lrn._population_inputs(audio)
        learner.simulate_shaper_error_population(    # warm
            sim, K, bits, u, device="cuda")
        recorded = []
        simulate = learner.simulate_shaper_error_population

        def recording(*args, **kwargs):
            errs = simulate(*args, **kwargs)
            recorded.append(errs)
            return errs

        learner.simulate_shaper_error_population = recording
        dispatch.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            costs = lrn._population_costs(cands, audio)
        finally:
            learner.simulate_shaper_error_population = simulate
        wall = time.perf_counter() - t0
        launches = dispatch.launches()
        counts = launches if counts is None else {
            k: counts[k] + launches[k] for k in counts}
        check(launches["error_feedback_quantize"] == 1,
              f"16d: one quantizer launch a generation ({launches})")
        errs, = recorded
        plain = population_plain(lrn, K, audio)
        shared = np.stack([learner.simulate_shaper_error(
            sim.reshape(-1, sim.shape[-1]), K[p], sr, bits,
            uniforms=u.reshape(-1, sim.shape[-1], 2), device="cuda")
            .reshape(sim.shape) for p in range(len(K))])
        check(np.array_equal(errs, plain),
              f"16d {sr:g}: per-row kernel errors equal the plain version's")
        check(np.array_equal(errs, shared),
              f"16d {sr:g}: per-row kernel errors equal 18 shared launches")
        check(np.isfinite(costs).all() and costs.shape == (len(K),),
              f"16d {sr:g}: one finite cost a candidate")
        xs, us, kr, _ = population_rows(lrn, K, audio)
        R, N = xs.shape
        scale, _ = dither.quant_scales(bits)
        h = dither.K_OUTPUT_HEADROOM
        ms = time_ms(lambda: qk.error_feedback_quantize(
            xs, us, kr, scale, h, "lattice_fir"), reps=5)
        shared_ms = time_ms(lambda: qk.error_feedback_quantize(
            xs, us, kr[0].cpu().numpy(), scale, h, "lattice_fir"), reps=5)
        bytes_ms, _ = bound(R * N * 4 * 8 + 2 * R * 9 * 8 + R * 9 * 8, 0,
                            F64_OPS_S)
        lat_ms = N * F64_FIR_CHAIN_CYCLES / (mhz * 1e3)
        rows[f"R{R}_N{N}"] = {"ms": ms, "shared_ms": shared_ms,
                              "bound_bytes_ms": bytes_ms,
                              "bound_latency_ms": lat_ms}
        print(f"16d learner {sr:g} Hz / {bits} bits / mode {mode} / "
              f"eval_blocks {eb}: generation {wall * 1e3:.1f} ms = "
              f"simulation (device, one per-row launch of R={R} N={N}) "
              f"{lrn.sim_seconds * 1e3:.1f} ms + evaluator (host, "
              f"{len(K)} x {len(learner.TARGET_LEVELS)} scorings x "
              f"{max(1, eb - 1)} windows on 4 threads) "
              f"{lrn.eval_seconds * 1e3:.1f} ms; quantizer launches "
              f"{launches['error_feedback_quantize']}; errors equal to the "
              f"plain version and to 18 shared launches bit for bit, so "
              f"the costs too; best cost {costs.min():.6g} [{card}]")
        print(f"16d per-row quantizer f64 lattice_fir R={R} N={N}: "
              f"{ms:.3f} ms (the shared form at the same shape "
              f"{shared_ms:.3f} ms), {ms / N * 1e6:.1f} ns a step = "
              f"{ms / N * mhz * 1e3:.0f} cycles at {mhz:.0f} MHz; bound by "
              f"bytes {bytes_ms:.4f} ms, by the chain's latency "
              f"({F64_FIR_CHAIN_CYCLES} cycles a step) {lat_ms:.3f} ms "
              f"[{card}]")
        del xs, us, errs, plain, shared
    return counts, rows


def phase_live_learning(card, tmp):
    """16e: an engine at 48 kHz (the room-correction IR, EQ bypassed,
    folded streaming), ADAPTIVE9 to 16 bits, streams with learning off,
    then with learning on until two generations complete: a bank
    published mid-stream; the median block wall and the xruns of both.
    Returns the engine (16f exports it)."""
    sr = headline.SAMPLE_RATE
    bs = headline.BLOCK_SIZE
    eng = engine_mod.ConvoPeqEngine(sr, bs, device="cuda",
                                    mixed_phase_cache_dir=tmp / "mp")
    eng.load_impulse_response(nuc3.room_ir(), sr)
    eng.set_bypass(eq=True)
    eng.set_dither(dither.ADAPTIVE9, 16)
    x = staged.signal(1, LIVE_CHUNK_BLOCKS * bs / sr, "cuda", seed=10)
    carry = None

    def stream(chunks):
        nonlocal carry
        walls, x0 = [], eng._xrun.xruns if eng._xrun is not None else 0
        for _ in range(chunks):
            _, carry = eng.process_streaming(x, carry, folded=True)
            walls += eng.last_stream_walls
        return walls, eng._xrun.xruns - x0

    stream(1)                                        # build, first launches
    off_walls, off_xruns = stream(6)
    dispatch.reset_launches()
    eng.start_learning(mode=0)
    t0 = time.perf_counter()
    on_walls, on_xruns, chunks = [], 0, 0
    published_mid = False
    try:
        while eng._learner.generation < 2:
            check(time.perf_counter() - t0 < LIVE_BOUND_S,
                  f"16e: two generations in {LIVE_BOUND_S:g} s")
            w, xr = stream(1)
            on_walls += w
            on_xruns += xr
            chunks += 1
            published_mid = published_mid or (
                eng.adaptive_banks.get(sr, 16, 0) is not None)
    finally:
        st = eng.stop_learning(timeout=LIVE_BOUND_S)
    secs = time.perf_counter() - t0
    launches = dispatch.launches()
    events = [e for e in eng.telemetry.events if e.category == "learning"]
    med = (statistics.median(off_walls) * 1e3,
           statistics.median(on_walls) * 1e3)
    print(f"16e live learning, ADAPTIVE9 16-bit, folded stream at 48 kHz: "
          f"{st.generations} generations in {secs:.1f} s over {chunks} "
          f"chunks of {LIVE_CHUNK_BLOCKS} blocks; bank published mid-stream "
          f"{published_mid} ({len(events)} publications, best cost "
          f"{st.best_score:.6g}); median block wall learning off "
          f"{med[0]:.3f} ms ({len(off_walls)} blocks, xruns {off_xruns}), "
          f"on {med[1]:.3f} ms ({len(on_walls)} blocks, xruns {on_xruns}), "
          f"max on {max(on_walls) * 1e3:.3f} ms, budget "
          f"{bs / sr * 1e3:.2f} ms; quantizer launches "
          f"{launches['error_feedback_quantize']} (the stream's and the "
          f"learner's) [{card}]")
    check(published_mid and events and st.generations >= 2,
          "16e: a bank published mid-stream")
    return eng


def phase_evidence(card, eng, tmp):
    """16f: the evidence export of 16e's engine: the manifest verifies,
    an edited artifact fails it, the payload tier names the card."""
    d = tmp / "evidence"
    man = eng.export_evidence_dir(d)
    ok = evidence.verify_evidence_dir(d)
    tier = json.loads((d / "payload_tier_report.json").read_text())
    art = d / "learner_report.json"
    art.write_text(art.read_text() + " ")
    bad = evidence.verify_evidence_dir(d)
    print(f"16f evidence: {man['artifactCount']} artifacts, verifies "
          f"{ok['ok']}, an edited artifact fails it {not bad['ok']} "
          f"({bad['mismatches']}); payload tier: {tier['card']}, "
          f"{tier['device']}, launches so far "
          f"{ {k: v for k, v in tier['kernel_launches'].items() if v} } "
          f"[{card}]")
    check(ok["ok"] and not bad["ok"]
          and bad["mismatches"] == ["learner_report.json"],
          "16f: the manifest verifies and catches an edit")
    check(tier["card"] == card and tier["device"].startswith("cuda"),
          "16f: the payload tier names the card")


def phase_last_modules(card):
    """Phase 16: the native plane, --serve, the learner, live learning,
    the evidence export and the multi-process dry run; returns the counts
    by path and the per-row quantizer's time rows."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    fixture = serve.serving_fixture()
    folded = serve.build_chain("folded", "cuda", fixture)
    by_path = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        phase_native_equivalence(card, folded)
        by_path["serve_native"] = phase_native_points(card, fixture, folded)
        del folded
        torch.cuda.empty_cache()
        phase_serve_cli(card, tmp)
        by_path["learner"], per_row = phase_learner(card)
        eng = phase_live_learning(card, tmp)
        phase_evidence(card, eng, tmp)
        del eng
    dryrun.dryrun_multichip(4, log=lambda s: print(f"16g {s} [{card}]"))
    print(f"phase 16 (the last modules): {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    return by_path, per_row


def main():
    card = phase_environment()
    phase_build(card)
    rows = phase_kernels(card)
    rows.update(phase_kernels(card, torch.float64))
    rows["osa_rfft"], self_check = phase_self_check(card)
    rows["fused_conv"] = phase_fused_kernel(card)
    phase_layer_shapes(card)
    phase_headline(card)
    rows["error_feedback_quantize"] = phase_quantizer(card)
    rows["soft_clip_local2x"] = phase_soft_clip(card)
    rows["iir_cascade"] = phase_iir_cascade(card)
    config6_launches = phase_config6(card)
    by_path = {"config6": config6_launches}
    by_path["prefilter"], _ = phase_prefilter(card)
    by_path["roomcorr"] = phase_roomcorr(card)
    by_path.update(phase_parity(card))
    by_path.update(phase_staged(card))
    phase_cascade(card)
    config3_launches, mac_rows = phase_config3(card)
    by_path.update(config3_launches)
    by_path.update(phase_config3_staged(card))
    serving, serving_shapes = phase_serving(card)
    by_path.update(serving)
    by_path.update(phase_app(card))
    last, per_row = phase_last_modules(card)
    by_path.update(last)
    rows["error_feedback_quantize"]["per_row_f64"] = per_row
    by_path["self_check"] = self_check
    f64 = by_path["headline_f64"]
    launches = {**by_path["prefilter"], "error_feedback_quantize":
                config6_launches["error_feedback_quantize"],
                "soft_clip_local2x": config6_launches["soft_clip_local2x"],
                "iir_cascade": config6_launches["iir_cascade"],
                **{n: f64[n] for n in fk.F64_KERNELS},
                "osa_rfft": by_path["serve_folded"]["osa_rfft"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name], **rows[name],
         **({"config3": mac_rows[name]} if name in mac_rows else {}),
         **({"serving_shapes": serving_shapes[name]}
            if name in serving_shapes else {}),
         "launches_by_path": {k: v.get(name) for k, v in by_path.items()}}
        for name in SOURCES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
