"""Command-line front end: process WAV files through the full chain
(counterpart of convopeq_tpu/cli.py; the headless analog of the
reference's MainWindow and panels):

    python -m convopeq_tpu_torch.cli input.wav output.wav \\
        --ir room.wav --eq "1:peaking:1000:+6:1.4" --order eq-conv \\
        --oversample 2 --softclip 0.3 --dither psycho:24 --auto-gain \\
        --measure

State presets (--save-state / --load-state, the preset-XML analog; the
JAX package's preset files load too), and it prints the latency
breakdown, the auto-gain plan and, with --measure, the output's
integrated loudness and true peak.  --serve processes through the native
serving plane (a producer thread -> the C++ block scheduler's rings ->
the per-block step -> a consumer) and prints its deadline stats;
--export-evidence DIR writes the audit artifact set and its manifest
(runtime/evidence.py).

It runs on the card (--device cuda, the default) in float32, or in
float64 with --f64 (native on the card; --device cpu for a CPU run).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

BAND_TYPES = {"lowshelf": 0, "peaking": 1, "highshelf": 2,
              "lowpass": 3, "highpass": 4}
DITHER_TYPES = {"psycho": 0, "fixed4": 1, "fixed15": 2, "adaptive": 3}


def parse_eq_band(spec: str):
    """band:type:freq:gain:q[:mode] e.g. '0:peaking:1000:+6:1.4'."""
    parts = spec.split(":")
    if len(parts) < 5:
        raise ValueError(f"bad EQ band spec: {spec}")
    idx = int(parts[0])
    btype = BAND_TYPES[parts[1].lower()]
    freq = float(parts[2])
    gain = float(parts[3])
    q = float(parts[4])
    mode = int(parts[5]) if len(parts) > 5 else 0
    return idx, btype, freq, gain, q, mode


def _serve_blocks(eng, x):
    """Run (2, N) through the native serving front end: a producer thread
    pushes blocks into the C++ scheduler's SPSC ring, the dispatcher
    gathers, steps and commits with deadline accounting, and this thread
    drains the processed blocks.  Prints the native stats line."""
    import threading
    import time

    from .runtime.native_serving import NativeServingLoop

    sc = eng.streaming_chain()
    bs = sc.block_size
    n = x.shape[-1]
    pad = (-n) % bs
    if pad:
        x = np.pad(x, [(0, 0), (0, pad)])
    nb = x.shape[-1] // bs
    loop = NativeServingLoop(sc, 1)
    stop = threading.Event()

    def produce():
        for k in range(nb):
            blk = np.asarray(x[:, k * bs:(k + 1) * bs], np.float32)
            while not loop.push(0, blk):
                if stop.is_set():       # the consumer gave up: do not
                    return              # spin on a full ring
                time.sleep(1e-4)        # ring full: back off

    th = threading.Thread(target=produce)
    th.start()
    got = []
    deadline = time.monotonic() + 600.0
    try:
        while len(got) < nb and time.monotonic() < deadline:
            if not loop.serve_window():
                time.sleep(1e-4)
            while True:
                out = loop.pop(0)
                if out is None:
                    break
                got.append(out)
    finally:
        stop.set()
        th.join()
    st = loop.stats()
    print(f"serving: {st['served_blocks']} blocks of {bs}, "
          f"xruns {st['xruns']}, underruns {st['underruns']}, "
          f"avg {st['avg_wall_ms']:.2f} ms / budget {st['budget_ms']:.2f} "
          f"ms, max {st['max_wall_ms']:.2f} ms")
    if len(got) < nb:
        raise RuntimeError(f"serving: {len(got)} of {nb} blocks came back")
    return np.concatenate(got, axis=-1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="convopeq_tpu_torch",
                                 description="ConvoPeq processor on the card")
    ap.add_argument("input", nargs="?", help="input WAV")
    ap.add_argument("output", nargs="?", help="output WAV")
    ap.add_argument("--ir", help="impulse response WAV")
    ap.add_argument("--eq", action="append", default=[],
                    metavar="BAND:TYPE:FREQ:GAIN:Q[:MODE]")
    ap.add_argument("--order", choices=["conv-eq", "eq-conv"],
                    default="eq-conv")
    ap.add_argument("--oversample", type=int, default=1, choices=[1, 2, 4, 8])
    ap.add_argument("--softclip", type=float, metavar="SATURATION")
    ap.add_argument("--mix", type=float, default=1.0, help="wet/dry 0..1")
    ap.add_argument("--phase", choices=["asis", "minimum", "mixed"],
                    default="asis")
    ap.add_argument("--ir-seconds", type=float, default=None)
    ap.add_argument("--dither", metavar="TYPE:BITS",
                    help="psycho|fixed4|fixed15|adaptive : 16|24|32")
    ap.add_argument("--auto-gain", action="store_true")
    ap.add_argument("--block-size", type=int, default=512)
    ap.add_argument("--save-state", metavar="FILE")
    ap.add_argument("--load-state", metavar="FILE")
    ap.add_argument("--measure", action="store_true",
                    help="print LUFS + true peak of the output")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--f64", action="store_true",
                    help="float64 on the device (the exactness mode)")
    ap.add_argument("--export-evidence", metavar="DIR",
                    help="after processing, write the audit artifact set "
                         "(evidence JSON files + sha256 manifest; the "
                         "reference's ISREvidenceExporter analog)")
    ap.add_argument("--serve", action="store_true",
                    help="process through the native block-scheduler "
                         "serving path (producer thread -> C++ rings -> "
                         "per-block step) and print deadline stats "
                         "(dither and auto gain are offline-only)")
    args = ap.parse_args(argv)

    from .engine import ConvoPeqEngine
    from .engine.engine import PHASE_AS_IS, PHASE_MINIMUM, PHASE_MIXED
    from .models.gain_planner import CONVOLVER_THEN_EQ, EQ_THEN_CONVOLVER
    from .utils.wavio import read_wav, write_wav

    if not args.input:
        ap.print_help()
        return 0

    wav = read_wav(args.input)
    sr = float(wav.sample_rate)
    eng = ConvoPeqEngine(sr, args.block_size,
                         dtype=torch.float64 if args.f64 else torch.float32,
                         device=args.device)

    if args.load_state:
        with open(args.load_state) as f:
            eng.load_state(f.read())

    phase = {"asis": PHASE_AS_IS, "minimum": PHASE_MINIMUM,
             "mixed": PHASE_MIXED}[args.phase]
    if args.ir:
        eng.load_impulse_response(args.ir, phase_mode=phase,
                                  target_seconds=args.ir_seconds)
    else:
        eng.set_bypass(conv=True)

    if args.eq:
        eng.eq_params.enabled[:] = False
        for spec in args.eq:
            idx, btype, freq, gain, q, mode = parse_eq_band(spec)
            eng.set_eq_band(idx, band_type=btype, freq=freq, gain_db=gain,
                            q=q, mode=mode, enabled=True)
    elif not args.load_state:
        eng.set_bypass(eq=True)

    eng.set_processing_order(CONVOLVER_THEN_EQ if args.order == "conv-eq"
                             else EQ_THEN_CONVOLVER)
    eng.set_oversampling(args.oversample)
    if args.softclip is not None:
        eng.set_soft_clip(True, args.softclip)
    eng.set_wet_dry_mix(args.mix)
    eng.set_auto_gain(args.auto_gain)
    if args.dither:
        t, bits = args.dither.split(":")
        eng.set_dither(DITHER_TYPES[t.lower()], int(bits))

    if args.save_state:
        with open(args.save_state, "w") as f:
            f.write(eng.save_state())
        print(f"state saved to {args.save_state}")

    x = wav.samples
    if x.shape[0] == 1:
        x = np.vstack([x, x])
    x = x[:2]
    n = x.shape[-1]
    pad = (-n) % args.block_size
    if pad:
        x = np.pad(x, [(0, 0), (0, pad)])

    if args.serve:
        y = torch.from_numpy(_serve_blocks(eng, x)[..., :n]).to(eng.device)
    else:
        y = eng.process(torch.from_numpy(x))[..., :n]

    lb = eng.latency_breakdown()
    print(f"latency: algorithm {lb.algorithm_latency_samples} + "
          f"ir-peak {lb.ir_peak_latency_samples} + "
          f"os {lb.oversampling_latency_samples} + "
          f"softclip {lb.softclip_latency_samples} = "
          f"{lb.total_latency_samples} samples")
    if args.auto_gain:
        plan = eng.auto_gain_plan()
        print(f"auto gain: input {plan.input_headroom_db:+.2f} dB, "
              f"trim {plan.convolver_input_trim_db:+.2f} dB, "
              f"makeup {plan.output_makeup_db:+.2f} dB")

    if args.measure:
        from .models.metering import loudness_integrated, true_peak
        li = float(loudness_integrated(y, sr))
        tp = float(true_peak(y).max())
        print(f"integrated loudness: {li:.2f} LUFS, true peak: "
              f"{20 * np.log10(max(tp, 1e-12)):.2f} dBTP")

    if args.export_evidence:
        manifest = eng.export_evidence_dir(args.export_evidence)
        print(f"evidence: {manifest['artifactCount']} artifacts + manifest "
              f"-> {args.export_evidence}")

    if args.output:
        write_wav(args.output, y.cpu().numpy(), int(sr))
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
