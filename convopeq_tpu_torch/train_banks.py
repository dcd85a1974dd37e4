"""Train adaptive lattice-shaper coefficient banks offline (counterpart
of tools/train_banks.py).

The reference learns banks at runtime (10-80 min of program material,
ARCHITECTURE.md:44) and persists them in device_settings.xml; the
persisted artifact here is a JSON file in the layout of
`convopeq_tpu_torch/data/learned_banks.json` (AdaptiveCoefficientBanks
.to_dict, keyed by coefficient_bank_index, with a training report).
Deterministic: fixed seeds, a fixed program-material fixture (a tone
stack over a low noise floor), a fixed generation count.  The
population's simulation runs on the card (one per-row quantizer launch a
generation), the evaluator on the host.

    python -m convopeq_tpu_torch.train_banks --out banks.json
        [--banks 0 3] [--generations 12] [--device cuda]

--out is required: the shipped factory banks are never overwritten by
default.  --banks picks entries of BANKS by index, --generations cuts the
run (a chip run's subset).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .device import resolve_device
from .models.dither import lattice_dither, quant_scales
from .models.learner import (AdaptiveCoefficientBanks, K_FFT_LENGTH,
                             NoiseShaperLearner, coefficient_bank_index)
from .utils.dsputil import K_OUTPUT_HEADROOM

# (sample_rate, bit_depth, mode): 44.1k/16/Short (CD), 48k/16/Short (the
# most common playback config), 96k/24/Medium, 384k/24/Long (bench
# config6's bank)
BANKS = [
    (44100.0, 16, 0),
    (48000.0, 16, 0),
    (96000.0, 24, 2),
    (384000.0, 24, 5),
]
GENERATIONS = 12
EVAL_BLOCKS = 16    # the warm, stationary objective (see
                    # NoiseShaperLearner.eval_blocks): the fir ladder's
                    # closed loop can carry bursty limit cycles that a
                    # single zero-state 4096 window scores as quiet


def program_material(sr: float, seed: int = 7) -> np.ndarray:
    """Deterministic music-like fixture: a harmonic tone stack and a low
    noise floor (the cost needs tonal maskers; pure noise masks
    everything and flattens the objective)."""
    rng = np.random.default_rng(seed)
    n = K_FFT_LENGTH
    t = np.arange(n) / sr
    audio = np.zeros((2, n))
    for f0, a in [(220.0, 0.4), (440.0, 0.25), (660.0, 0.12),
                  (1320.0, 0.06), (3300.0, 0.03)]:
        ph = rng.uniform(0, 2 * np.pi, size=2)[:, None]
        audio += a * np.sin(2 * np.pi * f0 * t[None] + ph)
    audio += 0.002 * rng.normal(size=(2, n))
    return audio / (np.abs(audio).max() * 1.5)


def long_run_screen(k, sr, bits, n=300_000, seed=2, device="cuda"):
    """Stationary noise profile of a bank over n samples on the
    production (fir) ladder: (early_rms_lsb, late_rms_lsb, state_max)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # clip gaussian tails: |x*h| > 1 hits the quantizer's fullscale clip,
    # whose (legitimate) error of thousands of LSB would read as a shaper
    # "burst" in a windowed RMS
    x = np.clip(rng.normal(size=(1, n)) * 0.25, -0.9, 0.9)
    u = rng.random(size=(1, n, 2))
    scale, _ = quant_scales(bits)
    q, sf = lattice_dither(torch.from_numpy(x).to(dev),
                           torch.from_numpy(u).to(dev), np.asarray(k), bits,
                           ladder="fir", return_state=True)
    e = (q.cpu().numpy()[0] - x[0] * K_OUTPUT_HEADROOM) / scale
    early = float(np.sqrt(np.mean(e[:32768] ** 2)))
    late = float(np.sqrt(np.mean(e[-32768:] ** 2)))
    smax = float(np.max(np.abs(sf.cpu().numpy())) / scale)
    return early, late, smax


def train(banks_idx=None, generations: int = GENERATIONS,
          device="cuda") -> dict:
    """Train the banks of BANKS (all, or the indices `banks_idx`); returns
    {"banks": the store's dict, "training": the report}."""
    banks = AdaptiveCoefficientBanks()
    report = {}
    chosen = range(len(BANKS)) if banks_idx is None else banks_idx
    for i in chosen:
        sr, bits, mode = BANKS[i]
        t0 = time.time()
        learner = NoiseShaperLearner(sr, bits, mode=mode, seed=0,
                                     eval_blocks=EVAL_BLOCKS, device=device)
        audio = program_material(sr)
        flat = float(learner._population_costs(np.zeros((1, 9)), audio)[0])
        st = None
        for _ in range(generations):
            st = learner.feed(audio, generations=1)
        banks.store_state(st, sr, bits, mode)
        gain = flat / max(st.best_score, 1e-30)
        early, late, smax = long_run_screen(st.best_coefficients, sr, bits,
                                            device=device)
        # the hard screen: a factory bank must be stationary (no rail, no
        # late-onset burst)
        if not (late < 8.0 and late < 3.0 * early + 1.0):
            raise RuntimeError(f"bank {(sr, bits, mode)} fails the long-run "
                               f"screen: {early:.3f} -> {late:.3f} LSB")
        report[str(coefficient_bank_index(sr, bits, mode))] = {
            "sample_rate": sr, "bit_depth": bits, "mode": mode,
            "ladder": "fir",
            "flat_cost": flat, "best_score": st.best_score,
            "gain_x": round(gain, 2), "generations": st.generations,
            "long_run_rms_lsb": {"early": round(early, 3),
                                 "late": round(late, 3),
                                 "state_max": round(smax, 3)},
            "wall_s": round(time.time() - t0, 1),
            "sim_s": round(learner.sim_seconds, 3),
            "eval_s": round(learner.eval_seconds, 3),
        }
        print(f"bank sr={sr:.0f} bits={bits} mode={mode}: gain {gain:.2f}x "
            f"longrun {early:.2f}->{late:.2f} LSB in {time.time() - t0:.0f}s "
            f"(simulation {learner.sim_seconds:.2f} s, evaluator "
            f"{learner.eval_seconds:.2f} s)", flush=True)
    return {"banks": banks.to_dict(), "training": report}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="convopeq_tpu_torch.train_banks",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="the JSON file to write (the shipped factory "
                         "banks are not a default)")
    ap.add_argument("--banks", type=int, nargs="+",
                    help=f"indices into BANKS (0-{len(BANKS) - 1})")
    ap.add_argument("--generations", type=int, default=GENERATIONS)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    result = train(args.banks, args.generations, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", os.path.normpath(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
