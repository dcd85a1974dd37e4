"""The headline folded chain (counterpart of bench.py `main()`): a 1M-tap
stereo IR plus the 20-band EQ at 48 kHz, folded into one uniform
partitioned convolution per channel, many independent stereo streams
per call.

    python -m convopeq_tpu_torch.headline [--profile]

prints one JSON line with the realtime factor on the card (64 streams x
60 s, f32; the f64 line is `parity.py`'s headline_f64) and, with
`--profile`, the device time of one call by kernel.  The IR is made
as bench.py makes it (seed 0, decay exp(-n/(ir_len/10)), x0.02, EQ gains
linspace(-4, 4, 20), FilterSpec(48000), block 512); the input is normal
noise x0.25 made on the device from a seed.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .device import card_description, resolve_device
from .models.chain import ChainConfig, FoldedChain, prepare_folded_convolver
from .models.eq import EQParams
from .models.nuc import FilterSpec

SAMPLE_RATE = 48000.0
IR_LEN = 1_000_000
BLOCK_SIZE = 512


def headline_ir(ir_len: int = IR_LEN, seed: int = 0) -> np.ndarray:
    """(2, ir_len) float64 stereo IR, as bench.py:363-366 makes it."""
    rng = np.random.default_rng(seed)
    decay = np.exp(-np.arange(ir_len) / (ir_len / 10.0))
    return np.stack([rng.normal(size=ir_len) * decay,
                     rng.normal(size=ir_len) * decay]) * 0.02


def headline_eq() -> EQParams:
    eqp = EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)   # all 20 bands active
    return eqp


def headline_chain(device="cuda", dtype=torch.float32, ir_len: int = IR_LEN,
                   seed: int = 0, partition="auto") -> FoldedChain:
    """The prepared folded chain (rebuild-time work on the host);
    `partition` as `prepare_folded_convolver` takes it ("auto" or an int
    partition size: one uniform layer; None: the 3-layer plan)."""
    cfg = ChainConfig(sample_rate=SAMPLE_RATE)
    state = prepare_folded_convolver(
        headline_ir(ir_len, seed), BLOCK_SIZE, FilterSpec(SAMPLE_RATE), cfg,
        headline_eq(), dtype=dtype, partition=partition, device=device)
    return FoldedChain(cfg, state)


def headline_input(batch: int, seconds: float, device="cuda",
                   dtype=torch.float32, seed: int = 1):
    """(batch, 2, seconds*48k) noise x0.25, made on `device`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = int(SAMPLE_RATE * seconds)
    return torch.randn((batch, 2, n), generator=gen, device=dev,
                       dtype=dtype) * 0.25


def measure(chain, x, reps: int = 3) -> list:
    """Wall seconds of `reps` calls chain(x) after one warm-up call, each
    fenced by torch.cuda.synchronize()."""
    chain(x)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chain(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def profile_call(fn) -> tuple:
    """Device time of one call fn() after a warm-up call
    (torch.profiler): (wall ms, [(kernel name, device ms, launches)] by
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return wall * 1e3, sorted(rows, key=lambda r: -r[1])


def print_profile(name: str, wall: float, rows: list, card: str) -> None:
    busy = sum(r[1] for r in rows)
    print(f"{name} profiled call: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%) [{card}]")
    for kernel, ms, count in rows:
        print(f"  {ms:9.3f} ms  x{count:<4d} {kernel[:110]}")


def main(argv=()):
    """The headline at its fixed batch: 64 streams x 60 s, f32, on the card."""
    batch, seconds = 64, 60.0
    chain = headline_chain("cuda")
    x = headline_input(batch, seconds, "cuda")
    walls = measure(chain, x)
    print(json.dumps({
        "metric": "RTF 1M-tap stereo IR + 20-band EQ @48kHz, folded",
        "value": batch * seconds / statistics.median(walls),
        "unit": "x realtime",
        "walls_s": walls,
        "batch": batch,
        "device": torch.cuda.get_device_name(0)}))
    if "--profile" in argv:
        print_profile("headline", *profile_call(lambda: chain(x)),
                      card_description())


if __name__ == "__main__":
    main(sys.argv[1:])
