"""The one traffic generator, driven by a mix's data file
(`benchmark/traffic/<name>.json`), and the two loops that offer it.

kind "render", a closed loop with one caller: `batches` batches of
`batch` stereo streams of `seconds` of audio (normal noise x
`amplitude`, with the uniforms of the dither when the configuration
dithers) are made on the device from the seed during set-up; the
window calls the chain on them in turn, back to back, each call ending
in a synchronize, until `--seconds` have passed.

kind "live", an open loop: every block period one block of
`block_size` samples is due for each of `streams` stereo streams,
whether or not the last one finished.  A block goes host pinned input
-> device -> one step of the streaming chain -> host pinned output; its
latency runs from when it was due to when its output is in host memory.
The inputs come from a pool of `pool_blocks` distinct blocks a stream
(made on the device from the seed, kept in pinned host memory), block b
taking pool slot `slots[b]`, drawn from the seed.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from . import trace as tr


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _span(name: str, on: bool):
    return tr.span(name) if on else contextlib.nullcontext()


def _spin_sync(dev):
    """Wait for the device's work so far by polling an event."""
    if dev.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        while not ev.query():
            pass


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def _traced(segment, launch_counts) -> dict:
    """The segment's trace and the system's kernel launches in it, from
    its counters `launch_counts()`."""
    before = launch_counts()
    t = tr.profile(segment)
    after = launch_counts()
    return {"trace": t, "launches": {k: after[k] - before[k] for k in after}}


def render_inputs(traffic: dict, cfg: dict, seed: int, dev, dither: bool):
    """[(x (B, 2, N), u (B, 2, N, 2) or None)] a batch, in the
    configuration's type, on `dev`, from one generator seeded by `seed`."""
    dt = torch.float64 if cfg["dtype"] == "float64" else torch.float32
    n = int(round(float(traffic["seconds"]) * float(cfg["sample_rate"])))
    shape = (int(traffic["batch"]), 2, n)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = []
    for _ in range(int(traffic["batches"])):
        x = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        x.mul_(float(traffic["amplitude"]))
        u = (torch.rand(shape + (2,), generator=gen, device=dev, dtype=dt)
             if dither else None)
        out.append((x, u))
    return out


def run_render(system, inputs, seconds: float, trace: bool, t_setup0,
               launch_counts):
    """The closed loop.  Returns a dict: calls, wall_s, setup_s, peak,
    the last output of each batch, and the traced segment (or None)."""
    dev = inputs[0][0].device
    outs = [system.call(x, u) for x, u in inputs]       # warm-up, each shape
    _sync(dev)
    _reset_peak(dev)
    nb = len(inputs)
    gc.collect()
    t0 = time.perf_counter()
    setup_s = t_setup0(t0)
    calls = 0
    while True:
        k = calls % nb
        outs[k] = None
        outs[k] = system.call(*inputs[k])
        _sync(dev)
        calls += 1
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
    wall = t - t0
    peak = _peak_bytes(dev)
    seg = None
    if trace:
        n_trace = max(nb, min(64, math.ceil(1.0 / (wall / calls))))

        def segment():
            for i in range(n_trace):
                with tr.span("bench.call"):
                    y = system.call(*inputs[i % nb])
                    _sync(dev)
                del y
        seg = {**_traced(segment, launch_counts), "calls": n_trace}
    return {"calls": calls, "wall_s": wall, "setup_s": setup_s,
            "peak_bytes": peak, "outputs": outs, "segment": seg}


class LiveFeed:
    """The pool of input blocks and the slot each block takes."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, dev,
                 n_blocks: int, block: int):
        streams = int(traffic["streams"])
        P = int(traffic["pool_blocks"])
        dt = torch.float64 if cfg["dtype"] == "float64" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        pool = torch.randn((P, streams, 2, block), generator=gen, device=dev,
                           dtype=dt).mul_(float(traffic["amplitude"]))
        self.pool = torch.empty(pool.shape, dtype=dt,
                                pin_memory=dev.type == "cuda")
        self.pool.copy_(pool)
        del pool
        rng = np.random.default_rng([int(seed), 1])
        self.slots = rng.integers(0, P, size=n_blocks)
        self.block = block

    def stream_input(self, s: int, n_blocks: int) -> np.ndarray:
        """(2, n_blocks x block) input of stream s from block 0."""
        blocks = self.pool[self.slots[:n_blocks], s].numpy()
        return blocks.transpose(1, 0, 2).reshape(2, -1)


def run_live(system, feed: LiveFeed, traffic: dict, n_window: int,
             period_s: float, trace: bool, keep, t_setup0, warm: int,
             n_trace: int, dev, launch_counts):
    """The open loop: `warm` blocks on a throwaway state, then the window
    of `n_window` blocks from a fresh state, then, when traced, `n_trace`
    more blocks under the profiler.  keep: the streams whose output is
    kept for the check.  Returns latencies, host step times, the
    generator's lateness, the kept output, peak and the segment."""
    streams = int(traffic["streams"])
    block = feed.block
    out = torch.empty((streams, 2, block), dtype=feed.pool.dtype,
                      pin_memory=dev.type == "cuda")
    out_np = out.numpy()

    state = system.init_state(streams)
    for b in range(warm):
        state, y = system.step(state, feed.pool[feed.slots[b]].to(
            dev, non_blocking=True))
        out.copy_(y, non_blocking=True)
    _sync(dev)
    del state, y
    state = system.init_state(streams)
    _sync(dev)
    _reset_peak(dev)
    kept = np.empty((len(keep), 2, n_window * block), dtype=out_np.dtype)
    lat = np.empty(n_window)
    host = np.empty(n_window)
    gen_late = []
    failed = 0

    def one(b, due, spans=False):
        # the loop never sleeps: it spins until the block is due and polls
        # the copy's completion, as a real-time audio thread does; a
        # sleeping or blocking wait wakes up to ~10 ms late on a shared host
        now = time.perf_counter()
        if now < due:
            with _span("bench.wait", spans):
                while time.perf_counter() < due:
                    pass
            now = time.perf_counter()
            gen_late.append(now - due)
        with _span("bench.h2d", spans):
            x = feed.pool[feed.slots[b]].to(dev, non_blocking=True)
        t_call = time.perf_counter()
        with _span("bench.step", spans):
            st, y = system.step(state, x)
        t_ret = time.perf_counter()
        with _span("bench.d2h", spans):
            out.copy_(y, non_blocking=True)
            _spin_sync(dev)
        done = time.perf_counter()
        return st, done - due, t_ret - t_call

    gc.collect()
    t0 = time.perf_counter() + period_s
    setup_s = t_setup0(t0)
    for b in range(n_window):
        state, lat[b], host[b] = one(b, t0 + b * period_s)
        if not math.isfinite(float(out_np.sum())):
            failed += 1
            lat[b] = math.inf
        kept[:, :, b * block:(b + 1) * block] = out_np[keep]
    peak = _peak_bytes(dev)
    late_gen = list(gen_late)
    seg = None
    if trace:
        def segment():
            nonlocal state
            t1 = time.perf_counter() + period_s
            for i in range(n_trace):
                state, _, _ = one(n_window + i, t1 + i * period_s, True)
        seg = {**_traced(segment, launch_counts), "steps": n_trace,
               "first_step": n_window}
    del state
    return {"latency_s": lat, "host_s": host, "generator_late_s": late_gen,
            "failed": failed, "kept": kept, "peak_bytes": peak,
            "setup_s": setup_s, "segment": seg}

