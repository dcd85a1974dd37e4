"""Native-fronted serving: the C++ block scheduler driving the port's
StreamingChain (counterpart of convopeq_tpu/runtime/native_serving.py).

The reference's serving plane is its audio callback: the ISR hands the
engine one block, the engine must return inside the budget, and block
transport around the DSP core rides lock-free rings
(AudioEngine.Processing.BlockDouble.cpp; LockFreeAudioRingBuffer.h).
Here the plane is split in two:

- **native side** (native/convopeq_native.cpp `cq_sched_*`, bound by
  utils/native.py): per-stream SPSC input and output rings of stereo
  blocks, batch gather / commit framing and deadline accounting (an xrun
  when a window's wall exceeds 1.5x its budget), lock-free C++;
- **device side**: one `StreamingChain.step` per gather, batched over
  all streams.  A stream with no input ready is zero-filled (an underrun
  plays silence): its state advances, its output is not committed.

`NativeServingLoop.serve` is the dispatcher: producer threads
`push(stream, block)` (one producer a stream: SPSC), consumers
`pop(stream)` processed blocks, and the loop gathers, steps and commits
until it has served the requested number of windows.  ctypes releases
the GIL around each native call, so the producers and consumers run
while the dispatcher waits on the card.

On the card the batch is gathered straight into a pinned host buffer,
copied to the device, stepped, and the output copied back into a second
pinned buffer; the window's wall runs from the host-to-device copy to
the synchronize after the device-to-host one (the fence), and only then
is the output committed and the next batch gathered over the input
buffer.  `host_ns` and `host_cpu_ns` add up, over the served windows,
the dispatcher's host part of the wall (from the copy's issue to the
step's return) and the CPU time its thread spent in it: the difference
is time the dispatcher waited on the host (the GIL, the OS scheduler).
The step updates the chain's state in place, so the warm-up runs on a
throwaway state.
"""
from __future__ import annotations

import time

import torch

from ..utils.native import NativeBlockScheduler


class NativeServingLoop:
    """Dispatcher between the native block scheduler and a StreamingChain."""

    def __init__(self, chain, n_streams: int, capacity_blocks: int = 64,
                 xrun_factor: float = 1.5, warmup: bool = True,
                 window_samples: int | None = None):
        """window_samples: samples a dispatch unit (default one engine
        block).  The windowed serving tiers (bigblock: partition =
        block x M) dispatch M engine blocks a step; the native rings then
        frame window-sized chunks: the same lock-free plane, fewer and
        larger windows (the deadline budget scales with the window)."""
        self.chain = chain
        self.n_streams = n_streams
        self.block = int(window_samples or chain.block_size)
        self.sched = NativeBlockScheduler(
            n_streams, self.block, chain.cfg.sample_rate,
            capacity_blocks=capacity_blocks, xrun_factor=xrun_factor)
        self.device = chain.device
        self.state = chain.init_state((n_streams,))
        pin = self.device.type == "cuda"
        shape = (n_streams, 2, self.block)
        self._in = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
        self._out = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
        self._in_np = self._in.numpy()
        self._out_np = self._out.numpy()
        self.windows = 0
        self.host_ns = 0
        self.host_cpu_ns = 0
        if warmup:
            # prepareToPlay analog: the kernels build and the first
            # launches run on silence, on a throwaway state (the step
            # updates its state in place)
            z = torch.zeros(shape, dtype=chain.dtype, device=self.device)
            _, y = chain.step(chain.init_state((n_streams,)), z)
            self._fence(y)

    def _fence(self, y):
        """y (n, 2, block) to the pinned output buffer, synchronized."""
        self._out.copy_(y, non_blocking=self.device.type == "cuda")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # producer / consumer pass-throughs -------------------------------
    def push(self, stream: int, block2ch) -> bool:
        return self.sched.push(stream, block2ch)

    def pop(self, stream: int):
        return self.sched.pop(stream)

    def stats(self) -> dict:
        return self.sched.stats()

    # dispatcher ------------------------------------------------------
    def serve_window(self) -> int:
        """One gather -> step -> commit cycle.  Returns the number of
        ready streams served (0 = nothing was ready; state untouched)."""
        _, mask, n = self.sched.gather(self._in_np)
        if n == 0:
            return 0
        t0 = time.perf_counter_ns()
        c0 = time.thread_time_ns()
        x = self._in.to(self.device, non_blocking=True)
        self.state, y = self.chain.step(self.state, x)
        self.host_ns += time.perf_counter_ns() - t0
        self.host_cpu_ns += time.thread_time_ns() - c0
        self._fence(y)          # the wall includes the copy back
        wall_ns = time.perf_counter_ns() - t0
        self.sched.commit(self._out_np, mask, wall_ns)
        self.windows += 1
        return int(n)

    def serve(self, n_windows: int, idle_sleep_s: float = 2e-4,
              timeout_s: float = 60.0) -> dict:
        """Serve until `n_windows` non-empty windows completed (or
        timeout).  Returns the native stats dict."""
        deadline = time.monotonic() + timeout_s
        done = 0
        while done < n_windows:
            if self.serve_window():
                done += 1
            else:
                if time.monotonic() > deadline:
                    break
                time.sleep(idle_sleep_s)
        return self.stats()
