"""One traced segment of a run: torch.profiler over the host and the
device, read back from its Chrome trace.

The segment runs after the measured window, so the end-to-end metrics
never carry the profiler's cost.  The harness marks its own phases with
`span(name)` (record_function): "bench.segment" around the whole
segment, and "bench.call", "bench.wait", "bench.h2d", "bench.step",
"bench.d2h" inside it.  From the trace come the device's intervals
(kernels, copies, fills), their union (busy) over the segment's window,
the idle gaps between them labelled by the innermost host event that
covers each gap, and the device time by operation name.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SEGMENT = "bench.segment"


def span(name: str):
    return torch.profiler.record_function(name)


class Trace:
    """Device events [(name, start_us, dur_us)], host events, and the
    segment's window [t0, t1] in microseconds."""

    def __init__(self, device, host, window):
        self.device = device
        self.host = host
        self.t0, self.t1 = window

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self):
        """The device events' union inside the window, merged, sorted."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d in self.device)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def device_time_s(self, match=None) -> float:
        """Summed device time of the events whose name passes `match`."""
        return sum(d for n, _, d in self.device
                   if match is None or match(n)) / 1e6

    def count(self, match=None) -> int:
        return sum(1 for n, _, _ in self.device if match is None or match(n))

    def top_ops(self, k: int = 10):
        by = {}
        for n, _, d in self.device:
            by[n[:120]] = by.get(n[:120], 0.0) + d / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda r: -r[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The k longest gaps in the device's union, each with the name of
        the innermost host event covering the gap's middle."""
        edges, prev = [], self.t0
        for s, e in self.intervals():
            if s > prev:
                edges.append((prev, s))
            prev = e
        if self.t1 > prev:
            edges.append((prev, self.t1))
        edges.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in edges[:k]:
            mid = 0.5 * (s + e)
            cover = [(d, n) for n, hs, d in self.host if hs <= mid <= hs + d]
            out.append([min(cover)[1] if cover else "host idle",
                        (e - s) / 1e6])
        return out


def profile(segment) -> Trace:
    """Run segment() under torch.profiler (host and device) inside a
    "bench.segment" span and read the trace back."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        with span(SEGMENT):
            segment()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        rec = (name, float(ev["ts"]), float(ev.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(rec)
        elif cat in HOST_CATS:
            if name == SEGMENT:
                window = (rec[1], rec[1] + rec[2])
            else:
                host.append(rec)
    if window is None:
        raise RuntimeError("the profiler recorded no bench.segment span")
    return Trace(device, host, window)
