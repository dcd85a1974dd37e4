"""Telemetry, xrun detection, health monitoring and the recovery policy
(counterpart of convopeq_tpu/runtime/telemetry.py; pure Python, the
port's own copy).

Rebuild of the reference's observability plane:
- DiagEvent records and their ring drain (src/LockFreeRingBuffer.h
  DiagEvent 512, AudioEngine.Timer.cpp:155-201): here a bounded
  in-process event log with per-stage microsecond timings: the host's
  and, resolved when read, the stream's.
- Xrun detection: a step, or the gap since the previous one, longer than
  1.5 x the block period (ARCHITECTURE.md:397) is a deadline miss of the
  streaming runtime (`XrunDetector`).
- RuntimeHealthMonitor (src/audioengine/RuntimeHealthMonitor.h:38-41):
  Healthy / Degraded / Critical with 10 s / 30 s hysteresis.
- RuntimePolicyEngine (src/audioengine/RuntimePolicyEngine.h:50-53): the
  6-level recovery ladder Observe -> Throttle -> Recover -> Restore ->
  Safe -> Critical.
- Spans: named regions of the program (`span`), recorded only while a
  `torch.profiler` session records.  Each is a `record_function` range
  in the profiler's trace, so it shares the clock of the device's
  events there, and a record in a bounded in-memory store (`spans()`)
  with its host time, its stream time (on a CUDA device a pair of CUDA
  events, resolved when read: the trace links no kernel to the range
  that launched it) and the counts its caller gives.  With no session
  a span is the shared no-op context `NO_SPAN`.
- Set-up spans (`setup_span`): host seconds of the few one-off steps of
  a (re)build (the fold, the CUDA libraries' load), always recorded, in
  a small dict beside the store (`setup_seconds()`).

Host side: the device computation carries no telemetry; these wrap the
calls that drive it.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum

import torch
from torch.autograd import profiler as _autograd_profiler

XRUN_FACTOR = 1.5                   # ARCHITECTURE.md:397


class Health(IntEnum):
    HEALTHY = 0
    DEGRADED = 1
    CRITICAL = 2


class PolicyLevel(IntEnum):
    """RuntimePolicyEngine ladder (RuntimePolicyEngine.h:50-53)."""
    OBSERVE = 0
    THROTTLE = 1
    RECOVER = 2
    RESTORE = 3
    SAFE = 4
    CRITICAL = 5


class _EventPool:
    """Timing CUDA events for reuse: a span or a stage takes two and
    gives them back once its stream time is read."""

    def __init__(self):
        self._free: list = []

    def take(self):
        try:
            return self._free.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def give(self, *events):
        self._free.extend(events)


_EVENTS = _EventPool()


class _StreamTimer:
    """Stream time of a region whose work runs on `device`: on a CUDA
    device a pair of CUDA events on its current stream, from when the
    stream reached the region's first operation to when it finished its
    last, resolved when `ms` is read (never on the hot path); on any
    other device the work is synchronous, so the region's host time
    stands for it."""

    __slots__ = ("_e0", "_e1", "_ms", "_stream")

    def __init__(self, device):
        self._e0 = self._e1 = self._ms = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._e0 = _EVENTS.take()
            self._e0.record(self._stream)

    def stop(self, host_ms: float):
        if self._e0 is None:
            self._ms = host_ms
        else:
            self._e1 = _EVENTS.take()
            self._e1.record(self._stream)

    def done(self) -> bool:
        """Whether `ms` can be read without waiting."""
        return self._ms is not None or self._e1.query()

    @property
    def ms(self) -> float:
        if self._ms is None:
            self._e1.synchronize()
            self._ms = self._e0.elapsed_time(self._e1)
            _EVENTS.give(self._e0, self._e1)
            self._e0 = self._e1 = None
        return self._ms


@dataclass
class DiagEvent:
    """RT-safe diagnostic record (DiagEvent analog)."""
    category: str
    seq: int
    t_monotonic: float
    duration_us: float = 0.0
    detail: dict = field(default_factory=dict)


class TelemetryRecorder:
    """Bounded event log + per-stage timing stats (TelemetryRecorder.h).

    `stage_stats` holds, a category, the count, total and largest host
    microseconds of its events and, for the stages a `StageTimer` timed,
    the count, total and largest stream microseconds, resolved when
    `stage_stats` is read."""

    def __init__(self, capacity: int = 512):
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.seq = 0
        self._stats: dict = {}
        self._pending: deque = deque()     # (category, _StreamTimer)

    def push(self, category: str, duration_us: float = 0.0, **detail):
        self.seq += 1
        if self.events.maxlen is not None and \
                len(self.events) == self.events.maxlen:
            self.dropped += 1      # deque evicts the oldest silently
        self.events.append(DiagEvent(category=category, seq=self.seq,
                                     t_monotonic=time.monotonic(),
                                     duration_us=duration_us,
                                     detail=detail))
        st = self._stats.setdefault(
            category, {"count": 0, "total_us": 0.0, "max_us": 0.0})
        st["count"] += 1
        st["total_us"] += duration_us
        st["max_us"] = max(st["max_us"], duration_us)

    def push_stream(self, category: str, timer: _StreamTimer):
        """Queue a stage's stream time; those already finished are folded
        into the stats now, the rest when `stage_stats` is read."""
        self._pending.append((category, timer))
        self._resolve(wait=False)

    def _resolve(self, wait: bool):
        while self._pending and (wait or self._pending[0][1].done()):
            category, timer = self._pending.popleft()
            us = timer.ms * 1e3
            st = self._stats[category]
            st["stream_count"] = st.get("stream_count", 0) + 1
            st["stream_total_us"] = st.get("stream_total_us", 0.0) + us
            st["stream_max_us"] = max(st.get("stream_max_us", 0.0), us)

    @property
    def stage_stats(self) -> dict:
        self._resolve(wait=True)
        return self._stats

    def drain(self):
        out = list(self.events)
        self.events.clear()
        return out


class StageTimer:
    """Context manager recording a stage's host time (what the host spent
    enqueueing it) as an event of `category`, and its stream time: on a
    CUDA `device` (the device the stage's work runs on) from a pair of
    CUDA events, resolved when the recorder's `stage_stats` is read, no
    synchronize; with no device, or another, the host time."""

    def __init__(self, recorder: TelemetryRecorder, category: str,
                 device=None):
        self.recorder = recorder
        self.category = category
        self.device = device

    def __enter__(self):
        self._stream = _StreamTimer(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        us = (time.perf_counter() - self.t0) * 1e6
        self._stream.stop(us / 1e3)
        self.recorder.push(self.category, duration_us=us)
        self.recorder.push_stream(self.category, self._stream)
        return False


# ------------------------------------------------------------------ spans

SPAN_CAPACITY = 1 << 14


class Span:
    """One span, its context and, once closed, its record: the name, the
    counts its caller gave, its host interval on the system clock (ns,
    the clock under the profiler's trace) and its stream time on the
    device its work runs on."""

    __slots__ = ("name", "counts", "t0_ns", "t1_ns", "_device", "_range",
                 "_stream")

    def __init__(self, name: str, device, counts: dict):
        self.name, self._device, self.counts = name, device, counts
        self.t1_ns = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        SPANS.add(self)
        self._stream = _StreamTimer(self._device)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        self._stream.stop(self.host_ms)
        self._range.__exit__(*exc)
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def stream_ms(self) -> float:
        return self._stream.ms


class SpanStore:
    """The bounded store of spans, in the order they opened; `dropped`
    counts the spans it evicted."""

    def __init__(self):
        self.records: deque = deque(maxlen=SPAN_CAPACITY)
        self.dropped = 0

    def add(self, rec: Span):
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)

    def resolved(self) -> list:
        """The closed spans in order, each stream time resolved."""
        out = [r for r in list(self.records) if r.t1_ns is not None]
        for r in out:
            r.stream_ms
        return out


SPANS = SpanStore()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def tracing() -> bool:
    """Whether a profiler session records, so that spans are kept."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, device, **counts):
    """A named region of the program whose work runs on `device`, with
    `counts` (ints) for its readers.  With no profiler session the shared
    no-op context `NO_SPAN`; with one, a `record_function` range in the
    trace and a record in the store (`spans`).  A hot path tests
    `tracing()` once and writes `span(...) if on else NO_SPAN`."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return Span(name, device, counts)


def spans() -> list:
    """The store's closed spans in order, stream times resolved."""
    return SPANS.resolved()


_SETUP: dict = {}
_SETUP_OPEN: dict = {}


@contextlib.contextmanager
def setup_span(name: str):
    """A one-off set-up step, always timed on the host: its seconds add
    to `setup_seconds()[name]`.  A span inside another of the same name
    (one fold that calls another) adds nothing of its own.  Usable as a
    decorator."""
    depth = _SETUP_OPEN.get(name, 0)
    _SETUP_OPEN[name] = depth + 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SETUP_OPEN[name] = depth
        if depth == 0:
            ent = _SETUP.setdefault(name, {"seconds": 0.0, "calls": 0})
            ent["seconds"] += time.perf_counter() - t0
            ent["calls"] += 1


def setup_seconds() -> dict:
    """{name: {"seconds": host seconds, "calls": n}} of the process's
    set-up spans."""
    return {k: dict(v) for k, v in _SETUP.items()}


class XrunDetector:
    """Deadline-miss detection for the streaming runtime: a step counts as
    an XRUN when its duration (or the interval since the previous step)
    exceeds 1.5x the block period."""

    def __init__(self, sample_rate: float, block_size: int):
        self.period_s = block_size / sample_rate
        self.threshold_s = self.period_s * XRUN_FACTOR
        self.xruns = 0
        self.steps = 0
        self._last = None

    def record_step(self, duration_s: float, count_xrun: bool = True):
        """count_xrun=False counts the step but can never record an XRUN
        (and resets the inter-step clock): used for blocks whose wall is
        known not to be a DSP deadline miss — the first call, which builds
        the kernels, or the first block after the caller was idle between
        sessions."""
        now = time.monotonic()
        self.steps += 1
        is_xrun = duration_s > self.threshold_s
        if self._last is not None and (now - self._last) > self.threshold_s:
            is_xrun = True
        self._last = now
        if not count_xrun:
            return False
        if is_xrun:
            self.xruns += 1
        return is_xrun


class RuntimeHealthMonitor:
    """Healthy/Degraded/Critical with hysteresis (RuntimeHealthMonitor.h:
    38-41, 331-332: 10 s to de-escalate from Degraded, 30 s from Critical).

    Time injected for testability."""

    DEGRADE_XRUN_RATE = 0.01       # >1% xruns -> Degraded
    CRITICAL_XRUN_RATE = 0.10      # >10% -> Critical
    DEGRADED_HOLD_S = 10.0
    CRITICAL_HOLD_S = 30.0

    def __init__(self, now_fn=time.monotonic):
        self._now = now_fn
        self.health = Health.HEALTHY
        self._last_bad = None
        # bounded transition trace for evidence export (deferred_health)
        self.history: deque = deque(maxlen=64)

    def _transition(self, new: Health, now: float):
        if new != self.health:
            self.history.append({"from": self.health.name, "to": new.name,
                                 "t_monotonic": now})
        self.health = new

    def tick(self, xruns: int, steps: int, failures: int = 0) -> Health:
        rate = xruns / steps if steps else 0.0
        now = self._now()
        target = Health.HEALTHY
        if failures > 0 or rate > self.CRITICAL_XRUN_RATE:
            target = Health.CRITICAL
        elif rate > self.DEGRADE_XRUN_RATE:
            target = Health.DEGRADED

        if target.value >= self.health.value:
            if target != Health.HEALTHY:
                self._last_bad = now
            self._transition(target, now)
            return self.health

        # de-escalation with hysteresis
        hold = (self.CRITICAL_HOLD_S if self.health == Health.CRITICAL
                else self.DEGRADED_HOLD_S)
        if self._last_bad is None or (now - self._last_bad) >= hold:
            self._transition(Health(self.health.value - 1), now)
            if self.health != Health.HEALTHY:
                self._last_bad = now
        return self.health


class RuntimePolicyEngine:
    """6-level recovery ladder (RuntimePolicyEngine.h:50-53): escalates on
    sustained bad health, de-escalates one level per healthy evaluation."""

    def __init__(self):
        self.level = PolicyLevel.OBSERVE
        # bounded transition trace for evidence export (recovery_trace)
        self.history: deque = deque(maxlen=64)

    def evaluate(self, health: Health) -> PolicyLevel:
        prev = self.level
        if health == Health.CRITICAL:
            self.level = PolicyLevel(min(PolicyLevel.CRITICAL,
                                         self.level + 2))
        elif health == Health.DEGRADED:
            self.level = PolicyLevel(min(PolicyLevel.SAFE, self.level + 1))
        elif self.level > PolicyLevel.OBSERVE:
            self.level = PolicyLevel(self.level - 1)
        if self.level != prev:
            self.history.append({"from": prev.name, "to": self.level.name,
                                 "health": health.name,
                                 "t_monotonic": time.monotonic()})
        return self.level

    @property
    def actions(self):
        """Recommended actions at the current level (the policy surface the
        engine exposes; the reference wires these to rebuild throttling,
        crossfade disabling, and safe-mode bypass)."""
        return {
            PolicyLevel.OBSERVE: (),
            PolicyLevel.THROTTLE: ("throttle_rebuilds",),
            PolicyLevel.RECOVER: ("throttle_rebuilds", "flush_caches"),
            PolicyLevel.RESTORE: ("throttle_rebuilds", "flush_caches",
                                  "rebuild_runtime"),
            PolicyLevel.SAFE: ("bypass_convolver", "bypass_eq"),
            PolicyLevel.CRITICAL: ("mute_output",),
        }[self.level]
