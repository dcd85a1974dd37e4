"""Telemetry, xrun detection, health monitoring and the recovery policy
(counterpart of convopeq_tpu/runtime/telemetry.py; pure Python, the
port's own copy).

Rebuild of the reference's observability plane:
- DiagEvent records and their ring drain (src/LockFreeRingBuffer.h
  DiagEvent 512, AudioEngine.Timer.cpp:155-201): here a bounded
  in-process event log with per-stage microsecond timings and budget
  permille.
- Xrun detection: a step, or the gap since the previous one, longer than
  1.5 x the block period (ARCHITECTURE.md:397) is a deadline miss of the
  streaming runtime (`XrunDetector`).
- RuntimeHealthMonitor (src/audioengine/RuntimeHealthMonitor.h:38-41):
  Healthy / Degraded / Critical with 10 s / 30 s hysteresis.
- RuntimePolicyEngine (src/audioengine/RuntimePolicyEngine.h:50-53): the
  6-level recovery ladder Observe -> Throttle -> Recover -> Restore ->
  Safe -> Critical.
- Evidence export: a JSON dump of the telemetry state (the
  ISREvidenceExporter analog).

Host side: the device computation carries no telemetry; these wrap the
calls that drive it.
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field, asdict
from enum import IntEnum

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


@dataclass
class DiagEvent:
    """RT-safe diagnostic record (DiagEvent analog)."""
    category: str
    seq: int
    t_monotonic: float
    duration_us: float = 0.0
    budget_permille: int = 0
    detail: dict = field(default_factory=dict)


class TelemetryRecorder:
    """Bounded event log + per-stage timing stats (TelemetryRecorder.h)."""

    def __init__(self, capacity: int = 512):
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.seq = 0
        self.stage_stats: dict = {}

    def push(self, category: str, duration_us: float = 0.0,
             budget_permille: int = 0, **detail):
        self.seq += 1
        if self.events.maxlen is not None and \
                len(self.events) == self.events.maxlen:
            self.dropped += 1      # deque evicts the oldest silently
        self.events.append(DiagEvent(category=category, seq=self.seq,
                                     t_monotonic=time.monotonic(),
                                     duration_us=duration_us,
                                     budget_permille=budget_permille,
                                     detail=detail))
        st = self.stage_stats.setdefault(
            category, {"count": 0, "total_us": 0.0, "max_us": 0.0})
        st["count"] += 1
        st["total_us"] += duration_us
        st["max_us"] = max(st["max_us"], duration_us)

    def drain(self):
        out = list(self.events)
        self.events.clear()
        return out

    def export_evidence(self) -> str:
        """ISREvidenceExporter analog: JSON audit dump."""
        return json.dumps({
            "seq": self.seq,
            "dropped": self.dropped,
            "stage_stats": self.stage_stats,
            "recent": [asdict(e) for e in list(self.events)[-32:]],
        }, indent=2)


class StageTimer:
    """Context manager recording a stage's wall time against a budget."""

    def __init__(self, recorder: TelemetryRecorder, category: str,
                 budget_us: float | None = None):
        self.recorder = recorder
        self.category = category
        self.budget_us = budget_us

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        us = (time.perf_counter() - self.t0) * 1e6
        permille = int(us / self.budget_us * 1000) if self.budget_us else 0
        self.recorder.push(self.category, duration_us=us,
                           budget_permille=permille)
        return False


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
