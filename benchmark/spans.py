"""The program's own spans in a traced segment, paired with the records
of its span store (`convopeq_tpu_torch.runtime.telemetry`).

While the profiler records, the program opens named spans ("chain",
"chain.conv", "dither.quantize", "step", "nuc.L512.mac", ...): each is a
`user_annotation` range in the trace, on the device events' clock, and
a record in the program's bounded store with its stream milliseconds
and the counts its caller gave.  The stream time comes from the
program's own pair of CUDA events, because the trace as `trace.py`
keeps it links no kernel to the range that launched it.
`paired(ctx)` takes the segment's program spans in order and pairs
them one to one, by name and order, with the store's newest records,
each with the index of the span it nests in (from the trace's
intervals).  It gives nothing when the two disagree (a record dropped
from the store, a span missing from the trace) or when the program
keeps no such store, and every reader then returns None, as
`roofline_sum` does when the launch counters disagree with the shapes.

The set-up spans ("setup.fold", "setup.build") are host seconds the
program keeps apart from the store (`setup_seconds`).
"""
from __future__ import annotations

import statistics

PROGRAM = frozenset(("chain", "dither", "step", "nuc"))


def _telemetry():
    try:
        from convopeq_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    return telemetry


def paired(ctx):
    """[(record, (name, start_us, dur_us), parent)] of the traced
    segment's program spans in the order they opened, parent the index
    of the innermost span around it (None at the top); or None."""
    t = ctx.get("trace")
    tel = _telemetry()
    if t is None or not hasattr(tel, "spans"):
        return None
    events = sorted((e for e in t.host if e[0].split(".", 1)[0] in PROGRAM),
                    key=lambda e: (e[1], -e[2]))
    records = tel.spans()
    n = len(events)
    if n == 0 or n > len(records):
        return None
    records = records[-n:]
    if any(r.name != e[0] for r, e in zip(records, events)):
        return None
    out, open_ = [], []
    for i, (r, e) in enumerate(zip(records, events)):
        while open_ and events[open_[-1]][1] + events[open_[-1]][2] < \
                e[1] + e[2]:
            open_.pop()
        out.append((r, e, open_[-1] if open_ else None))
        open_.append(i)
    return out


def units(ctx):
    """(the segment's paired spans, the number of calls or blocks it
    traced) when each call holds one "chain" span or each block one
    "step" span; None otherwise."""
    pairs = paired(ctx)
    if pairs is None:
        return None
    unit, n = (("chain", ctx.get("traced_calls")) if ctx["kind"] == "render"
               else ("step", ctx.get("traced_steps")))
    if not n or sum(1 for r, _, _ in pairs if r.name == unit) != n:
        return None
    return pairs, n


def _match(name):
    return name if callable(name) else (lambda s: s == name)


def stream_ms_each(ctx, name, child=None):
    """Stream milliseconds a call or block in the spans `name` (a name
    or a predicate), less those of their direct children that `child`
    matches; None when nothing matches."""
    got = units(ctx)
    if got is None:
        return None
    pairs, n = got
    match = _match(name)
    picked = {i for i, (r, _, _) in enumerate(pairs) if match(r.name)}
    if not picked:
        return None
    total = sum(pairs[i][0].stream_ms for i in picked)
    if child is not None:
        cm = _match(child)
        total -= sum(r.stream_ms for r, _, parent in pairs
                     if parent in picked and cm(r.name))
    return total / n


def median_stream_ms(ctx, name):
    """Median over the spans `name` of their stream milliseconds; None
    when none."""
    got = units(ctx)
    if got is None:
        return None
    vals = [r.stream_ms for r, _, _ in got[0] if r.name == name]
    return statistics.median(vals) if vals else None


def host_share(ctx, name, whole):
    """Share of the host time of the spans `whole` that their spans
    `name` take, each span's host interval less the cost of the spans
    nested in it (a nested span's duration in the trace less its own
    host interval: the profiler's range, the store and the CUDA
    events); None when either has none."""
    got = units(ctx)
    if got is None:
        return None
    pairs = got[0]
    cost = [0.0] * len(pairs)
    for i in range(len(pairs) - 1, -1, -1):
        r, e, parent = pairs[i]
        if parent is not None:
            cost[parent] += e[2] / 1e3 - r.host_ms + cost[i]

    def host(nm):
        return sum(r.host_ms - cost[i] for i, (r, _, _) in enumerate(pairs)
                   if r.name == nm)
    part, all_ = host(name), host(whole)
    return None if part <= 0.0 or all_ <= 0.0 else part / all_


def setup_seconds(name: str):
    """Host seconds the process spent in the set-up span `name` (0 when
    it never opened one); None when the program keeps no such record."""
    tel = _telemetry()
    if not hasattr(tel, "setup_seconds"):
        return None
    return float(tel.setup_seconds().get(name, {}).get("seconds", 0.0))


def is_mac(name: str) -> bool:
    return name.startswith("nuc.") and name.endswith(".mac")


def is_fire(name: str) -> bool:
    return name.startswith("nuc.") and name.endswith(".fire")
