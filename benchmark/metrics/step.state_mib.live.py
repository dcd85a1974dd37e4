"""MiB of state a stream that the serving step carries: the "state_bytes"
count of the program's traced "step" spans (the step's streams x the
chain's `state_bytes()`) over their "streams" count; None where no
"step" span carries the count."""
from benchmark import spans


def read(ctx):
    got = spans.units(ctx)
    if got is None:
        return None
    per = {r.counts["state_bytes"] / r.counts["streams"]
           for r, _, _ in got[0]
           if r.name == "step" and "state_bytes" in r.counts}
    return per.pop() / 2 ** 20 if len(per) == 1 else None
