"""Host milliseconds a block of the step's NUC layers, scaled to the
untraced step: the window's median `step.host_ms` (host clock, no
profiler) times the share of the traced step's host time that its
"step.conv" span takes, the cost of the spans nested in each taken out
of both.  The profiler's own cost for each operator stays in both and
is taken to fall on the two in proportion."""
import numpy as np

from benchmark import spans


def read(ctx):
    share = spans.host_share(ctx, "step.conv", "step")
    h = ctx.get("host_ms")
    if share is None or h is None or len(h) == 0:
        return None
    return share * float(np.median(h))
