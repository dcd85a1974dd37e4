"""Share of the window's blocks whose output reached the host later than
late_factor (1.5, the reference's xrun rule) block periods after the
block was due; a failed block counts as late."""
import numpy as np


def read(ctx):
    lat = ctx.get("latency_ms")
    if lat is None or len(lat) == 0:
        return None
    late = ~(lat <= ctx["late_factor"] * ctx["period_ms"])
    return 100.0 * float(np.count_nonzero(late)) / len(lat)
