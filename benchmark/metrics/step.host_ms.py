"""Host milliseconds from the live system's step call to its return,
median over the window's blocks (host clock)."""
import numpy as np


def read(ctx):
    h = ctx.get("host_ms")
    return None if h is None or len(h) == 0 else float(np.median(h))
