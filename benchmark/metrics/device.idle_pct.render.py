"""Share of the traced window in which no device operation ran (the
union of the kernels', copies' and fills' intervals)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.count() == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
