"""Device operations (kernels, copies, fills) a call, from the trace."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.count() == 0:
        return None
    return t.count() / ctx["traced_calls"]
