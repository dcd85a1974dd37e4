"""Device operations (kernels, copies, fills) a block, from the trace:
the step's own and the block's two copies."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.count() == 0:
        return None
    return t.count() / ctx["traced_steps"]
