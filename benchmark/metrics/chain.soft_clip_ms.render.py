"""Stream milliseconds a call in the chain's local 2x soft
clip (the program's "chain.soft_clip" span)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, "chain.soft_clip")
