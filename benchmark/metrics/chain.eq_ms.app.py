"""Stream milliseconds a call in the staged chain's EQ, its bands and
its AGC (the program's "chain.eq" span)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, "chain.eq")
