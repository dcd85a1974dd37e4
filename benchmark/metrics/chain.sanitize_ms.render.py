"""Stream milliseconds a call in the chain's input sanitize and scalar
pre-gains (the program's "chain.sanitize" span)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, "chain.sanitize")
