"""Stream milliseconds a call in the chain's output DC
blocker (the program's "chain.dc_block" span)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, "chain.dc_block")
