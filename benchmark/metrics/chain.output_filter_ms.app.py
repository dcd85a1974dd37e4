"""Stream milliseconds a call in the staged chain's output filter, its
biquad scans (the program's "chain.output_filter" span)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, "chain.output_filter")
