"""Median stream milliseconds of the serving step: the program's "step"
span, from when the stream reached the block's first operation to when
it finished its last."""
from benchmark import spans


def read(ctx):
    return spans.median_stream_ms(ctx, "step")
