"""Stream milliseconds a call in the stereo convolution, the channel
stack included (the program's "chain.conv" span)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, "chain.conv")
