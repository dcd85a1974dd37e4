"""Stream milliseconds a call in the dither outside its quantizer: the
program's "dither" span less its "dither.quantize" child."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, "dither", child="dither.quantize")
