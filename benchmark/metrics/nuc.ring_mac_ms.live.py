"""Stream milliseconds a block in the NUC layers' ring MACs: every
"nuc.L<p>.mac" span (the tail partitions of a block, the whole ring of
the immediate layer, a fire's newest partition)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, spans.is_mac)
