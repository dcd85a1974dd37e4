"""Stream milliseconds a block in the NUC layers' fires outside their
MAC: every "nuc.L<p>.fire" span (forward transform, FDL write, inverse,
output-ring write) less its "nuc.L<p>.mac" child, which
nuc.ring_mac_ms.live reads."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_each(ctx, spans.is_fire, child=spans.is_mac)
