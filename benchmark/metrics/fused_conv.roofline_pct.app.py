"""Share of its roofline that the fused convolution reaches in the
staged chain's EQ: one launch a call over both channels' frames (C = R
rows, K = ceil(N / p) frames of the EQ's p, its P partitions), least
time from the shapes over the device time of its three kernels."""
from benchmark import roofline as rl
from benchmark import roofline_staged as rs


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    p, P = s["eq"]
    dev_s, _, rows = rs.split_fused(t)
    if dev_s <= 0.0 or rows != n or ctx.get("launches", {}).get(
            "fused_conv", 0) != n:
        return None
    least = rl.least_s(*rs.fused_conv(s["R"], -(-s["N"] // p), p, P, item),
                       item)
    return 100.0 * n * least / dev_s
