"""Share of their roofline that the three frame kernels reach in the
staged chain's NUC: the least time of every traced launch of
frames_rfft, causal_mac and irfft_valid, a launch of each a layer and a
channel at the layer's shapes, over their device time (the fused
convolution's passes, which share two of their names, left out)."""
from benchmark import roofline_staged as rs


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    launches = s["channels"] * len(s["layers"]) * n
    got = ctx.get("launches", {})
    _, dev_s, _ = rs.split_fused(t)
    if dev_s <= 0.0 or any(got.get(k, 0) != launches for k in (
            "frames_rfft", "causal_mac", "irfft_valid")):
        return None
    least = s["channels"] * n * rs.nuc_frame_kernels_least_s(
        s["C"], s["N"], s["layers"], item)
    return 100.0 * least / dev_s
