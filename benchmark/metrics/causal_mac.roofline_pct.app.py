"""Share of its roofline that the causal frame MAC reaches in the staged
chain's NUC: the least time of its 3 layers x 2 channels a call, each
at its layer's shapes, over the traced device time of every causal_mac
launch, the launch counter checked."""
from benchmark import roofline as rl
from benchmark import roofline_staged as rs
from benchmark.harness import roofline_sum


def launches(ctx):
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    least = s["channels"] * n * rs.nuc_mac_least_s(s["C"], s["N"],
                                                   s["layers"], item)
    name = "causal_mac_c128" if item == 8 else "causal_mac"
    return least, {name: s["channels"] * len(s["layers"]) * n}


def read(ctx):
    got = roofline_sum(ctx, (rl.MAC,), launches)
    return None if got is None else 100.0 * got[0] / got[1]
