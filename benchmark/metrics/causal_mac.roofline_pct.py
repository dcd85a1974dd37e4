"""Share of its roofline that the causal frame MAC reaches in a render
call: least time from the shapes over its traced device time."""
from benchmark import roofline as rl
from benchmark.harness import roofline_sum


def launches(ctx):
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    least = rl.least_s(*rl.causal_mac(s["C"], s["K"], s["p"], s["P"], item),
                       item)
    name = "causal_mac_c128" if item == 8 else "causal_mac"
    return 2 * n * least, {name: 2 * n}


def read(ctx):
    got = roofline_sum(ctx, (rl.MAC,), launches)
    return None if got is None else 100.0 * got[0] / got[1]
