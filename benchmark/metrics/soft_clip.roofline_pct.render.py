"""Share of its roofline that the local 2x soft clip kernel reaches in a
render call: one launch a call over the chain's output, R rows of N
samples; least time from the shapes over its traced device time."""
from benchmark import roofline as rl
from benchmark.harness import roofline_sum


def launches(ctx):
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    least = rl.least_s(*rl.soft_clip_local2x(s["R"], s["N"], item), item)
    return n * least, {"soft_clip_local2x": n}


def read(ctx):
    got = roofline_sum(ctx, (rl.SOFT_CLIP,), launches)
    return None if got is None else 100.0 * got[0] / got[1]
