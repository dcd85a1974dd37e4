"""Share of its roofline that the error-feedback quantizer reaches in
the psycho mode: one launch a call over every row and sample of the
batch, 12 feedback coefficients."""
from benchmark import roofline as rl
from benchmark.harness import roofline_sum


def launches(ctx):
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    order = len(ctx["config"]["dither"]["coeffs"])
    least = rl.least_s(*rl.quantizer(s["R"], s["N"], "psycho", order, item),
                       item)
    return n * least, {"error_feedback_quantize": n}


def read(ctx):
    got = roofline_sum(ctx, (rl.QUANTIZER,), launches)
    return None if got is None else 100.0 * got[0] / got[1]
