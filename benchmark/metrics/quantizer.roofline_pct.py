"""Share of its roofline that the error-feedback quantizer reaches: one
launch a call over every row and sample of the batch."""
from benchmark import roofline as rl
from benchmark.harness import roofline_sum

MODES = {"fir": "lattice_fir", "reference": "lattice"}


def launches(ctx):
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    d = ctx["config"]["dither"]
    least = rl.least_s(*rl.quantizer(s["R"], s["N"], MODES[d["ladder"]],
                                     len(d["reflection_coeffs"]), item),
                       item)
    return n * least, {"error_feedback_quantize": n}


def read(ctx):
    if ctx["config"].get("dither") is None:
        return None
    got = roofline_sum(ctx, (rl.QUANTIZER,), launches)
    return None if got is None else 100.0 * got[0] / got[1]
