"""Share of their roofline that the serving step's frame transforms
reach: every traced fire of each NUC layer (the forward of the built
[prev | cur] frame and the valid half of the inverse, all streams' two
channels in one launch), least time from the shapes over device time."""
from benchmark import roofline as rl
from benchmark.harness import roofline_sum


def launches(ctx):
    s, item = ctx["live"], ctx["item"]
    C = s["C"]
    least, fires = 0.0, 0
    for g in range(ctx["first_step"], ctx["first_step"] + ctx["traced_steps"]):
        for p, _, ratio in s["layers"]:
            if g % ratio == ratio - 1:
                fwd = (rl.frames_rfft(C, 2, p, item) if item == 8
                       else rl.osa_rfft(C, 1, p, item))
                least += rl.least_s(*fwd, item) + rl.least_s(
                    *rl.irfft_valid(C, 1, p, item), item)
                fires += 1
    names = (("frames_rfft_f64", "irfft_valid_f64") if item == 8
             else ("osa_rfft", "irfft_valid"))
    return least, {n: fires for n in names}


def read(ctx):
    got = roofline_sum(ctx, (rl.FORWARD, rl.INVERSE), launches)
    return None if got is None else 100.0 * got[0] / got[1]
