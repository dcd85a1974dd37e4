"""Share of their roofline that the f64 serving step's frame transforms
reach, counted by the work the layer needs whatever kernel does it: each
traced fire of each NUC layer transforms one overlap-save frame of 2p
samples into p+1 bins (`roofline.osa_rfft`'s count at K = 1) and takes
the valid half of the inverse (`roofline.irfft_valid`), all streams' two
channels in one launch of each.  Least time over the device time of the
forward and inverse families.  The launch counters must show one f64
forward (under either name in F64_FORWARDS) and one f64 inverse a fire,
else None."""
from benchmark import roofline as rl

# the f64 forward transforms a fire may launch: the stacked (prev, cur)
# pair's, or one built frame's
F64_FORWARDS = ("frames_rfft_f64", "osa_rfft_f64")
F64_INVERSE = "irfft_valid_f64"


def launches(ctx):
    """(least seconds, fires) of the traced steps."""
    s, item = ctx["live"], ctx["item"]
    C = s["C"]
    least, fires = 0.0, 0
    for g in range(ctx["first_step"], ctx["first_step"] + ctx["traced_steps"]):
        for p, _, ratio in s["layers"]:
            if g % ratio == ratio - 1:
                least += rl.least_s(*rl.osa_rfft(C, 1, p, item), item) \
                    + rl.least_s(*rl.irfft_valid(C, 1, p, item), item)
                fires += 1
    return least, fires


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("item") != 8:
        return None
    least, fires = launches(ctx)
    got = ctx.get("launches", {})
    if sum(got.get(n, 0) for n in F64_FORWARDS) != fires or \
            got.get(F64_INVERSE, 0) != fires:
        return None
    dev_s = t.device_time_s(
        lambda n: rl.is_kernel(n, rl.FORWARD + rl.INVERSE))
    return None if dev_s <= 0.0 else 100.0 * least / dev_s
