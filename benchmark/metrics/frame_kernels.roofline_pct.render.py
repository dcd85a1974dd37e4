"""Share of their roofline that the three frame kernels reach in a
render call: the least time of every traced launch of frames_rfft,
causal_mac and irfft_valid (from the shapes) over their device time."""
from benchmark import roofline as rl
from benchmark.harness import roofline_sum


def launches(ctx):
    s, item, n = ctx["render"], ctx["item"], ctx["traced_calls"]
    C, K, p, P = s["C"], s["K"], s["p"], s["P"]
    least = sum(rl.least_s(*f, item) for f in (
        rl.frames_rfft(C, K, p, item), rl.causal_mac(C, K, p, P, item),
        rl.irfft_valid(C, K, p, item)))
    suffix = ("_f64", "_c128", "_f64") if item == 8 else ("", "", "")
    # one launch of each kernel a channel a call
    want = {k + sfx: 2 * n for k, sfx in zip(
        ("frames_rfft", "causal_mac", "irfft_valid"), suffix)}
    return 2 * n * least, want


def read(ctx):
    got = roofline_sum(ctx, (rl.FORWARD, rl.MAC, rl.INVERSE), launches)
    return None if got is None else 100.0 * got[0] / got[1]
