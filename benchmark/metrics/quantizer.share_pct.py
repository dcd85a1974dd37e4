"""The quantizer kernel's device time over the traced window."""
from benchmark import roofline as rl


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    q = t.device_time_s(lambda n: rl.is_kernel(n, rl.QUANTIZER))
    return None if q <= 0.0 else 100.0 * q / t.window_s
