"""Device milliseconds a call outside the port's hand-written kernels
(eager elementwise, cuFFT, GEMMs, copies, fills), from the trace."""
from benchmark.roofline import PORT_KERNELS, is_kernel


def read(ctx):
    t = ctx["trace"]
    if t is None or t.count() == 0:
        return None
    return 1e3 * t.device_time_s(lambda n: not is_kernel(n, PORT_KERNELS)) \
        / ctx["traced_calls"]
