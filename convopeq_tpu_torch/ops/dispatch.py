"""Which form of each kernel runs, and how often each kernel launched.

Every kernel wrapper of this package asks `use_kernel(x)` before it
launches: true for a tensor that is not on the CPU, outside `plain()`.
Otherwise the wrapper runs its reference form:

- On a CPU tensor, outside `plain()`, the forms of the JAX package that
  tier-1 holds the port to, bit for bit.
- Inside `plain()`, on any device, the reference forms below.  This is
  the plain path: the f64 references that the kernels are held to on
  the card (`staged.py`, `parity.py`, `serve.py`, `nuc3.py`,
  `chip_smoke.py`, an engine's `process`).  Every wrapper takes part, so
  a new kernel is in the plain path as soon as its wrapper asks
  `use_kernel`.

| kernel | reference form under `plain()` |
|---|---|
| frame kernels (`frames_rfft`, `osa_rfft`, `causal_mac`, `irfft_valid`) | their `*_plain` versions: torch.fft and the plain MAC |
| `fused_conv` | `fused_conv_plain`: the three plain frame steps |
| soft clip `soft_clip_local2x` | `soft_clip_local2x_plain` |
| IIR cascade `iir_cascade` | `iir_cascade_fft`, from zero state.  Not the CPU's Toeplitz and 2x2 forms: those sit 7.5e-11 (48 kHz) to 5.3e-9 (192 kHz) from the recurrence in f64, over the 1e-12 that the f64 lines are held to |
| quantizer `error_feedback_quantize` | none: it keeps its kernel.  The kernel equals its plain version bit for bit, and the plain version is a loop over time of ~30-60 launches a sample, hours at a render's length |

`plain()` sets a `contextvars.ContextVar`, so a thread that another one
starts inside it (the engine's live learner) still runs the kernels.

`launches()` merges the `launch_counts` dict of every wrapper module in
`WRAPPERS`, and `reset_launches()` zeroes them all.  Each module keeps
its own dict, whose keys the benchmark's systems read by module.
"""
from __future__ import annotations

import contextlib
import contextvars
import importlib

# the modules of this package that launch hand-written kernels
WRAPPERS = ("frame_conv_kernels", "fused_conv_kernels", "softclip",
            "iir_cascade", "quantize_kernels")

_PLAIN = contextvars.ContextVar("convopeq_plain", default=False)


@contextlib.contextmanager
def plain():
    """Run every kernel wrapper's reference form on any device inside."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def in_plain() -> bool:
    return _PLAIN.get()


def use_kernel(x) -> bool:
    """Whether a wrapper launches its kernel on x: x is not on the CPU,
    and the call is outside `plain()`."""
    return x.device.type != "cpu" and not _PLAIN.get()


def _counters():
    return [importlib.import_module(f"{__package__}.{name}").launch_counts
            for name in WRAPPERS]


def launches() -> dict:
    """Every kernel's launches since the last `reset_launches()`."""
    return {k: n for counts in _counters() for k, n in counts.items()}


def reset_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0
