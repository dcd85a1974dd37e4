"""Small numeric utilities shared across the DSP chain
(counterpart of convopeq_tpu/utils/dsputil.py).

- `equal_power_sin`: 9th-order Taylor sine of x*pi/2 used for the
  equal-power wet/dry mix (ref: src/convolver/ConvolverProcessor.Runtime.cpp:26-31).
- dB <-> linear conversions follow the usual 20*log10 convention.
"""
from __future__ import annotations

import numpy as np
import torch

# Output headroom applied before dither (= -1 dBFS).
# Ref: src/audioengine/AudioEngine.Processing.DSPCoreDouble.cpp:581
K_OUTPUT_HEADROOM = 0.8912509381337456


def db_to_linear(db):
    return np.power(10.0, np.asarray(db, np.float64) / 20.0)


def equal_power_sin_poly(x):
    """The equalPowerSin polynomial itself — 9th-order Taylor of
    sin(x*pi/2), no libm: works on NumPy arrays and torch tensors alike.

    Ref: equalPowerSin, src/convolver/ConvolverProcessor.Runtime.cpp:26-31.
    """
    t = x * (np.pi * 0.5)
    t2 = t * t
    return t * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0
                + t2 * (-1.0 / 5040.0 + t2 * (1.0 / 362880.0)))))


def equal_power_sin(x):
    """equalPowerSin on host values (mix is configuration, evaluated in
    float64) — wet gain = equal_power_sin(mix), dry gain =
    equal_power_sin(1-mix)."""
    return equal_power_sin_poly(np.asarray(x, np.float64))


def device_constants(cache, key, build, dtype, device, size: int = 64):
    """The host arrays that build() returns, as a tuple of tensors of
    `dtype` on `device`: built and copied once for each (key, dtype,
    device), the `size` most recently used kept in `cache` (an
    OrderedDict)."""
    full = (key, dtype, device)
    got = cache.get(full)
    if got is not None:
        cache.move_to_end(full)
        return got
    got = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                for a in build())
    cache[full] = got
    if len(cache) > size:
        cache.popitem(last=False)
    return got


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (host-side, static shapes only)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()
