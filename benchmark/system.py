"""What every system under test (`benchmark/systems/`) shares: the IR,
made here from the seed and handed to the program and to the reference
alike."""
from __future__ import annotations

import numpy as np


def ir_from_seed(cfg: dict, seed: int) -> np.ndarray:
    """(2, taps) f64 stereo IR: normal noise x exp(-n / (taps / divisor))
    x scale, the two channels drawn in turn from the seed."""
    ir = cfg["ir"]
    n = int(ir["taps"])
    rng = np.random.default_rng([int(seed), 0])
    decay = np.exp(-np.arange(n) / (n / float(ir["decay_divisor"])))
    return np.stack([rng.normal(size=n), rng.normal(size=n)]) * decay \
        * float(ir["scale"])
