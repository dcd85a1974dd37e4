"""Output conditioning filter coefficients (counterpart of
convopeq_tpu/models/output_filter.py:22-74; src/OutputFilter.{h,cpp}).

Two mutually-exclusive chains, each 3 cascaded RBJ biquads:
- convolver-last: HC stage0 -> HC stage1 -> LC
- EQ-last: HPF (Butt-2, 20 Hz) -> LP stage0 -> LP stage1
Coefficients host NumPy f64 (makeLPF/makeHPF, OutputFilter.cpp:25-73);
`output_filter_process` runs the cascade on the signal's device, each
biquad through `biquad_df2t_scan`'s "auto" route (JAX :77-100).
"""
from __future__ import annotations

import numpy as np

from ..ops.scan_iir import biquad_df2t_scan

HC_SHARP, HC_NATURAL, HC_SOFT = 0, 1, 2
LC_NATURAL, LC_SOFT = 0, 1

IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0)


def make_lpf(fc, q, fs):
    """RBJ cookbook LPF (OutputFilter.cpp:25-45); identity when fc >= 0.4999 fs."""
    if fc >= fs * 0.4999 or q <= 0.0 or fs <= 0.0:
        return IDENTITY
    w0 = 2.0 * np.pi * fc / fs
    sn, cs = np.sin(w0), np.cos(w0)
    alpha = sn / (2.0 * q)
    a0inv = 1.0 / (1.0 + alpha)
    return ((1.0 - cs) * 0.5 * a0inv, (1.0 - cs) * a0inv,
            (1.0 - cs) * 0.5 * a0inv, (-2.0 * cs) * a0inv,
            (1.0 - alpha) * a0inv)


def make_hpf(fc, q, fs):
    """RBJ cookbook HPF (OutputFilter.cpp:47-67)."""
    if fc <= 0.0 or fc >= fs * 0.4999 or q <= 0.0 or fs <= 0.0:
        return IDENTITY
    w0 = 2.0 * np.pi * fc / fs
    sn, cs = np.sin(w0), np.cos(w0)
    alpha = sn / (2.0 * q)
    a0inv = 1.0 / (1.0 + alpha)
    return ((1.0 + cs) * 0.5 * a0inv, -(1.0 + cs) * a0inv,
            (1.0 + cs) * 0.5 * a0inv, (-2.0 * cs) * a0inv,
            (1.0 - alpha) * a0inv)


def output_filter_coeffs(sample_rate: float):
    """prepare() tables (OutputFilter.cpp:79-125)."""
    fs = sample_rate
    fc_hc = 19000.0 if fs <= 48000.0 else 22000.0
    fc_lp = 19000.0 if fs <= 48000.0 else 24000.0
    hc = {
        HC_SHARP: (make_lpf(fc_hc, 0.54120, fs), make_lpf(fc_hc, 1.30656, fs)),
        HC_NATURAL: (make_lpf(fc_hc, 0.70711, fs), make_lpf(fc_hc, 0.70711, fs)),
        HC_SOFT: (make_lpf(fc_hc, 0.5, fs), IDENTITY),
    }
    lc = {
        LC_NATURAL: make_hpf(18.0, 0.70711, fs),
        LC_SOFT: make_hpf(15.0, 0.5, fs),
    }
    hpf = make_hpf(20.0, 0.70711, fs)
    lp = {
        HC_SHARP: (make_lpf(fc_lp, 1.0, fs), make_lpf(fc_lp, 1.0, fs)),
        HC_NATURAL: (make_lpf(fc_lp, 0.70711, fs), make_lpf(fc_lp, 0.70711, fs)),
        HC_SOFT: (make_lpf(fc_lp, 0.5, fs), make_lpf(fc_lp, 0.5, fs)),
    }
    return {"hc": hc, "lc": lc, "hpf": hpf, "lp": lp}


def _biquad(x, c):
    if tuple(c) == IDENTITY:
        return x
    y, _ = biquad_df2t_scan(x, *c)
    return y


def output_filter_process(x, sample_rate: float, conv_is_last: bool,
                          hc_mode: int = HC_NATURAL, lc_mode: int = LC_NATURAL,
                          lp_mode: int = HC_NATURAL):
    """process() (OutputFilter.cpp:200+): the 3-biquad cascade of the
    static modes from zero state, on x (..., N)."""
    coeffs = output_filter_coeffs(sample_rate)
    if conv_is_last:
        stages = (coeffs["hc"][hc_mode][0], coeffs["hc"][hc_mode][1],
                  coeffs["lc"][lc_mode])
    else:
        stages = (coeffs["hpf"], coeffs["lp"][lp_mode][0],
                  coeffs["lp"][lp_mode][1])
    for c in stages:
        x = _biquad(x, c)
    return x
