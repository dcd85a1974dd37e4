"""AutoGainPlanner, pure-functional gain staging (counterpart of
convopeq_tpu/models/gain_planner.py; src/audioengine/AutoGainPlanner.{h,cpp}).

Four plan patterns (EQ-only / Conv-only / Conv->EQ / EQ->Conv), margin
constants (EqFirst 1.5 dB, ConvFirst 1.0, InterStage 1.0), the empirical
safety margin min(2.5, max(0, 0.8 + 0.12 (Q - 0.707) + 0.04 gain))
applied only when eqMaxGainDb > 0.5, clamps (input -18..0, trim -12..0,
makeup 0..12), and net-0 dB alignment makeup = clamp(-(input + trim), 0,
12).  The reference computes in float32; so does this, with np.float32
operations, so that the clamp boundaries agree bit for bit.  Host NumPy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# ProcessingOrder (src/audioengine: enum) — Convolver first vs EQ first
CONVOLVER_THEN_EQ = 0
EQ_THEN_CONVOLVER = 1

K_MARGIN_EQ_FIRST = np.float32(1.5)
K_MARGIN_CONV_FIRST = np.float32(1.0)
K_MARGIN_INTER_STAGE = np.float32(1.0)
K_SAFETY_BASE = np.float32(0.8)
K_SAFETY_COEFF_Q = np.float32(0.12)
K_SAFETY_COEFF_GAIN = np.float32(0.04)
K_SAFETY_MAX = np.float32(2.5)
K_BUTTERWORTH_Q = np.float32(0.707)
K_MIN_BOOST_FOR_MARGIN = np.float32(0.5)
K_CLAMP_INPUT = (np.float32(-18.0), np.float32(0.0))
K_CLAMP_TRIM = (np.float32(-12.0), np.float32(0.0))
K_CLAMP_MAKEUP = (np.float32(0.0), np.float32(12.0))


@dataclass
class PlannerInput:
    """AutoGainPlanner.h:51-55."""
    eq_max_gain_db: float = 0.0
    eq_max_q: float = 0.0
    ir_freq_peak_gain_db: float = 0.0


@dataclass
class AutoGainPlan:
    input_headroom_db: float = 0.0
    output_makeup_db: float = 0.0
    convolver_input_trim_db: float = 0.0

    def linear(self):
        """dB -> linear gains (inputHeadroomGain etc. in ProcessingState)."""
        to_lin = lambda db: float(10.0 ** (db / 20.0))
        return (to_lin(self.input_headroom_db),
                to_lin(self.output_makeup_db),
                to_lin(self.convolver_input_trim_db))


def empirical_safety_margin(eq_gain_db, max_q) -> np.float32:
    """EmpiricalSafetyMarginPolicy::evaluate (AutoGainPlanner.h:70-75)."""
    eq_gain_db = np.float32(eq_gain_db)
    max_q = np.float32(max_q)
    if eq_gain_db <= K_MIN_BOOST_FOR_MARGIN:
        return np.float32(0.0)
    q_term = np.maximum(np.float32(0.0), (max_q - K_BUTTERWORTH_Q) * K_SAFETY_COEFF_Q)
    g_term = eq_gain_db * K_SAFETY_COEFF_GAIN
    return np.minimum(K_SAFETY_MAX,
                      np.maximum(np.float32(0.0), K_SAFETY_BASE + q_term + g_term))


def plan(auto_gain_enabled: bool, processing_order: int, eq_bypassed: bool,
         conv_bypassed: bool, inp: PlannerInput) -> AutoGainPlan:
    """AutoGainPlanner::plan (AutoGainPlanner.cpp:15-110)."""
    if not auto_gain_enabled or (eq_bypassed and conv_bypassed):
        return AutoGainPlan()

    f32 = np.float32
    eq_boost = np.maximum(f32(0.0), f32(inp.eq_max_gain_db))
    conv_boost = np.maximum(f32(0.0), f32(inp.ir_freq_peak_gain_db))

    input_db = f32(0.0)
    trim_db = f32(0.0)
    if not eq_bypassed and conv_bypassed:
        q_margin = empirical_safety_margin(inp.eq_max_gain_db, inp.eq_max_q)
        input_db = -np.maximum(f32(0.0), eq_boost - K_MARGIN_EQ_FIRST) - q_margin
    elif eq_bypassed and not conv_bypassed:
        input_db = -np.maximum(f32(0.0), conv_boost - K_MARGIN_CONV_FIRST)
    elif processing_order == CONVOLVER_THEN_EQ:
        q_margin = empirical_safety_margin(inp.eq_max_gain_db, inp.eq_max_q)
        input_db = -(np.maximum(f32(0.0), conv_boost - K_MARGIN_CONV_FIRST)
                     + np.maximum(f32(0.0), eq_boost - K_MARGIN_INTER_STAGE)
                     + q_margin)
    else:  # EQ -> Convolver
        q_margin = empirical_safety_margin(inp.eq_max_gain_db, inp.eq_max_q)
        input_db = -np.maximum(f32(0.0), eq_boost - K_MARGIN_EQ_FIRST) - q_margin
        trim_db = -np.maximum(f32(0.0), conv_boost - K_MARGIN_INTER_STAGE)

    clamped_input = np.clip(input_db, *K_CLAMP_INPUT)
    clamped_trim = np.clip(trim_db, *K_CLAMP_TRIM)
    raw_makeup = -clamped_input - clamped_trim
    clamped_makeup = np.clip(raw_makeup, *K_CLAMP_MAKEUP)
    return AutoGainPlan(input_headroom_db=float(clamped_input),
                        output_makeup_db=float(clamped_makeup),
                        convolver_input_trim_db=float(clamped_trim))
