"""The port's AutoGainPlanner (models/gain_planner.py), EQ estimators
(engine/eq_analysis.py), IR resampler (ir/resample.py) and IR peak gain
(ir/analyzer.py) against the reference binary's vectors and against
convopeq_tpu's functions on the CPU, and config3's planner set-up
(staged.config3_setup, which config3.py folds) against the JAX
package's.

Tolerances: `autogain.json` 1e-6 dB and bit for bit against the JAX
planner (both np.float32 arithmetic); `eq_full.json`'s analysis entries
measured 1e-4 dB, upper bound 2e-3 dB, max Q 1e-6 and `resampler.json`
relative RMS < 5e-7 (tests/test_ref_vectors.py:64-88, :807-877); every
host-f64 function against its JAX twin at 1e-12 relative."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from convopeq_tpu.engine import eq_analysis as j_ana
from convopeq_tpu.ir import analyzer as j_irana
from convopeq_tpu.ir import resample as j_res
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import gain_planner as j_gp
from convopeq_tpu_torch import convert, staged
from convopeq_tpu_torch.engine import eq_analysis as t_ana
from convopeq_tpu_torch.ir import analyzer as t_irana
from convopeq_tpu_torch.ir import resample as t_res
from convopeq_tpu_torch.models import eq as t_eq
from convopeq_tpu_torch.models import gain_planner as t_gp

VEC = Path(__file__).resolve().parent / "ref_harness" / "vectors"


def _load(name):
    return json.loads((VEC / name).read_text())


def _port_params(p):
    return convert.eq_params_from_arrays(
        p.band_types, p.freqs, p.gains_db, p.qs, p.modes, p.enabled,
        p.structure, p.saturation, p.agc_enabled)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.sqrt(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2)))


@pytest.fixture(scope="module")
def autogain_rows():
    return _load("autogain.json")


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("enabled", [0, 1])
def test_autogain_planner_matches_reference_binary(autogain_rows, enabled,
                                                   order):
    """Every row of the reference binary's planner dump with this
    (enabled, order) within 1e-6 dB, and equal to the JAX planner's."""
    rows = [r for r in autogain_rows if r[0] == enabled and r[1] == order]
    assert rows
    bad = []
    for (en, od, eq_byp, conv_byp, g, q, p, ref_in, ref_mk, ref_tr) in rows:
        args = (bool(en), int(od), bool(eq_byp), bool(conv_byp))
        got = t_gp.plan(*args, t_gp.PlannerInput(g, q, p))
        want = j_gp.plan(*args, j_gp.PlannerInput(g, q, p))
        got_t = (got.input_headroom_db, got.output_makeup_db,
                 got.convolver_input_trim_db)
        if (max(abs(a - b) for a, b in zip(got_t, (ref_in, ref_mk, ref_tr)))
                > 1e-6 or got_t != (want.input_headroom_db,
                                    want.output_makeup_db,
                                    want.convolver_input_trim_db)):
            bad.append((args, g, q, p, got_t, (ref_in, ref_mk, ref_tr)))
    assert not bad, f"{len(bad)} mismatches; first: {bad[0]}"


@pytest.mark.parametrize("g,q", [(0.4, 2.0), (0.6, 0.5), (6.0, 3.0),
                                 (60.0, 20.0)])
def test_safety_margin_and_linear_gains_match_jax(g, q):
    assert t_gp.empirical_safety_margin(g, q) == \
        j_gp.empirical_safety_margin(g, q)
    pin = (g, q, 3.0)
    got = t_gp.plan(True, t_gp.EQ_THEN_CONVOLVER, False, False,
                    t_gp.PlannerInput(*pin))
    want = j_gp.plan(True, j_gp.EQ_THEN_CONVOLVER, False, False,
                     j_gp.PlannerInput(*pin))
    assert got.linear() == want.linear()


_EQ_FULL = _load("eq_full.json")["cases"]


def _eq_case(c, module):
    p = module.EQParams()
    p.enabled[:] = False
    for bd in c["bands"]:
        p.set_band(bd["idx"], band_type=bd["type"], freq=bd["freq"],
                   gain_db=bd["gain"], q=bd["q"], mode=bd["mode"],
                   enabled=True)
    p.structure = int(c["structure"])
    return p


@pytest.mark.parametrize("case", _EQ_FULL, ids=[c["name"] for c in _EQ_FULL])
def test_eq_analysis_matches_reference_binary(case):
    """EQProcessor::computeEstimatedMaxGainComplex of the reference binary
    (dump_eq_full.cpp) at the base and 4x rates: measured peak 1e-4 dB,
    upper bound 2e-3 dB, maxActiveQ 1e-6."""
    p = _eq_case(case, t_eq)
    for a in case["analysis"]:
        rate = float(a["rate"])
        meas = t_ana.estimate_max_gain_db(p, rate)
        upper, _ = t_ana.estimate_upper_bound_db(p, rate)
        assert abs(meas - float(a["measured_db"])) <= 1e-4, (rate, meas)
        assert abs(upper - float(a["upper_db"])) <= 2e-3, (rate, upper)
        assert abs(t_ana.max_active_q(p) - float(a["max_q"])) <= 1e-6


def _random_eq(seed, structure):
    rng = np.random.default_rng(seed)
    p = j_eq.EQParams()
    p.gains_db[:] = rng.uniform(-12.0, 12.0, 20)
    p.qs[:] = rng.uniform(0.3, 6.0, 20)
    p.enabled[rng.integers(0, 20, 4)] = False
    p.structure = structure
    return p


@pytest.mark.parametrize("rate", [48000.0, 192000.0])
@pytest.mark.parametrize("structure", [0, 1], ids=["serial", "parallel"])
def test_eq_estimators_match_jax(structure, rate):
    """eq_response, both estimators, the planner's gain and max Q against
    the JAX package's on a random 16-band EQ, at 1e-12 relative."""
    jp = _random_eq(structure + int(rate), structure)
    tp = _port_params(jp)
    freqs = np.exp(np.linspace(np.log(10.0), np.log(0.49 * rate), 500))
    assert _rel(t_ana.eq_response(tp, rate, freqs),
                j_ana.eq_response(jp, rate, freqs)) <= 1e-12
    for fn in ("estimate_max_gain_db", "estimate_planner_gain_db"):
        got, want = getattr(t_ana, fn)(tp, rate), getattr(j_ana, fn)(jp, rate)
        assert abs(got - want) <= 1e-12 * abs(want), fn
    ub_t, f_t = t_ana.estimate_upper_bound_db(tp, rate)
    ub_j, f_j = j_ana.estimate_upper_bound_db(jp, rate)
    assert abs(ub_t - ub_j) <= 1e-12 * abs(ub_j) and f_t == f_j
    assert t_ana.max_active_q(tp) == j_ana.max_active_q(jp)


_RESAMPLER = _load("resampler.json")["cases"]


@pytest.mark.parametrize("case", _RESAMPLER,
                         ids=[f"{c['in_sr']}-{c['out_sr']}"
                              for c in _RESAMPLER])
def test_resampler_matches_r8brain_binary(case):
    """The reference's r8brain CDSPResampler (dump_resampler.cpp): the
    independent Kaiser polyphase design agrees in band at relative RMS
    < 5e-7; the reference trims its tail, the port is full length."""
    y = t_res.resample_ir(np.asarray(case["input"]), case["in_sr"],
                          case["out_sr"])
    yref = np.asarray(case["output"])
    assert len(y) >= len(yref)
    n = len(yref)
    rel = np.sqrt(np.mean((y[:n] - yref) ** 2) / np.mean(yref ** 2))
    assert rel < 5e-7, rel


@pytest.mark.parametrize("in_sr,out_sr", [(48000.0, 192000.0),
                                          (44100.0, 48000.0),
                                          (96000.0, 48000.0),
                                          (48000.0, 48000.0)])
def test_resample_ir_matches_jax(in_sr, out_sr):
    rng = np.random.default_rng(int(in_sr + out_sr))
    ir = rng.normal(size=(2, 3000)) * np.exp(-np.arange(3000) / 500.0)
    got = t_res.resample_ir(ir, in_sr, out_sr)
    want = j_res.resample_ir(ir, in_sr, out_sr)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-12
    np.testing.assert_array_equal(t_res.design_resample_filter(4, 1),
                                  j_res.design_resample_filter(4, 1))


@pytest.mark.parametrize("n", [1, 700, 65536, 70000])
def test_ir_peak_gain_matches_jax(n):
    """estimate_max_frequency_gain (mono and stereo) and ir_peak_gain_db,
    short IRs and ones past the 65,536-sample window, at 1e-12 relative."""
    rng = np.random.default_rng(n)
    ir = rng.normal(size=(2, n)) * np.exp(-np.arange(n) / 4000.0) * 0.1
    for arg in (ir, ir[0]):
        got = t_irana.estimate_max_frequency_gain(arg)
        want = j_irana.estimate_max_frequency_gain(arg)
        assert abs(got - want) <= 1e-12 * abs(want)
    got, want = t_irana.ir_peak_gain_db(ir), j_irana.ir_peak_gain_db(ir)
    assert abs(got - want) <= 1e-12 * max(abs(want), 1.0)
    np.testing.assert_array_equal(t_irana.tukey_window(n),
                                  j_irana.tukey_window(n))


def test_config3_planner_matches_jax():
    """config3's set-up at a cut IR (24,000 samples at 48 kHz): the
    resampled IR, the planner's input and both orders' gains equal the
    JAX package's from bench.py's recipe on the same IR."""
    setup = staged.config3_setup(ir_len=24000)
    eq20 = j_eq.EQParams()
    eq20.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    ir_hf = j_res.resample_ir(setup.ir, 48000.0, 192000.0)
    assert _rel(setup.ir_hf, ir_hf) <= 1e-12
    want = j_gp.PlannerInput(
        eq_max_gain_db=j_ana.estimate_planner_gain_db(eq20, 192000.0),
        eq_max_q=j_ana.max_active_q(eq20),
        ir_freq_peak_gain_db=j_irana.ir_peak_gain_db(setup.ir))
    got = setup.planner_input
    for f in ("eq_max_gain_db", "eq_max_q", "ir_freq_peak_gain_db"):
        assert abs(getattr(got, f) - getattr(want, f)) \
            <= 1e-12 * abs(getattr(want, f)), f
    for order in (j_gp.EQ_THEN_CONVOLVER, j_gp.CONVOLVER_THEN_EQ):
        cfg, g = staged.config3_config(order, got)
        gj = j_gp.plan(True, order, False, False, want)
        assert (g.input_headroom_db, g.output_makeup_db,
                g.convolver_input_trim_db) == (
            gj.input_headroom_db, gj.output_makeup_db,
            gj.convolver_input_trim_db)
        assert (cfg.input_headroom_gain, cfg.output_makeup_gain,
                cfg.convolver_input_trim_gain) == gj.linear()
        assert cfg.oversampling_factor == 4 and cfg.order == order


def test_config3_planner_values_at_full_length():
    """At the full 2 s IR: the planner's input and gains bench.py's
    config3 gets (EQ peak 19.327 dB at 192 kHz, Q 0.707, IR peak 21.792
    dB; EQ->Conv -18 / +12 / -12 dB, Conv->EQ -18 / +12 / 0 dB)."""
    pin = staged.config3_setup().planner_input
    assert abs(pin.eq_max_gain_db - 19.327) < 1e-3
    assert pin.eq_max_q == 0.707
    assert abs(pin.ir_freq_peak_gain_db - 21.792) < 1e-3
    for order, want in ((t_gp.EQ_THEN_CONVOLVER, (-18.0, 12.0, -12.0)),
                        (t_gp.CONVOLVER_THEN_EQ, (-18.0, 12.0, 0.0))):
        g = staged.config3_config(order, pin)[1]
        assert (g.input_headroom_db, g.output_makeup_db,
                g.convolver_input_trim_db) == want


def test_slice_modules_import_no_jax():
    """This slice's modules import neither JAX nor the JAX package."""
    code = ("import sys, convopeq_tpu_torch.config3, convopeq_tpu_torch.ir,"
            " convopeq_tpu_torch.engine.eq_analysis,"
            " convopeq_tpu_torch.models.gain_planner,"
            " convopeq_tpu_torch.ops.oversample;"
            "print('jax' in sys.modules, 'convopeq_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.stdout.split() == ["False", "False"]
