"""The staged chain at 1x of convopeq_tpu_torch (`process_chain`,
`StagedChain`, `staged.py`'s bench lines) against convopeq_tpu's
`process_chain` on the CPU: 2 streams x 8,192 samples at 48 kHz through
bench_all's 1M-tap IR cut to 12,000 taps (the reference 3-layer NUC with
its spectrum filter) and the EQ, in f64 and f32.

Tolerances: every chain with an active stage runs the output filter,
whose 15-20 Hz high-passes take the f64 2x2 companion scan in both
packages; that route carries ~6e-11 of rounding against the exact
recurrence, and the two packages agree at ~3e-12
(tests/test_torch_scan_eq.py::test_output_filter_near_dc_2x2_f64).
Those chains are held at F64_CHAIN_TOL = 1e-11; the chain with both
stages bypassed (no output filter) at 1e-12.  f32: the port's error
against f64 at most 1.5x the JAX package's on the same input."""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import convolver as j_conv
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import metering as j_met
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu_torch import convert, staged
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import convolver as t_conv
from convopeq_tpu_torch.models.gain_planner import (CONVOLVER_THEN_EQ,
                                                    EQ_THEN_CONVOLVER)
from convopeq_tpu_torch.models import nuc as t_nuc

SR = 48000.0
N = 8192
IR_LEN = 12_000
F64_CHAIN_TOL = 1e-11
F32_FACTOR = 1.5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _port_params(p):
    return convert.eq_params_from_arrays(
        p.band_types, p.freqs, p.gains_db, p.qs, p.modes, p.enabled,
        p.structure, p.saturation, p.agc_enabled)


def _converted(jstate):
    plan = jstate.left.plan
    return convert.stereo_state_from_arrays(
        [np.asarray(H) for H in jstate.left.layer_spectra],
        [np.asarray(H) for H in jstate.right.layer_spectra],
        [(lp.offset, lp.length, lp.part_size, lp.num_parts, lp.gain,
          lp.damping) for lp in plan.layers],
        plan.latency, plan.block_size, plan.ir_len, device="cpu")


@pytest.fixture(scope="module")
def fixture():
    """(x, eq params (JAX), the cut IR, the JAX NUC state, the port's)."""
    _ir64, ir = staged.bench_irs(ir1m_len=IR_LEN)
    x = np.random.default_rng(31).normal(size=(2, 2, N)) * 0.25
    x[0, 0, 100] = np.nan                     # sanitize: NaN -> 0
    x[1, 1, 7] = 3.0                          # clamp
    p = j_eq.EQParams()
    p.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    p.set_band(3, mode=j_eq.MID)
    p.set_band(11, mode=j_eq.LEFT)
    jstate = j_conv.stereo_prepare(jnp.asarray(ir), 512,
                                   j_nuc.FilterSpec(sample_rate=SR))
    tstate = t_conv.stereo_prepare(torch.from_numpy(ir), 512,
                                   t_nuc.FilterSpec(SR), device="cpu")
    return x, p, ir, jstate, tstate


RAMP = "ramp"
# (id, ChainConfig fields, EQ on, convolver on, mix ramp)
CASES = [
    ("eq_only", dict(conv_bypassed=True), True, False, None),
    ("conv_only", dict(eq_bypassed=True), False, True, None),
    ("eq_then_conv_trim", dict(order=EQ_THEN_CONVOLVER,
                               convolver_input_trim_gain=0.7,
                               input_headroom_gain=0.8), True, True, None),
    ("conv_then_eq_makeup", dict(order=CONVOLVER_THEN_EQ,
                                 output_makeup_gain=1.3), True, True, None),
    ("soft_clip", dict(soft_clip_enabled=True, saturation_amount=0.3,
                       output_makeup_gain=2.0), True, True, None),
    ("mix_ramp_no_headroom", dict(apply_output_headroom=False,
                                  wet_dry_mix=0.6), True, True, RAMP),
    ("scan_eq_saturated", dict(eq_method="scan"), "saturated", True, None),
]


@pytest.mark.parametrize("carried", [False, True],
                         ids=["port_prepared", "jax_carried"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_process_chain_matches_jax_f64(fixture, case, carried):
    x, p, _ir, jstate, tstate = fixture
    _name, fields, eq_on, conv_on, ramp = case
    if eq_on == "saturated":
        p = replace(p, saturation=0.3, agc_enabled=True,
                    structure=j_eq.PARALLEL)
    ramp_j = ramp_t = None
    if ramp == RAMP:
        ramp_t = t_conv.linear_mix_ramp(N, 1.0, 0.6, SR, 0.05, device="cpu")
        ramp_j = jnp.asarray(ramp_t.numpy())
    jcfg = j_chain.ChainConfig(sample_rate=SR, **fields)
    tcfg = t_chain.ChainConfig(sample_rate=SR, **fields)
    yj = np.asarray(j_chain.process_chain(
        jnp.asarray(x), jcfg, p if eq_on else None,
        jstate if conv_on else None, mix_ramp=ramp_j))
    state = _converted(jstate) if carried else tstate
    yt = t_chain.process_chain(
        torch.from_numpy(x), tcfg, _port_params(p) if eq_on else None,
        state if conv_on else None, mix_ramp=ramp_t).numpy()
    assert yt.shape == x.shape and np.isfinite(yt).all()
    assert _rel(yt, yj) <= F64_CHAIN_TOL


def test_process_chain_both_bypassed_matches_jax_f64(fixture):
    """No active stage, so no output filter: sanitize, DC blockers and
    the headroom, at 1e-12."""
    x = fixture[0]
    yj = np.asarray(j_chain.process_chain(
        jnp.asarray(x), j_chain.ChainConfig(sample_rate=SR), None, None))
    yt = t_chain.process_chain(torch.from_numpy(x),
                               t_chain.ChainConfig(sample_rate=SR)).numpy()
    assert _rel(yt, yj) <= 1e-12


def test_staged_chain_module_and_oversampling(fixture):
    """StagedChain runs process_chain with its buffers, at 1x and, now
    that oversampling is ported, at os_factor 2 (the 48 kHz NUC here
    stands in for an IR at the processing rate): the same output as
    process_chain, shaped as the input and finite
    (tests/test_torch_oversampled_chain.py holds the oversampled chain
    against the JAX package)."""
    x, p, _ir, _jstate, tstate = fixture
    cfg = t_chain.ChainConfig(sample_rate=SR, soft_clip_enabled=True)
    xt = torch.from_numpy(x)
    for c in (cfg, replace(cfg, oversampling_factor=2)):
        chain = t_chain.StagedChain(c, _port_params(p), tstate)
        y = chain(xt)
        np.testing.assert_array_equal(
            y.numpy(),
            t_chain.process_chain(xt, c, _port_params(p), tstate).numpy())
        assert y.shape == xt.shape and bool(torch.isfinite(y).all())
    assert any(n.startswith("convolver.") for n, _ in chain.named_buffers())


def test_process_chain_f32_error_within_jax(fixture):
    """EQ, NUC and soft clip in f32 (the EQ's combined-response route,
    the output filter's fir and diag routes): the port's error against
    the f64 chain at most 1.5x the JAX package's."""
    x, p, ir, jstate, _tstate = fixture
    x = np.nan_to_num(x)
    fields = dict(soft_clip_enabled=True, saturation_amount=0.3)
    jcfg = j_chain.ChainConfig(sample_rate=SR, **fields)
    y64 = np.asarray(j_chain.process_chain(jnp.asarray(x), jcfg, p, jstate))
    j32 = j_conv.stereo_prepare(jnp.asarray(ir, jnp.float32), 512,
                                j_nuc.FilterSpec(SR))
    yj32 = np.asarray(j_chain.process_chain(jnp.asarray(x, jnp.float32),
                                            jcfg, p, j32))
    t32 = t_conv.stereo_prepare(torch.from_numpy(ir).float(), 512,
                                t_nuc.FilterSpec(SR), device="cpu")
    yt32 = t_chain.process_chain(
        torch.from_numpy(x).float(),
        t_chain.ChainConfig(sample_rate=SR, **fields), _port_params(p), t32)
    assert yt32.dtype == torch.float32
    err_j, err_t = _rel(yj32, y64), _rel(yt32.numpy(), y64)
    assert err_t <= F32_FACTOR * err_j, (err_t, err_j)


def test_staged_lines_match_jax_bench_configs_f64(fixture):
    """The slice as a whole: staged.py's four lines, built as bench_all
    builds its configs (the 1M-tap IR cut to 12,000 taps), against the
    JAX package's process_chain of the same configs; config4's analyzer
    frames too."""
    x = np.nan_to_num(fixture[0])
    lines = staged.staged_lines("cpu", torch.float64, ir1m_len=IR_LEN)
    ir64, ir1m = staged.bench_irs(ir1m_len=IR_LEN)
    eq20 = j_eq.EQParams()
    eq20.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    conv64 = j_conv.stereo_prepare(
        jnp.asarray(ir64), 512,
        j_nuc.FilterSpec(sample_rate=SR, tail_mode=j_nuc.TAIL_BYPASS),
        apply_spectrum_filter=False)
    conv1m = fixture[3]
    np.testing.assert_array_equal(ir1m, fixture[2])
    jax_configs = {
        "config1_f64": (dict(conv_bypassed=True), eq20, None),
        "config2_f64": (dict(eq_bypassed=True), None, conv64),
        "config4_f64": (dict(eq_bypassed=True), None, conv1m),
        "config5_staged_f64": (dict(soft_clip_enabled=True,
                                    saturation_amount=0.3), eq20, conv1m),
    }
    assert list(lines) == list(jax_configs)
    for name, (fields, p, conv) in jax_configs.items():
        yj = np.asarray(j_chain.process_chain(
            jnp.asarray(x), j_chain.ChainConfig(sample_rate=SR, **fields),
            p, conv))
        out = lines[name].run(torch.from_numpy(x))
        yt = out[0] if lines[name].analyzer else out
        assert _rel(yt.numpy(), yj) <= F64_CHAIN_TOL, name
        if lines[name].analyzer:
            fj = np.asarray(j_met.spectrum_frames(jnp.asarray(yj)))
            assert _rel(out[1].numpy(), fj) <= F64_CHAIN_TOL
