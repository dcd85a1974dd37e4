"""The oversampled staged chain and its fold in convopeq_tpu_torch
(`process_chain` at os_factor > 1, `prepare_folded_convolver_oversampled`)
against convopeq_tpu on the CPU in f64, and the port's fold against the
port's own staged chain.

Tolerances.  Every chain here runs the output filter at the processing
rate, whose 15-20 Hz high-passes take the f64 2x2 route in both
packages; there the two packages agree at ~3-5e-12
(tests/test_torch_staged_chain.py), so the chains are held at
F64_CHAIN_TOL = 1e-11.  The fold against the staged chain: 3e-9 with
the staged NUC unfiltered and the fold without the HC/LC curve, 0.05
with the curve (the circular per-partition filter against its linear
fold), tests/test_chain_stages.py:400-455's bounds.  The folded taps
against the JAX package's at 1e-12 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import convolver as j_conv
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu_torch import config3, convert, staged
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import convolver as t_conv
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.models.gain_planner import (CONVOLVER_THEN_EQ,
                                                    EQ_THEN_CONVOLVER)

SR = 48000.0
N = 8192
F64_CHAIN_TOL = 1e-11


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.sqrt(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2)))


def _port_params(p):
    return convert.eq_params_from_arrays(
        p.band_types, p.freqs, p.gains_db, p.qs, p.modes, p.enabled,
        p.structure, p.saturation, p.agc_enabled)


def _eq(lo=-4.0, hi=4.0):
    p = j_eq.EQParams()
    p.gains_db[:] = np.linspace(lo, hi, 20)
    return p


def _ir_hf(rng, os_factor, n=1500):
    proc_len = n * os_factor
    return rng.normal(size=(2, proc_len)) \
        * np.exp(-np.arange(proc_len) / (250.0 * os_factor)) * 0.2


@pytest.fixture(scope="module")
def states():
    """{os_factor: (IR at the processing rate, JAX NUC, port NUC)}: the
    reference's 3-layer plan at block 512 x os_factor, filter on."""
    rng = np.random.default_rng(41)
    out = {}
    for os_factor in (2, 4):
        ir = _ir_hf(rng, os_factor)
        spec_j = j_nuc.FilterSpec(sample_rate=SR * os_factor)
        out[os_factor] = (
            ir, j_conv.stereo_prepare(jnp.asarray(ir), 512 * os_factor,
                                      spec_j),
            t_conv.stereo_prepare(torch.from_numpy(ir), 512 * os_factor,
                                  t_nuc.FilterSpec(SR * os_factor),
                                  device="cpu"))
    return out


RAMP = "ramp"
# (id, os_factor, ChainConfig fields, mix ramp)
CASES = [
    ("os2_eq_conv", 2, dict(order=EQ_THEN_CONVOLVER,
                            convolver_input_trim_gain=0.7), None),
    ("os2_conv_eq_clip", 2, dict(order=CONVOLVER_THEN_EQ,
                                 soft_clip_enabled=True,
                                 saturation_amount=0.3,
                                 output_makeup_gain=2.0), None),
    ("os4_eq_conv_clip", 4, dict(order=EQ_THEN_CONVOLVER,
                                 soft_clip_enabled=True,
                                 saturation_amount=0.3,
                                 input_headroom_gain=0.8,
                                 output_makeup_gain=2.5), None),
    ("os4_conv_eq", 4, dict(order=CONVOLVER_THEN_EQ,
                            output_makeup_gain=1.3), None),
    ("os4_mix_ramp", 4, dict(order=EQ_THEN_CONVOLVER, wet_dry_mix=0.6,
                             apply_output_headroom=False), RAMP),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_process_chain_oversampled_matches_jax_f64(states, case):
    """The staged chain at 2x and 4x, both orders, with and without the
    plain soft clip at the processing rate, one case with a mix ramp of
    N x os_factor samples, on (1, 2, 8192) against the JAX package's."""
    _name, os_factor, fields, ramp = case
    _ir, jstate, tstate = states[os_factor]
    x = np.random.default_rng(os_factor).normal(size=(1, 2, N)) * 0.25
    x[0, 1, 10] = np.nan                      # sanitize: NaN -> 0
    p = _eq()
    ramp_j = ramp_t = None
    if ramp == RAMP:
        ramp_t = t_conv.linear_mix_ramp(N * os_factor, 1.0, 0.6,
                                        SR * os_factor, 0.02, device="cpu")
        ramp_j = jnp.asarray(ramp_t.numpy())
    kw = dict(sample_rate=SR, oversampling_factor=os_factor, **fields)
    yj = np.asarray(j_chain.process_chain(
        jnp.asarray(x), j_chain.ChainConfig(**kw), p, jstate,
        mix_ramp=ramp_j))
    yt = t_chain.process_chain(torch.from_numpy(x),
                               t_chain.ChainConfig(**kw), _port_params(p),
                               tstate, mix_ramp=ramp_t).numpy()
    assert yt.shape == x.shape and np.isfinite(yt).all()
    assert _rel(yt, yj) <= F64_CHAIN_TOL


@pytest.mark.parametrize("os_factor", [2, 4, 8])
def test_staged_chain_runs_oversampled(os_factor):
    """`process_chain` at os_factor 2, 4 and 8 runs (it raised before
    oversampling was ported): the EQ alone at 48 kHz returns the input's
    shape, finite, and StagedChain gives the same output."""
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 2, 1024))
                         * 0.25)
    cfg = t_chain.ChainConfig(sample_rate=SR, conv_bypassed=True,
                              oversampling_factor=os_factor)
    y = t_chain.process_chain(x, cfg, _port_params(_eq()))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    np.testing.assert_array_equal(
        t_chain.StagedChain(cfg, _port_params(_eq()))(x).numpy(), y.numpy())


FOLD_CASES = [(2, EQ_THEN_CONVOLVER), (4, CONVOLVER_THEN_EQ),
              (4, EQ_THEN_CONVOLVER)]


@pytest.fixture(scope="module")
def fold_input():
    return np.random.default_rng(52).normal(size=(1, 2, 32768)) * 0.25


@pytest.mark.parametrize("os_req,order", FOLD_CASES,
                         ids=[f"os{c[0]}_order{c[1]}" for c in FOLD_CASES])
def test_folded_oversampled_chain_matches_staged(fold_input, os_req, order):
    """The port's fold of the whole oversampled chain against the port's
    own staged chain (tests/test_chain_stages.py:400's exact variant):
    the staged NUC unfiltered, the fold without the HC/LC curve, < 3e-9
    relative RMS."""
    rng = np.random.default_rng(52 + os_req + order)
    ir_hf = _ir_hf(rng, os_req, 3000)
    p = _port_params(_eq(-3.0, 3.0))
    spec = t_nuc.FilterSpec(SR * os_req)
    cfg = t_chain.ChainConfig(sample_rate=SR, order=order,
                              oversampling_factor=os_req,
                              convolver_input_trim_gain=0.7,
                              output_makeup_gain=1.1)
    x = torch.from_numpy(fold_input)
    conv = t_conv.stereo_prepare(torch.from_numpy(ir_hf), 512 * os_req, spec,
                                 apply_spectrum_filter=False, device="cpu")
    y_ref = t_chain.process_chain(x, cfg, p, conv).numpy()
    st = t_chain.prepare_folded_convolver_oversampled(
        ir_hf, 512, spec, cfg, p, eps=1e-10, dtype=torch.float64,
        fold_spectrum_curve=False, device="cpu")
    y_fold = t_chain.process_chain_fused(x, cfg, st).numpy()
    assert _rel(y_fold, y_ref) < 3e-9


def test_folded_oversampled_chain_with_curve_tracks_staged(fold_input):
    """With the HC/LC curve folded linearly, the fold tracks the staged
    chain's circular per-partition filter within 0.05."""
    rng = np.random.default_rng(60)
    ir_hf = _ir_hf(rng, 4, 3000)
    p = _port_params(_eq(-3.0, 3.0))
    spec = t_nuc.FilterSpec(SR * 4)
    cfg = t_chain.ChainConfig(sample_rate=SR, order=EQ_THEN_CONVOLVER,
                              oversampling_factor=4)
    x = torch.from_numpy(fold_input)
    conv = t_conv.stereo_prepare(torch.from_numpy(ir_hf), 2048, spec,
                                 device="cpu")
    y_circ = t_chain.process_chain(x, cfg, p, conv).numpy()
    st = t_chain.prepare_folded_convolver_oversampled(
        ir_hf, 512, spec, cfg, p, dtype=torch.float64, device="cpu")
    y_lin = t_chain.process_chain_fused(x, cfg, st).numpy()
    assert _rel(y_lin, y_circ) < 0.05


# (id, os_factor, order, partition, fold_spectrum_curve)
TAP_CASES = [("os4_auto_curve", 4, EQ_THEN_CONVOLVER, "auto", True),
             ("os2_int_nocurve", 2, CONVOLVER_THEN_EQ, 1024, False),
             ("os4_3layer", 4, CONVOLVER_THEN_EQ, None, True)]


@pytest.mark.parametrize("case", TAP_CASES, ids=[c[0] for c in TAP_CASES])
def test_folded_taps_match_jax(case):
    """The port's folded IR, as its partition spectra and plan, against
    `prepare_folded_convolver_oversampled` of the JAX package at 1e-12
    relative: a uniform "auto" layer, an int partition without the curve,
    and the 3-layer plan (partition None)."""
    _name, os_factor, order, partition, curve = case
    rng = np.random.default_rng(70 + os_factor)
    ir_hf = _ir_hf(rng, os_factor, 2000)
    p = _eq(-3.0, 5.0)
    kw = dict(sample_rate=SR, order=order, oversampling_factor=os_factor,
              convolver_input_trim_gain=0.8)
    js = j_chain.prepare_folded_convolver_oversampled(
        ir_hf, 512, j_nuc.FilterSpec(sample_rate=SR * os_factor),
        j_chain.ChainConfig(**kw), p, dtype=jnp.float64,
        partition=partition, fold_spectrum_curve=curve)
    ts = t_chain.prepare_folded_convolver_oversampled(
        ir_hf, 512, t_nuc.FilterSpec(SR * os_factor),
        t_chain.ChainConfig(**kw), _port_params(p), dtype=torch.float64,
        partition=partition, fold_spectrum_curve=curve, device="cpu")
    for jside, tside in ((js.left, ts.left), (js.right, ts.right)):
        assert [(lp.part_size, lp.num_parts, lp.offset)
                for lp in tside.plan.layers] == \
            [(lp.part_size, lp.num_parts, lp.offset)
             for lp in jside.plan.layers]
        assert tside.plan.ir_len == jside.plan.ir_len
        for Ht, Hj in zip(tside.layer_spectra, jside.layer_spectra):
            assert _rel(Ht.numpy(), np.asarray(Hj)) <= 1e-12


def test_config3_lines_fold_as_jax():
    """config3.py's folded lines at a cut IR (12,000 samples at 48 kHz):
    both orders' spectra equal the JAX package's fold of the same set-up
    at 1e-12, and the f64 line runs the chain as process_chain_fused."""
    setup = staged.config3_setup(ir_len=12000)
    lines = config3.config3_lines("cpu", torch.float64, setup)
    assert list(lines) == ["config3_eq_conv_f64", "config3_conv_eq_f64"]
    x = np.random.default_rng(3).normal(size=(1, 2, 4096)) * 0.25
    for name, (order, _tag) in config3.ORDERS.items():
        line = lines[name + "_f64"]
        cfg = line.chain.cfg
        js = j_chain.prepare_folded_convolver_oversampled(
            setup.ir_hf, 512, j_nuc.FilterSpec(sample_rate=192000.0),
            j_chain.ChainConfig(**cfg.__dict__), _eq(), dtype=jnp.float64)
        Hj = np.asarray(js.left.layer_spectra[0])
        Ht = line.chain.convolver.state.left.layer_spectra[0].numpy()
        assert _rel(Ht, Hj) <= 1e-12
        assert line.info["plan"] == [js.left.plan.layers[0].part_size,
                                     js.left.plan.layers[0].num_parts]
        yj = np.asarray(j_chain.process_chain_fused(jnp.asarray(x),
                                                    j_chain.ChainConfig(
                                                        **cfg.__dict__), js))
        yt = line.run(torch.from_numpy(x)).numpy()
        assert _rel(yt, yj) <= 1e-12


def test_config3_staged_line_matches_jax():
    """staged.py's config3_staged_f64 at a cut IR (3,000 samples at 48
    kHz, 12,000 at 192 kHz) against the JAX package's process_chain of the
    same config (the planner's gains, 4x, eq20, the NUC at block 2048
    with the spectrum filter), on (1, 2, 4096)."""
    line = staged.os_lines("cpu", torch.float64, ir3_len=3000)[
        "config3_staged_f64"]
    setup = staged.config3_setup(ir_len=3000)
    cfg = line.chain.cfg
    jstate = j_conv.stereo_prepare(
        jnp.asarray(setup.ir_hf), 2048,
        j_nuc.FilterSpec(sample_rate=192000.0))
    x = np.random.default_rng(4).normal(size=(1, 2, 4096)) * 0.25
    yj = np.asarray(j_chain.process_chain(
        jnp.asarray(x), j_chain.ChainConfig(**cfg.__dict__), _eq(), jstate))
    yt = line.output(torch.from_numpy(x)).numpy()
    assert _rel(yt, yj) <= F64_CHAIN_TOL
    assert line.info["layers"] == [[lp.part_size, lp.num_parts]
                                   for lp in jstate.left.plan.layers]


def test_config3_staged_f32_limit_from_jax_floor():
    """config3_staged's f32 limit is the larger of 2e-3 and 1.5x the JAX
    package's own f32 error for this chain on the CPU.  The JAX package's
    CPU "f32" oversampled chain is no f32 floor: its polyphase FIR
    multiplies by numpy f64 scalars, so under x64 its up cascade returns
    float64 and every later stage runs in f64.  The f32 floor it does
    have at 192 kHz is its output filter's, the stage config3_staged ends
    with (convolver last: the 18 Hz HC + LC high-passes, pole radius
    ~0.9995): ~1.04e-3 relative RMS on 1 s of noise.  1.5x that is
    under 2e-3, so the line keeps staged.LIMITS.  With the EQ last (the
    20 Hz high-pass) the floor is ~2.7e-3: no f32 line runs that order
    at 4x staged, and one would not meet 2e-3."""
    from convopeq_tpu.models import output_filter as j_of
    from convopeq_tpu.ops import oversample as j_os
    x = np.random.default_rng(1).normal(size=(1, 2, 48000)) * 0.25
    stages = j_os.make_stages(4)
    assert j_os.oversample_up(jnp.asarray(x, jnp.float32),
                              stages).dtype == jnp.float64
    u = np.asarray(j_os.oversample_up(jnp.asarray(x), stages))
    y64 = np.asarray(j_of.output_filter_process(jnp.asarray(u), 192000.0,
                                                True))
    y32 = j_of.output_filter_process(jnp.asarray(u, jnp.float32), 192000.0,
                                     True)
    assert y32.dtype == jnp.float32
    floor = _rel(np.asarray(y32, np.float64), y64)
    assert 9e-4 <= floor <= 1.2e-3
    eq_last = _rel(np.asarray(j_of.output_filter_process(
        jnp.asarray(u, jnp.float32), 192000.0, False), np.float64),
        np.asarray(j_of.output_filter_process(jnp.asarray(u), 192000.0,
                                              False)))
    assert 2.4e-3 <= eq_last <= 3.0e-3
    line = staged.os_lines("cpu", torch.float32, ir3_len=3000)[
        "config3_staged"]
    assert line.limit == max(2e-3, 1.5 * floor) == staged.LIMITS[
        torch.float32]
