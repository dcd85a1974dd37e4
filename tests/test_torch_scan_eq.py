"""The staged chain's stages of convopeq_tpu_torch against convopeq_tpu on
the CPU: the biquad scans on every route, the one-pole scan, the TPT SVF,
the EQ (band cascade and combined response, serial and parallel, all
five channel modes, saturation, AGC), the output filter and the analyzer
frames.  The same seeded numpy input, tests/test_precision.py's (one
stereo stream of 8,192 samples at 48 kHz, 16 blocks of 512, seed 99),
goes through both packages.

Tolerances: f64 1e-12 relative RMS, except where a stage runs the 2x2
companion scan over the 18-20 Hz output-filter biquads (pole radius
0.998): that route carries ~6e-11 of rounding against the exact
sequential recurrence in both packages, and the two agree at ~5e-12
(F64_NEAR_DC_TOL, with both packages held against the exact recurrence
in `test_output_filter_near_dc_2x2_f64`).  f32: the port's error
against f64 at most 1.5x the JAX package's on the same input."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import metering as j_met
from convopeq_tpu.models import output_filter as j_of
from convopeq_tpu.ops import scan_iir as j_scan
from convopeq_tpu.ops import svf as j_svf
from convopeq_tpu_torch import convert
from convopeq_tpu_torch.models import eq as t_eq
from convopeq_tpu_torch.models import metering as t_met
from convopeq_tpu_torch.models import output_filter as t_of
from convopeq_tpu_torch.ops import scan_iir as t_scan
from convopeq_tpu_torch.ops import svf as t_svf

SR = 48000.0
F64_TOL = 1e-12
F64_NEAR_DC_TOL = 1e-11
F32_FACTOR = 1.5
OFC = j_of.output_filter_coeffs(SR)


def _jax(fn, *args):
    """fn(*args) of the JAX package, eager (op by op, as its own tests
    run it; under jax.jit XLA's fusion rounds the ill-conditioned 2x2
    route differently again), as numpy arrays."""
    out = fn(*(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(np.array, out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


@pytest.fixture(scope="module")
def x64():
    return _precision_setup()[1]


def _port_params(p):
    return convert.eq_params_from_arrays(
        p.band_types, p.freqs, p.gains_db, p.qs, p.modes, p.enabled,
        p.structure, p.saturation, p.agc_enabled)


def _mixed_params(structure=j_eq.SERIAL, saturation=0.0, agc=False):
    """Eight bands over all five types and all five channel modes."""
    p = j_eq.EQParams()
    p.enabled[:] = False
    for i, (bt, f, g, q, m) in enumerate([
            (0, 80, 3, 0.7, 0), (1, 500, -4, 1.2, 1), (1, 2000, 5, 2, 3),
            (2, 8000, 2, 0.7, 4), (1, 300, 6, 1.0, 2), (4, 40, 0, 0.7, 0),
            (3, 15000, 0, 0.9, 3), (1, 1200, -2, 4.0, 4)]):
        p.set_band(i, band_type=bt, freq=f, gain_db=g, q=q, mode=m,
                   enabled=True)
    p.structure = structure
    p.saturation = saturation
    p.agc_enabled = agc
    return p


# ---------------------------------------------------------------- scans

# (name, coefficients (b0, b1, b2, a1, a2), route): a 1 kHz peaking
# biquad (complex poles, r ~ 0.93) for the diag and 2x2 routes, the 15 Hz
# Q 0.5 output-filter HPF for real (repeated) poles, the 19 kHz LP (r ~
# 0.63) for fir
_PEAK = (1.0 + 0.12, -1.8 * 0.95, 0.87 - 0.02, -1.8 * 0.95, 0.87)
SCAN_CASES = [("peak", _PEAK, "2x2"), ("peak", _PEAK, "diag"),
              ("lc_soft", OFC["lc"][1], "diag"),
              ("lp19k", OFC["hc"][1][0], "fir"),
              ("lp19k", OFC["hc"][1][0], "2x2")]


@pytest.mark.parametrize("name,c,route", SCAN_CASES,
                         ids=[f"{n}-{r}" for n, c, r in SCAN_CASES])
def test_biquad_routes_match_jax_f64(x64, name, c, route):
    yj, sj = _jax(lambda v: j_scan.biquad_df2t_scan(v, *c, method=route),
                  x64)
    yt, st = t_scan.biquad_df2t_scan(torch.from_numpy(x64), *c, method=route)
    assert _rel(yt.numpy(), yj) <= F64_TOL
    assert _rel(st.numpy(), sj) <= F64_TOL


def test_biquad_2x2_with_state_and_batch_coefficients_f64(x64):
    """An initial state (the diag route hands it to 2x2) and per-stream
    coefficient arrays."""
    s0 = np.random.default_rng(22).normal(size=(2, 2)) * 0.1
    for route in ("diag", "2x2"):
        yj, sj = _jax(lambda v, s: j_scan.biquad_df2t_scan(
            v, *_PEAK, s0=s, method=route), x64, s0)
        yt, st = t_scan.biquad_df2t_scan(torch.from_numpy(x64), *_PEAK,
                                         s0=torch.from_numpy(s0),
                                         method=route)
        assert _rel(yt.numpy(), yj) <= F64_TOL
        assert _rel(st.numpy(), sj) <= F64_TOL
    coeffs = (0.9, -1.5, 0.7, np.array([-1.7, -1.6]), np.full(2, 0.8))
    yj, sj = _jax(lambda v: j_scan.biquad_df2t_scan(v, *coeffs), x64)
    yt, st = t_scan.biquad_df2t_scan(torch.from_numpy(x64), *coeffs)
    assert _rel(yt.numpy(), yj) <= F64_TOL
    assert _rel(st.numpy(), sj) <= F64_TOL


def test_one_pole_scan_matches_jax_f64(x64):
    for a, b, s0 in ((0.999, 0.3, 0.2), (-0.5, 1.0, 0.0)):
        pj, fj = _jax(lambda v: j_scan.one_pole_scan(v, a, b, s0), x64)
        pt, ft = t_scan.one_pole_scan(torch.from_numpy(x64), a, b, s0)
        assert _rel(pt.numpy(), pj) <= F64_TOL
        assert _rel(ft.numpy(), fj) <= F64_TOL


@pytest.mark.parametrize("simd_tanh", [True, False])
def test_svf_process_matches_jax_f64(x64, simd_tanh):
    """A +6 dB peaking band driven into saturation (0.3), with a state."""
    coeffs = tuple(float(c) for c in
                   j_svf.svf_coeffs(1, 1000.0, 6.0, 2.0, SR))
    s0 = np.random.default_rng(23).normal(size=(2, 2)) * 0.1
    yj, sj = _jax(lambda v, s: j_svf.svf_process(
        v, coeffs, state0=s, saturation=0.3, simd_tanh=simd_tanh),
        x64 * 8, s0)
    yt, st = t_svf.svf_process(torch.from_numpy(x64 * 8), coeffs,
                               state0=torch.from_numpy(s0), saturation=0.3,
                               simd_tanh=simd_tanh)
    assert _rel(yt.numpy(), yj) <= F64_TOL
    assert _rel(st.numpy(), sj) <= F64_TOL


def test_output_filter_near_dc_2x2_f64(x64):
    """The 18 Hz, 15 Hz and 20 Hz high-passes on the f64 2x2 route: each
    package against the exact sequential recurrence (scipy's lfilter),
    the port no further from it than 1.5x the JAX package, and the two
    within F64_NEAR_DC_TOL of each other."""
    for c in (OFC["lc"][0], OFC["lc"][1], OFC["hpf"]):
        b0, b1, b2, a1, a2 = c
        exact = lfilter([b0, b1, b2], [1.0, a1, a2], x64, axis=-1)
        yj, _ = _jax(lambda v: j_scan.biquad_df2t_scan(v, *c), x64)
        yt, _ = t_scan.biquad_df2t_scan(torch.from_numpy(x64), *c)
        assert t_scan.biquad_route(torch.float64, *c) == "2x2"
        err_j, err_t = _rel(yj, exact), _rel(yt.numpy(), exact)
        assert err_t <= F32_FACTOR * err_j, (err_t, err_j)
        assert _rel(yt.numpy(), yj) <= F64_NEAR_DC_TOL


def test_f32_biquad_routes_follow_jax():
    """In f32 the port picks the JAX package's route for every
    output-filter biquad: fir for the 19 kHz LPs, diag for the 15-20 Hz
    HPFs."""
    routes = {}
    for key in ("hc", "lp"):
        for mode in range(3):
            for c in OFC[key][mode]:
                routes[c] = None
    for c in (OFC["lc"][0], OFC["lc"][1], OFC["hpf"]):
        routes[c] = None
    for c in routes:
        if c == (1.0, 0.0, 0.0, 0.0, 0.0):
            continue
        r = j_scan._biquad_pole_radius(c[3], c[4])
        jax_route = ("diag" if r > j_scan.POLE_RADIUS_DIAG_F32 else
                     "fir" if r <= j_scan.POLE_RADIUS_FIR_F32 else "2x2")
        assert t_scan.biquad_route(torch.float32, *c) == jax_route, c
    assert t_scan.biquad_route(torch.float32, *OFC["lc"][0]) == "diag"
    assert t_scan.biquad_route(torch.float32, *OFC["hc"][1][0]) == "fir"


# ---------------------------------------------------------------- EQ

@pytest.mark.parametrize("structure", [j_eq.SERIAL, j_eq.PARALLEL])
@pytest.mark.parametrize("method,saturation",
                         [("scan", 0.0), ("scan", 0.3), ("fft", 0.0)])
def test_eq_process_bands_matches_jax_f64(x64, structure, method,
                                          saturation):
    p = _mixed_params(structure, saturation)
    yj = _jax(lambda v: j_eq.eq_process_bands(v, p, SR, method=method),
              x64)
    yt = t_eq.eq_process_bands(torch.from_numpy(x64), _port_params(p), SR,
                               method=method).numpy()
    assert _rel(yt, yj) <= F64_TOL


@pytest.mark.parametrize("mode", range(5))
def test_band_apply_each_mode_matches_jax_f64(x64, mode):
    """One +5 dB band of each channel mode, saturated at 0.3."""
    coeffs = tuple(float(c) for c in j_svf.svf_coeffs(1, 700.0, 5.0, 1.5,
                                                      SR))
    L, R = x64[0] * 6, x64[1] * 6
    lj, rj = _jax(lambda a, b: j_eq._band_apply(a, b, coeffs, mode, 0.3),
                  L, R)
    lt, rt = t_eq._band_apply(torch.from_numpy(L), torch.from_numpy(R),
                              coeffs, mode, 0.3)
    assert _rel(lt.numpy(), lj) <= F64_TOL
    assert _rel(rt.numpy(), rj) <= F64_TOL


def test_eq_fft_blocked_matches_jax_f32(x64):
    """The blocked route called directly in f32 on both sides (eq20:
    tail 7,903, p = 2048, P = 4), stereo bands and a mixed set, each
    within 1.5x the JAX package's f32 error against its f64 response."""
    eq20 = j_eq.EQParams()
    eq20.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    assert t_eq._eq_ring_tail_samples(_port_params(eq20), SR) == 7903
    for p in (eq20, _mixed_params()):
        tail = j_eq._eq_ring_tail_samples(p, SR)
        y64 = _jax(lambda v: j_eq.eq_process_bands_fft(v, p, SR), x64)
        yj = _jax(lambda v: j_eq._eq_fft_blocked(v, p, SR, tail),
                  x64.astype(np.float32))
        yt = t_eq._eq_fft_blocked(torch.from_numpy(x64).float(),
                                  _port_params(p), SR, tail).numpy()
        assert yt.dtype == np.float32 and yt.shape == x64.shape
        assert _rel(yt, y64) <= F32_FACTOR * _rel(yj, y64)


def test_agc_apply_matches_jax_f64(x64):
    """agc_apply with its state out, then resumed from that state."""
    p = _mixed_params(saturation=0.3)
    post = _jax(lambda v: j_eq.eq_process_bands(v, p, SR, method="scan"),
                x64)
    yj, sj = _jax(lambda a, b: j_eq.agc_apply(a, b, SR, 512,
                                              return_state=True), x64, post)
    yt, st = t_eq.agc_apply(torch.from_numpy(x64), torch.from_numpy(post),
                            SR, 512, return_state=True)
    assert _rel(yt.numpy(), yj) <= F64_TOL
    assert _rel(st.numpy(), sj) <= F64_TOL
    yj2 = _jax(lambda a, b, s: j_eq.agc_apply(a, b, SR, 512, state0=s),
               x64, post, sj)
    yt2 = t_eq.agc_apply(torch.from_numpy(x64), torch.from_numpy(post), SR,
                         512, state0=st)
    assert _rel(yt2.numpy(), yj2) <= F64_TOL
    with pytest.raises(ValueError):
        t_eq.agc_apply(torch.from_numpy(x64), torch.from_numpy(post), SR,
                       500)


@pytest.mark.parametrize("structure", [j_eq.SERIAL, j_eq.PARALLEL])
def test_eq_process_with_agc_matches_jax_f64(x64, structure):
    p = _mixed_params(structure, 0.3, agc=True)
    yj = _jax(lambda v: j_eq.eq_process(v, p, SR), x64)
    yt = t_eq.eq_process(torch.from_numpy(x64), _port_params(p), SR).numpy()
    assert _rel(yt, yj) <= F64_TOL


# ------------------------------------------------------------ output filter

@pytest.mark.parametrize("conv_is_last,hc,lc", [
    (True, hc, lc) for hc in range(3) for lc in range(2)] + [
    (False, lp, 0) for lp in range(3)])
def test_output_filter_process_matches_jax_f64(x64, conv_is_last, hc, lc):
    """Every HC x LC mode (convolver last) and LP mode (EQ last); each
    cascade holds an 18, 15 or 20 Hz high-pass on the 2x2 route."""
    yj = _jax(lambda v: j_of.output_filter_process(v, SR, conv_is_last,
                                                   hc, lc, hc), x64)
    yt = t_of.output_filter_process(torch.from_numpy(x64), SR, conv_is_last,
                                    hc, lc, hc).numpy()
    assert _rel(yt, yj) <= F64_NEAR_DC_TOL


# ---------------------------------------------------------------- analyzer

@pytest.mark.parametrize("fft_size,hop", [(1024, 256), (1024, 300),
                                          (4096, 1024)])
def test_spectrum_frames_matches_jax_f64(x64, fft_size, hop):
    fj = _jax(lambda v: j_met.spectrum_frames(v, fft_size, hop), x64)
    ft = t_met.spectrum_frames(torch.from_numpy(x64), fft_size, hop).numpy()
    assert ft.shape == fj.shape
    assert _rel(ft, fj) <= F64_TOL
    short = x64[..., :fft_size // 2]       # shorter than one frame
    np.testing.assert_allclose(
        t_met.spectrum_frames(torch.from_numpy(short), fft_size,
                              hop).numpy(),
        _jax(lambda v: j_met.spectrum_frames(v, fft_size, hop), short),
        rtol=0, atol=1e-12)


# ---------------------------------------------------------------- f32

def _precision_setup():
    """tests/test_precision.py's `_setup` parameters and input (seed 99)."""
    rng = np.random.default_rng(99)
    rng.normal(size=(2, 6000))
    p = j_eq.EQParams()
    p.enabled[:] = False
    for i, (bt, f, g, q, m) in enumerate([(0, 80, 3, 0.7, 0),
                                          (1, 500, -4, 1.2, 0),
                                          (1, 2000, 5, 2, 3),
                                          (2, 8000, 2, 0.7, 0)]):
        p.set_band(i, band_type=bt, freq=f, gain_db=g, q=q, mode=m,
                   enabled=True)
    return p, rng.normal(size=(2, 8192)) * 0.25


_STAGES = {
    "eq_scan": (lambda v, p: j_eq.eq_process_bands(v, p, SR, method="scan"),
                lambda v, p: t_eq.eq_process_bands(v, p, SR, method="scan")),
    "eq_fft": (lambda v, p: j_eq.eq_process_bands(v, p, SR, method="fft"),
               lambda v, p: t_eq.eq_process_bands(v, p, SR, method="fft")),
    "output_filter_conv_last": (
        lambda v, p: j_of.output_filter_process(v, SR, True),
        lambda v, p: t_of.output_filter_process(v, SR, True)),
    "output_filter_eq_last": (
        lambda v, p: j_of.output_filter_process(v, SR, False),
        lambda v, p: t_of.output_filter_process(v, SR, False)),
}


@pytest.mark.parametrize("stage", list(_STAGES))
def test_f32_stage_error_within_jax(x64, stage):
    """tests/test_precision.py's stage sweep for the stages this slice
    ports (the EQ's two routes, the output filter's two cascades): the
    port's f32 error against the f64 output at most 1.5x the
    JAX package's f32 error on the same input."""
    jfn, tfn = _STAGES[stage]
    p, x = _precision_setup()[0], x64
    tp = _port_params(p)
    y64 = _jax(lambda v: jfn(v, p), x)
    err_j = _rel(_jax(lambda v: jfn(v, p), x.astype(np.float32)), y64)
    y32 = tfn(torch.from_numpy(x).float(), tp)
    assert y32.dtype == torch.float32
    err_t = _rel(y32.numpy(), y64)
    assert err_t <= F32_FACTOR * err_j, (stage, err_t, err_j)
