"""The port's halfband oversampling (convopeq_tpu_torch/ops/oversample.py)
against convopeq_tpu's on the CPU in f64, and against the reference
binary's `oversampler` vectors.

The port runs every stage as the banded-Toeplitz GEMM form
(`_resample2_matmul`); on the CPU the JAX package runs the polyphase
shift-accumulate form, so the comparisons against its `upsample2`,
`downsample2` and cascades hold the GEMM form against the polyphase form
(atol 1e-13, tests/test_chain_stages.py:86's bound between the two), and
against its own `_resample2_matmul` too.  The vectors at atol 2e-13
(tests/test_ref_vectors.py:294-320); f32 against f64 at 1e-5 relative
RMS (tests/test_precision.py:142-144)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.ops import oversample as jo
from convopeq_tpu_torch import convert
from convopeq_tpu_torch.ops import oversample as to

VEC = os.path.join(os.path.dirname(__file__), "ref_harness", "vectors")
PRESETS = [(to.PRESET_IIR_LIKE, "iirlike"), (to.PRESET_LINEAR_PHASE,
                                              "linphase")]
RATIOS = (2, 4, 8)
STAGE_DESIGNS = [(31, 90.0), (63, 120.0), (127, 110.0), (255, 140.0),
                 (511, 140.0), (1023, 160.0)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.asarray(a, np.float64)).to(dtype)


def _port_stage(js):
    return convert.halfband_stage_from_arrays(
        js.taps, js.center_tap, js.center_parity, js.conv_parity,
        np.asarray(js.conv), js.center_delay, js.center_gain)


def _assert_same_stage(ts, js):
    for f in ("taps", "center_tap", "center_parity", "conv_parity",
              "center_delay", "center_gain"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.conv, np.asarray(js.conv))


@pytest.mark.parametrize("gain", ["reference", "unity"])
@pytest.mark.parametrize("preset", PRESETS, ids=[p[1] for p in PRESETS])
@pytest.mark.parametrize("ratio", (1,) + RATIOS)
def test_make_stages_matches_jax(ratio, preset, gain):
    """The stage ladder and every design field, bit for bit; the JAX
    stage's fields through `convert.halfband_stage_from_arrays` give the
    same stage."""
    ts = to.make_stages(ratio, preset[0], gain)
    js = jo.make_stages(ratio, preset[0], gain)
    assert len(ts) == len(js) == {1: 0, 2: 1, 4: 2, 8: 3}[ratio]
    for a, b in zip(ts, js):
        _assert_same_stage(a, b)
        _assert_same_stage(_port_stage(b), b)
    assert to.oversampler_latency(ts) == jo.oversampler_latency(js)


def test_halfband_stage_from_arrays_rejects_a_wrong_arm():
    js = jo.design_halfband(31, 90.0)
    with pytest.raises(ValueError, match="conv arm"):
        convert.halfband_stage_from_arrays(
            js.taps, js.center_tap, js.center_parity, js.conv_parity,
            np.asarray(js.conv)[:-1], js.center_delay, js.center_gain)


@pytest.mark.parametrize("for_up", [True, False], ids=["up", "down"])
@pytest.mark.parametrize("design", STAGE_DESIGNS, ids=lambda d: f"t{d[0]}")
def test_stage_full_response_matches_jax(design, for_up):
    st = to.design_halfband(*design)
    np.testing.assert_array_equal(
        to._stage_full_response(st, for_up),
        jo._stage_full_response(jo.design_halfband(*design), for_up))


@pytest.mark.parametrize("n", [100, 257, 3001])
@pytest.mark.parametrize("design", STAGE_DESIGNS[:5], ids=lambda d: f"t{d[0]}")
def test_resample2_stages_match_jax_forms(design, n):
    """upsample2 / downsample2 (the port's GEMM form) against the JAX
    package's polyphase form (its CPU route) and its GEMM form, at 1e-13,
    on a (2, 2, n) batch; a ragged n leaves partial chunks."""
    rng = np.random.default_rng(design[0] + n)
    js = jo.design_halfband(*design)
    ts = to.design_halfband(*design)
    x = rng.normal(size=(2, 2, n))
    u = rng.normal(size=(2, 2, 2 * n))
    yu = to.upsample2(_t(x), ts).numpy()
    yd = to.downsample2(_t(u), ts).numpy()
    assert yu.shape == (2, 2, 2 * n) and yd.shape == (2, 2, n)
    np.testing.assert_allclose(yu, np.asarray(jo.upsample2(jnp.asarray(x),
                                                           js)), atol=1e-13)
    np.testing.assert_allclose(yd, np.asarray(jo.downsample2(jnp.asarray(u),
                                                             js)), atol=1e-13)
    for for_up, sig, got in ((True, x, yu), (False, u, yd)):
        gemm = jo._resample2_matmul(
            jnp.asarray(sig), jo._stage_full_response(js, for_up), for_up)
        np.testing.assert_allclose(got, np.asarray(gemm), atol=1e-13)


@pytest.mark.parametrize("preset", PRESETS, ids=[p[1] for p in PRESETS])
@pytest.mark.parametrize("ratio", RATIOS)
def test_cascades_match_jax(ratio, preset):
    rng = np.random.default_rng(ratio)
    x = rng.normal(size=(2, 700))
    ts, js = to.make_stages(ratio, preset[0]), jo.make_stages(ratio,
                                                              preset[0])
    up = to.oversample_up(_t(x), ts)
    assert up.shape == (2, 700 * ratio)
    np.testing.assert_allclose(
        up.numpy(), np.asarray(jo.oversample_up(jnp.asarray(x), js)),
        atol=1e-13)
    u = rng.normal(size=(2, 700 * ratio))
    down = to.oversample_down(_t(u), ts)
    assert down.shape == (2, 700)
    np.testing.assert_allclose(
        down.numpy(), np.asarray(jo.oversample_down(jnp.asarray(u), js)),
        atol=1e-13)


@pytest.mark.parametrize("taps", [3, 8, 9, 16, 255])
def test_causal_fir_matches_jax(taps):
    """`_causal_fir` (the Toeplitz GEMMs at every tap count) against the
    JAX package's CPU form (a shift-accumulate)."""
    rng = np.random.default_rng(taps)
    c = rng.normal(size=taps)
    x = rng.normal(size=(3, 1000))
    np.testing.assert_allclose(
        to._causal_fir(_t(x), c).numpy(),
        np.asarray(jo._causal_fir(jnp.asarray(x), c)), atol=1e-13)


@pytest.fixture(scope="module")
def vectors():
    with open(os.path.join(VEC, "oversampler.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("preset", PRESETS, ids=[p[1] for p in PRESETS])
@pytest.mark.parametrize("ratio", RATIOS)
def test_oversampler_matches_reference_binary(vectors, ratio, preset):
    """The reference binary's block-streamed CustomInputOversampler
    (tests/ref_harness/dump_oversampler.cpp): up from its input, down
    from its up output, atol 2e-13."""
    v = vectors
    tag = f"r{ratio}_{preset[1]}"
    x = np.stack([np.asarray(v["input_l"]), np.asarray(v["input_r"])])
    stages = to.make_stages(ratio, preset[0])
    want_up = np.stack([np.asarray(v[f"{tag}_up_l"]),
                        np.asarray(v[f"{tag}_up_r"])])
    np.testing.assert_allclose(to.oversample_up(_t(x), stages).numpy(),
                               want_up, rtol=0, atol=2e-13)
    want_down = np.stack([np.asarray(v[f"{tag}_down_l"]),
                          np.asarray(v[f"{tag}_down_r"])])
    np.testing.assert_allclose(
        to.oversample_down(_t(want_up), stages).numpy(), want_down, rtol=0,
        atol=2e-13)


@pytest.mark.parametrize("gain,dc", [("reference", 0.75), ("unity", 1.0)])
@pytest.mark.parametrize("ratio", RATIOS)
def test_updown_dc_gain(ratio, gain, dc):
    """The reference's 2x up -> down round trip has DC gain 0.75 (the
    center phase is 0.5x, not doubled; tests/test_chain_stages.py:104),
    the unity variant 1.0; every ratio's round trip of a constant equals
    the JAX package's."""
    st = to.make_stages(ratio, to.PRESET_IIR_LIKE, center_phase_gain=gain)
    y = to.oversample_down(to.oversample_up(torch.ones(2000,
                                                       dtype=torch.float64),
                                            st), st).numpy()
    jst = jo.make_stages(ratio, jo.PRESET_IIR_LIKE, center_phase_gain=gain)
    yj = np.asarray(jo.oversample_down(
        jo.oversample_up(jnp.ones(2000), jst), jst))
    np.testing.assert_allclose(y, yj, atol=1e-13)
    if ratio == 2:
        np.testing.assert_allclose(y[-100:], dc, atol=1e-6)


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("ratio", RATIOS)
def test_f32_tracks_f64(ratio, direction):
    """The GEMM form in f32 against f64: 1e-5 relative RMS
    (tests/test_precision.py:142-144)."""
    st = to.make_stages(ratio)
    x = np.random.default_rng(5).normal(size=(2, 8192)) * 0.25
    if direction == "up":
        fn = lambda v: to.oversample_up(v, st)
    else:
        fn = lambda v: to.oversample_down(torch.cat([v] * ratio, dim=-1), st)
    y64 = fn(_t(x))
    y32 = fn(_t(x, torch.float32))
    assert y32.dtype == torch.float32
    assert _rel(y32.numpy(), y64.numpy()) < 1e-5
