"""The port's host and signal functions against the reference binary's
vectors (tests/ref_harness/vectors/*.json), at the tolerances of
tests/test_ref_vectors.py, which holds the JAX package to the same dumps.
Everything runs on the CPU in f64.  The staged chain's stages: the output
filter (output_filter.json), the SVF band kernel (eq_kernel.json) and the
whole EQ engine (eq_full.json).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from convopeq_tpu_torch.models.chain import (ChainConfig, _sanitize_and_trim,
                                             resolve_oversampling_factor)
from convopeq_tpu_torch.models.eq import EQParams, eq_process
from convopeq_tpu_torch.models.output_filter import output_filter_process
from convopeq_tpu_torch.ops.dc_blocker import dc_block
from convopeq_tpu_torch.ops.softclip import soft_clip, soft_clip_params
from convopeq_tpu_torch.ops.svf import clamp_params, svf_coeffs, svf_process
from convopeq_tpu_torch.utils.dsputil import equal_power_sin

VEC = Path(__file__).resolve().parent / "ref_harness" / "vectors"


def _load(name):
    return json.loads((VEC / name).read_text())


@pytest.mark.parametrize("tag,sr,fc", [("dc_48k_3hz", 48000.0, 3.0),
                                       ("dc_384k_1hz", 384000.0, 1.0)])
def test_dc_block_matches_reference_binary(tag, sr, fc):
    """UltraHighRateDCBlocker block outputs (dump_misc.cpp), both
    channels in one call."""
    v = _load("misc.json")
    x = torch.tensor(np.stack([v["input_l"], v["input_r"]]),
                     dtype=torch.float64)
    y, _ = dc_block(x, sr, fc)
    want = np.stack([v[f"{tag}_l"], v[f"{tag}_r"]])
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("k,saturation", [(0, 0.1), (1, 0.5), (2, 0.9)])
def test_soft_clip_matches_reference_binary(k, saturation):
    """musicalSoftClip over the saturation grid of softclip.json (N = 1003,
    the scalar tail included)."""
    v = _load("softclip.json")
    thr, knee, asym = soft_clip_params(saturation)
    got = soft_clip(torch.tensor(v["input"], dtype=torch.float64), thr,
                    knee, asym)
    np.testing.assert_allclose(got.numpy(), v[f"sat_{k}"], rtol=0,
                               atol=1e-14)


@pytest.fixture(scope="module")
def svf_rows():
    rows = _load("svf_coeffs.json")
    # the reference API takes f32 parameters: recover the exact f32 value
    as_f32 = lambda key: np.asarray([r[key] for r in rows],
                                    np.float32).astype(np.float64)
    sr = np.asarray([r["sr"] for r in rows])
    fc, gc, qc = clamp_params(as_f32("freq"), as_f32("gain_db"),
                              as_f32("q"), sr)
    ours = svf_coeffs(np.asarray([r["type"] for r in rows]), fc, gc, qc, sr)
    return rows, dict(zip(("a1", "a2", "a3", "m0", "m1", "m2"), ours))


@pytest.mark.parametrize("name", ["a1", "a2", "a3", "m0", "m1", "m2"])
def test_svf_coeffs_match_reference(svf_rows, name):
    """The 14,400 calcSVFCoeffs vectors (dump_svf.cpp: five band types,
    the clamp paths, four sample rates), one coefficient a case."""
    rows, ours = svf_rows
    np.testing.assert_allclose(ours[name], [r[name] for r in rows],
                               rtol=5e-14, atol=1e-300)


@pytest.mark.parametrize("pre_gain", [1.0, 0.5])
def test_input_sanitize_matches_reference_binary(pre_gain):
    """sanitizeAndLimit (dump_engine_math.cpp): NaN -> 0, |x| < 1e-20 -> 0,
    +-Inf to the clamp (+-1), then the input gain; exact."""
    d = _load("engine_math.json")["sanitize"]
    assert d["threshold"] == 1e-20
    x = torch.tensor(d["input"], dtype=torch.float64)
    assert torch.isnan(x).any() and torch.isinf(x).any()
    y = _sanitize_and_trim(x, ChainConfig(input_headroom_gain=pre_gain))
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(d["output"]) * pre_gain)


@pytest.mark.parametrize("sr_range", ["<=96k", "<=192k", "<=384k", ">384k"])
def test_oversampling_policy_matches_reference_binary(sr_range):
    """OversamplingPolicy::resolve over the dumped (rate, request) grid
    (Auto = 0, invalid requests, > 768 kHz unsupported), by rate band."""
    lo, hi = {"<=96k": (0, 96000), "<=192k": (96000, 192000),
              "<=384k": (192000, 384000), ">384k": (384000, np.inf)}[sr_range]
    d = _load("engine_math.json")["os_policy"]
    cases = [(sr, rq, res) for sr, rq, res in
             zip(d["sr"], d["requested"], d["resolved"]) if lo < sr <= hi]
    assert cases
    for sr, rq, res in cases:
        assert resolve_oversampling_factor(rq, sr) == res, (sr, rq, res)


def test_equal_power_sin_matches_reference_binary():
    """equalPowerSin (ConvolverProcessor.Runtime.cpp:26-31): 1 ULP, the
    dump binary contracts the Horner chain with FMA."""
    d = _load("engine_math.json")["equal_power_sin"]
    ours = np.array([float(equal_power_sin(x)) for x in d["x"]])
    np.testing.assert_allclose(ours, d["y"], rtol=0, atol=5e-16)


@pytest.mark.parametrize("sr_tag,sr", [("48k", 48000.0), ("96k", 96000.0)])
def test_output_filter_matches_reference_binary(sr_tag, sr):
    """OutputFilter block outputs (dump_output_filter.cpp): the full HC x
    LC grid (convolver last) and the LP modes (EQ last), both channels in
    one call, atol 1e-9 as the JAX package's test."""
    v = _load("output_filter.json")
    x = torch.tensor(np.stack([v["input_l"], v["input_r"]]),
                     dtype=torch.float64)
    cases = [(True, hc, lc, 1, f"conv_{sr_tag}_hc{hc}_lc{lc}")
             for hc in range(3) for lc in range(2)]
    cases += [(False, 1, 0, lp, f"eq_{sr_tag}_lp{lp}") for lp in range(3)]
    for conv_is_last, hc, lc, lp, key in cases:
        y = output_filter_process(x, sr, conv_is_last, hc, lc, lp)
        want = np.stack([v[f"{key}_l"], v[f"{key}_r"]])
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-9,
                                   err_msg=key)


@pytest.fixture(scope="module")
def eq_kernel():
    return _load("eq_kernel.json")


@pytest.mark.parametrize("case", range(8))
def test_eq_kernel_matches_reference_binary(eq_kernel, case):
    """The TPT-SVF band kernel against the reference's processBand /
    processBandStereo (dump_eq_kernel.cpp, 2048 samples in four blocks
    with the state carried): scalar (exact +-1 tanh) and stereo (SSE2
    clamp form) outputs at atol 2e-11, states at rtol 2e-9."""
    v = eq_kernel
    b = v["bands"][case]
    sr = float(v["sample_rate"])
    xl = torch.tensor(v["input_l"], dtype=torch.float64)
    xr = torch.tensor(v["input_r"], dtype=torch.float64)
    f, g, q = (np.float64(np.float32(b[k])) for k in ("freq", "gain_db", "q"))
    coeffs = tuple(float(c) for c in svf_coeffs(b["type"], f, g, q, sr))
    sat = float(b["saturation"])
    ys, st = svf_process(xl, coeffs, saturation=sat, simd_tanh=False)
    np.testing.assert_allclose(ys.numpy(), b["scalar_out"], rtol=0,
                               atol=2e-11)
    np.testing.assert_allclose(st.numpy(), b["scalar_state"], rtol=2e-9,
                               atol=1e-12)
    y2, st2 = svf_process(torch.stack([xl, xr]), coeffs, saturation=sat,
                          simd_tanh=True)
    np.testing.assert_allclose(
        y2.numpy(), np.stack([b["stereo_out_l"], b["stereo_out_r"]]),
        rtol=0, atol=2e-11)
    np.testing.assert_allclose(
        st2.numpy(), np.stack([b["stereo_state_l"], b["stereo_state_r"]]),
        rtol=2e-9, atol=1e-12)


def _xs64_stereo(seed, n, scale):
    """Interleaved L/R xorshift64* program of dump_eq_full.cpp, bit-exact
    (tests/test_ref_vectors.py's)."""
    mask = (1 << 64) - 1
    s = seed
    out = np.empty(2 * n)
    for i in range(2 * n):
        s ^= s >> 12
        s = (s ^ (s << 25)) & mask
        s ^= s >> 27
        out[i] = ((((s * 2685821657736338717) & mask) >> 11)
                  * (1.0 / 9007199254740992.0) - 0.5) * scale
    return out[0::2], out[1::2]


_EQ_FULL_CASES = [c["name"] for c in _load("eq_full.json")["cases"]]


@pytest.mark.parametrize("name", _EQ_FULL_CASES)
def test_eq_full_engine_matches_reference_binary(name):
    """The whole EQProcessor (dump_eq_full.cpp: all nine TUs, the real
    prepareToPlay -> setters -> process()): serial and parallel, M/S and
    L/R modes, the enable and 0.01 dB skips, saturation, the block-rate
    AGC, 96 kHz; atol 1e-13 x scale, 5e-8 where saturated."""
    v = _load("eq_full.json")
    c = next(c for c in v["cases"] if c["name"] == name)
    B = int(v["block"])
    p = EQParams()
    p.enabled[:] = False
    for bd in c["bands"]:
        p.set_band(bd["idx"], band_type=bd["type"], freq=bd["freq"],
                   gain_db=bd["gain"], q=bd["q"], mode=bd["mode"],
                   enabled=True)
    p.structure = int(c["structure"])
    p.saturation = float(c["saturation"])
    p.agc_enabled = bool(c["agc"])
    L, R = _xs64_stereo(int(c["seed"]), B * int(v["nblocks"]),
                        float(c["in_scale"]))
    y = eq_process(torch.from_numpy(np.stack([L, R])), p, float(c["sr"]),
                   block_size=B).numpy()
    want = np.stack([c["out_l"], c["out_r"]])
    tol = 5e-8 if float(c["saturation"]) > 0 else 1e-13
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))
