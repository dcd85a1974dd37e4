"""The port's host and signal functions against the reference binary's
vectors (tests/ref_harness/vectors/*.json), at the tolerances of
tests/test_ref_vectors.py, which holds the JAX package to the same dumps.
Everything runs on the CPU in f64.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from convopeq_tpu_torch.models.chain import (ChainConfig, _sanitize_and_trim,
                                             resolve_oversampling_factor)
from convopeq_tpu_torch.ops.dc_blocker import dc_block
from convopeq_tpu_torch.ops.softclip import soft_clip, soft_clip_params
from convopeq_tpu_torch.ops.svf import clamp_params, svf_coeffs
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
