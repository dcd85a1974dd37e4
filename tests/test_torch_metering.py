"""The port's metering (convopeq_tpu_torch/models/metering.py) against the
JAX package's on the CPU, on the same seeded inputs, and against the
reference binary's `metering` vectors.

Tolerances (f64): `k_weight` <= 1e-11 relative RMS (its biquads take the
2x2 route in both packages, whose rounding the two agree on only at
~3-5e-12, tests/test_torch_scan_eq.py); loudness <= 1e-9 LU; true peak,
the peak hold and the smoothed frames <= 1e-12 relative to their max.
The JAX results are built once per module (its K-weight scans compile op
by op on the CPU)."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import metering as jm
from convopeq_tpu_torch.models import metering as tm
from convopeq_tpu_torch.ops.oversample import design_halfband

SR = 48000.0
VEC = Path(__file__).resolve().parent / "ref_harness" / "vectors"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _signal(seconds, seed):
    """(2, 2, N): two stereo streams of noise under a slow level envelope
    (-6 to -60 dB), a tone burst, and a silent stretch in the second."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 10.0 ** (-(3.0 + 27.0 * (1.0 + np.sin(2 * np.pi * 0.7 * t))) / 20.0)
    x = rng.normal(size=(2, 2, n)) * env
    x[1, :, : n // 8] += 0.4 * np.sin(2 * np.pi * 997.0 * t[: n // 8])
    x[1, :, n // 2: n // 2 + n // 5] = 0.0
    return x


@pytest.fixture(scope="module")
def short():
    """0.5 s: K-weighting, true peak and the analyzer views."""
    x = _signal(0.5, 41)
    return x, {
        "kw": np.asarray(jm.k_weight(jnp.asarray(x), SR)),
        "kw96": np.asarray(jm.k_weight(jnp.asarray(x[0]), 96000.0)),
        "tp": np.asarray(jm.true_peak(jnp.asarray(x))),
        "hold": np.asarray(jm.spectrum_peak_hold(jnp.asarray(x[0]), SR, 0.1)),
        "smooth": np.asarray(jm.spectrum_smoothed(jnp.asarray(x[0]))),
        "mom": np.asarray(jm.loudness_momentary(jnp.asarray(x), SR)),
    }


@pytest.fixture(scope="module")
def gated():
    """3.5 s with quiet and silent stretches: the two-stage gate."""
    x = _signal(3.5, 42)
    return x, {
        "int": np.asarray(jm.loudness_integrated(jnp.asarray(x), SR)),
        "st": np.asarray(jm.loudness_short_term(jnp.asarray(x), SR)),
    }


def test_k_weighting_coeffs_equal_jax_and_bs1770_table():
    for sr in (44100.0, 48000.0, 96000.0):
        for a, b in zip(tm.k_weighting_coeffs(sr), jm.k_weighting_coeffs(sr)):
            assert tuple(a) == tuple(b)
    pre, rlb = tm.k_weighting_coeffs(48000.0)
    np.testing.assert_allclose(pre[:3], [1.53512485958697, -2.69169618940638,
                                         1.19839281085285], atol=2e-4)
    np.testing.assert_allclose(rlb[3:], [-1.99004745483398, 0.99007225036621],
                               atol=1e-4)


def test_k_weight_matches_jax_f64(short):
    x, ref = short
    got = tm.k_weight(torch.from_numpy(x), SR).numpy()
    assert _rel(got, ref["kw"]) <= 1e-11
    got96 = tm.k_weight(torch.from_numpy(x[0]), 96000.0).numpy()
    assert _rel(got96, ref["kw96"]) <= 1e-11


def test_momentary_loudness_matches_jax(short):
    x, ref = short
    got = tm.loudness_momentary(torch.from_numpy(x), SR).numpy()
    assert got.shape == ref["mom"].shape
    assert np.max(np.abs(got - ref["mom"])) <= 1e-9


def test_gated_loudness_matches_jax(gated):
    x, ref = gated
    xt = torch.from_numpy(x)
    li = tm.loudness_integrated(xt, SR).numpy()
    assert li.shape == ref["int"].shape == (2,)
    assert np.all(np.isfinite(li))
    assert np.max(np.abs(li - ref["int"])) <= 1e-9
    st = tm.loudness_short_term(xt, SR).numpy()
    assert st.shape == ref["st"].shape
    assert np.max(np.abs(st - ref["st"])) <= 1e-9


def test_f32_loudness_within_a_hundredth_of_an_lu(gated):
    """The f32 path (K-weighting in f32, the window sums accumulated in
    f64) against the port's f64 on the same input."""
    x, _ = gated
    li64 = tm.loudness_integrated(torch.from_numpy(x), SR).numpy()
    li32 = tm.loudness_integrated(torch.from_numpy(x).float(), SR).numpy()
    assert np.max(np.abs(li32 - li64)) <= 0.01


def test_true_peak_matches_jax(short):
    x, ref = short
    got = tm.true_peak(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2)
    assert np.max(np.abs(got - ref["tp"])) <= 1e-12 * np.max(ref["tp"])


def test_true_peak_row_groups_equal_one_call(short, monkeypatch):
    """A row group of one row (the full-width path's chunking) gives the
    same peaks as one group."""
    x, _ = short
    whole = tm.true_peak(torch.from_numpy(x)).numpy()
    monkeypatch.setattr(tm, "TRUE_PEAK_CHUNK_VALUES", 4 * x.shape[-1])
    rows = tm.true_peak(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(rows, whole)


def test_spectrum_views_match_jax(short):
    x, ref = short
    hold = tm.spectrum_peak_hold(torch.from_numpy(x[0]), SR, 0.1).numpy()
    assert hold.shape == ref["hold"].shape
    assert np.max(np.abs(hold - ref["hold"])) <= 1e-12 * ref["hold"].max()
    sm = tm.spectrum_smoothed(torch.from_numpy(x[0])).numpy()
    assert sm.shape == ref["smooth"].shape
    assert np.max(np.abs(sm - ref["smooth"])) <= 1e-12 * ref["smooth"].max()


def test_block_power_and_lufs_from_power():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2, 4096))
    got = tm.block_power(torch.from_numpy(x), 512).numpy()
    ref = np.asarray(jm.block_power(jnp.asarray(x), 512))
    np.testing.assert_allclose(got, ref, rtol=1e-14)
    assert abs(float(tm.lufs_from_power(torch.tensor(1.0, dtype=torch.float64)))
               - (-0.691)) < 1e-12


def test_loudness_sine_reference_level():
    """BS.1770-4: a 0 dBFS 997 Hz sine in one channel reads -3.01 LKFS;
    dual mono +3.01 dB (tests/test_metering.py's case on the port)."""
    n = int(SR * 5)
    s = np.sin(2 * np.pi * 997.0 * np.arange(n) / SR)
    li1 = float(tm.loudness_integrated(torch.from_numpy(s[None]), SR))
    assert abs(li1 - (-3.01)) < 0.1, li1
    x = torch.from_numpy(np.stack([s, s]))
    li2 = float(tm.loudness_integrated(x, SR))
    assert abs(li2) < 0.15, li2
    assert abs(float(tm.loudness_momentary(x, SR).mean()) - li2) < 0.2
    assert abs(float(tm.loudness_short_term(x, SR).mean()) - li2) < 0.2


def test_integrated_gating_ignores_silence():
    n = int(SR * 4)
    tone = 0.5 * np.sin(2 * np.pi * 997.0 * np.arange(n) / SR)
    sig = np.concatenate([tone, np.zeros(n)])
    li = float(tm.loudness_integrated(torch.from_numpy(np.stack([sig, sig])),
                                      SR))
    li_t = float(tm.loudness_integrated(
        torch.from_numpy(np.stack([tone, tone])), SR))
    assert abs(li - li_t) < 0.4
    silent = tm.loudness_integrated(torch.zeros(2, 48000, dtype=torch.float64),
                                    SR)
    assert float(silent) == -np.inf


def _tp_interp_golden(x, st):
    """TruePeakDetector::interpolateStage transcribed (history included)."""
    cc = len(st.conv)
    d = st.center_delay
    vp = st.conv_parity
    conv_rev = st.conv[::-1].copy()
    hist_len = max(cc - 1, d)
    hist = np.concatenate([np.zeros(hist_len), x, np.zeros(cc + 4)])
    out = np.zeros(2 * len(x))
    for n in range(len(x)):
        base = hist_len + n - d
        out[2 * n] = hist[base] * 0.5 + np.dot(
            hist[base - vp: base - vp + cc], conv_rev)
        out[2 * n + 1] = hist[base + 1] * 0.5 + np.dot(
            hist[base - 1 + vp: base - 1 + vp + cc], conv_rev)
    return out


def test_true_peak_matches_reference_interpolator():
    x = np.sin(2 * np.pi * 0.26 * np.arange(2048) + 0.3)
    st0, st1 = design_halfband(63, 100.0), design_halfband(31, 100.0)
    ref = np.abs(_tp_interp_golden(_tp_interp_golden(x, st0), st1)).max()
    assert abs(float(tm.true_peak(torch.from_numpy(x))) - ref) < 1e-9
    tpdc = float(tm.true_peak(torch.full((2048,), 0.5, dtype=torch.float64)))
    assert 0.45 < tpdc < 0.55
    for taps in (3, 5, 7, 15):     # center delays 0 and 1
        s = 0.5 * np.sin(2 * np.pi * 997.0 * np.arange(2048) / SR)
        tp = float(tm.true_peak(torch.from_numpy(s), taps=taps))
        assert np.isfinite(tp) and tp >= 0.45
        ref = float(jm.true_peak(jnp.asarray(s), taps=taps))
        assert abs(tp - ref) <= 1e-12


def test_kweight_matches_reference_binary():
    """LoudnessMeter's K-weighted block mean square and peak
    (tests/ref_harness/dump_metering.cpp) at 48 and 96 kHz, rtol 1e-10
    (tests/test_ref_vectors.py's tolerance)."""
    v = json.loads((VEC / "metering.json").read_text())
    x = np.stack([np.asarray(v["input_l"]), np.asarray(v["input_r"])])
    bs = v["block"]
    for sr, tag in ((48000.0, "48k"), (96000.0, "96k")):
        y = tm.k_weight(torch.from_numpy(x), sr).numpy()
        nb = x.shape[-1] // bs
        blocks = y[:, :nb * bs].reshape(2, nb, bs)
        ms = (blocks ** 2).mean(axis=-1).sum(axis=0)
        pk = np.abs(blocks).max(axis=-1).max(axis=0)
        np.testing.assert_allclose(ms, v[f"kweight_meansq_{tag}"],
                                   rtol=1e-10, err_msg=tag)
        np.testing.assert_allclose(pk, v[f"block_peak_{tag}"], rtol=1e-10,
                                   err_msg=tag)
        bp = tm.block_power(torch.from_numpy(y), bs).numpy()
        np.testing.assert_allclose(bp, v[f"kweight_meansq_{tag}"],
                                   rtol=1e-10, err_msg=tag)


def test_true_peak_matches_reference_binary():
    """The reference's held per-block true peak: the port's continuous
    true_peak within 2% of its maximum, as tests/test_ref_vectors.py
    holds the JAX package (the reference's block seams overshoot)."""
    v = json.loads((VEC / "metering.json").read_text())
    x = np.stack([np.asarray(v["input_l"]), np.asarray(v["input_r"])])
    held = np.asarray(v["truepeak_48k"])
    got = float(tm.true_peak(torch.from_numpy(x)).max())
    assert abs(got - held.max()) / held.max() < 0.02
