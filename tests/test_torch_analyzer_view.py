"""The port's analyzer display surface (convopeq_tpu_torch/models/
analyzer_view.py) against the JAX package's on the CPU: bar frequencies,
bars, the EQ overlay and the running view (EMA, decaying peak hold,
FIFO) fed the same seeded blocks, f64: the host arithmetic equal, the
running view's dB values within 1e-12 relative (the two packages' FFTs of
the frames differ in the last bits: ~1e-13 of the dB value at -60 dB)."""
import numpy as np
import pytest
import torch

from convopeq_tpu.models import analyzer_view as jv
from convopeq_tpu.models.eq import EQParams as JEQParams
from convopeq_tpu_torch.models import analyzer_view as tv
from convopeq_tpu_torch.models.eq import EQParams as TEQParams

SR = 48000.0


def _params(cls):
    p = cls()
    p.enabled[:] = False
    p.set_band(0, band_type=1, freq=1000.0, gain_db=6.0, q=1.0, mode=0,
               enabled=True)
    p.set_band(1, band_type=1, freq=5000.0, gain_db=-9.0, q=2.0, mode=2,
               enabled=True)
    p.set_band(2, band_type=0, freq=120.0, gain_db=3.0, q=0.7, mode=3,
               enabled=True)
    p.set_band(3, band_type=2, freq=9000.0, gain_db=-2.0, q=0.7, mode=4,
               enabled=True)
    p.set_band(4, band_type=4, freq=30.0, gain_db=0.0, q=0.7, mode=1,
               enabled=True)
    return p


def test_bars_and_frequencies_equal_jax():
    np.testing.assert_array_equal(tv.display_frequencies(),
                                  jv.display_frequencies())
    bins = np.random.default_rng(2).uniform(-100.0, 10.0, (3, 2049))
    for rate in (SR, 96000.0):
        np.testing.assert_array_equal(tv.bins_to_bars(bins, rate),
                                      jv.bins_to_bars(bins, rate))
    for args in ((True, True), (False, True), (True, False)):
        assert tv.adaptive_timer_hz(*args) == jv.adaptive_timer_hz(*args)
    assert tv.adaptive_timer_hz(True, True) == 60


def test_eq_overlay_equals_jax_and_routes_bands():
    c = tv.eq_overlay_curves(_params(TEQParams), SR)
    r = jv.eq_overlay_curves(_params(JEQParams), SR)
    assert c.keys() == r.keys()
    for k in r:
        np.testing.assert_allclose(c[k], r[k], rtol=0, atol=1e-12)
    f = c["freqs"]
    i1k, i5k = np.argmin(np.abs(f - 1000.0)), np.argmin(np.abs(f - 5000.0))
    assert abs(c["total_l"][i1k] - 6.0) < 0.5
    assert c["total_r"][i5k] < -7.0 and c["total_l"][i5k] > -1.5
    assert np.all(c["bands_l"][1] == 0.0) and np.all(c["bands_l"][9] == 0.0)


@pytest.mark.parametrize("block", [512, 4096 * 3])
def test_analyzer_view_equals_jax(block):
    """A tone, then silence (peak hold, then decay), then noise, fed in
    blocks of `block` samples (stereo, mixed to mono), against the JAX
    view fed the same blocks."""
    rng = np.random.default_rng(12)
    n = 48000
    t = np.arange(n) / SR
    x = np.concatenate([0.5 * np.sin(2 * np.pi * 1000.0 * t),
                        np.zeros(n // 2), 0.1 * rng.normal(size=n // 2)])
    x = np.stack([x, 0.5 * x])
    a, b = tv.AnalyzerView(SR), jv.AnalyzerView(SR)
    for k in range(0, x.shape[-1], block):
        a.push(torch.from_numpy(x[:, k:k + block]))
        b.push(x[:, k:k + block])
    np.testing.assert_allclose(a.smoothed, b.smoothed, rtol=1e-12, atol=0)
    np.testing.assert_allclose(a.peak, b.peak, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(a._fifo, b._fifo)
    ba, bb = a.bars(), b.bars()
    for k in bb:
        np.testing.assert_allclose(ba[k], bb[k], rtol=1e-12, atol=0)
    near = np.argmin(np.abs(ba["freqs"] - 1000.0))
    assert np.all(ba["peaks_db"] >= ba["bars_db"] - 1e-9)
    assert ba["peaks_db"][near] > ba["bars_db"][near]


def test_analyzer_view_fifo_across_pushes():
    n = 4096 * 3
    x = 0.5 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / SR)
    one = tv.AnalyzerView(SR)
    one.push(x)
    split = tv.AnalyzerView(SR)
    for k in range(0, n, 1024):
        split.push(x[k:k + 1024])
    np.testing.assert_allclose(split.smoothed, one.smoothed, atol=1e-9)
    np.testing.assert_allclose(split.peak, one.peak, atol=1e-9)
    held = tv.AnalyzerView(SR)
    before = held.smoothed.copy()
    held.push(x[:1024])
    np.testing.assert_array_equal(held.smoothed, before)
    assert held._fifo.size == 1024
