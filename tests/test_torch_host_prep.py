"""Host rebuild-time helpers of convopeq_tpu_torch against convopeq_tpu.

The port keeps these in host NumPy f64, line for line, so they match the
JAX package exactly (or to rtol 1e-13 where an FFT is involved)."""
import numpy as np
import pytest

from convopeq_tpu.engine import eq_analysis as j_eqa
from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu.models import output_filter as j_of
from convopeq_tpu.ops import dc_blocker as j_dc
from convopeq_tpu.ops import scan_iir as j_scan
from convopeq_tpu.ops import svf as j_svf
from convopeq_tpu.utils import dsputil as j_dsp

from convopeq_tpu_torch.engine import eq_analysis as t_eqa
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import eq as t_eq
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.models import output_filter as t_of
from convopeq_tpu_torch.ops import dc_blocker as t_dc
from convopeq_tpu_torch.ops import scan_iir as t_scan
from convopeq_tpu_torch.ops import svf as t_svf
from convopeq_tpu_torch.utils import dsputil as t_dsp


def _spec_pair(**kw):
    return j_nuc.FilterSpec(**kw), t_nuc.FilterSpec(**kw)


def _eq_pair(seed, modes_stereo=True, structure=0):
    """The same random 20-band EQ in both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(band_types=rng.integers(0, 5, 20).astype(np.int32),
              freqs=np.exp(rng.uniform(np.log(25), np.log(19000), 20)),
              gains_db=rng.uniform(-9, 9, 20),
              qs=rng.uniform(0.3, 4.0, 20),
              modes=(np.zeros(20, np.int32) if modes_stereo
                     else rng.integers(0, 5, 20).astype(np.int32)),
              enabled=rng.random(20) > 0.2,
              structure=structure)
    return (j_eq.EQParams(**{k: np.copy(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()}),
            t_eq.EQParams(**{k: np.copy(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()}))


@pytest.mark.parametrize("ir_len,block,spec_kw", [
    (1_000_000, 512, {}),
    (20_000, 512, {}),
    (300_000, 256, {"tail_mode": 0, "tail_strength": 1.5}),
    (90_000, 1024, {"tail_mode": 2}),
    (500_000, 128, {"tail_enabled": False}),
    (2_000_000, 64, {"tail_start_seconds": 0.3, "tail_l1l2_multiplier": 4}),
])
def test_plan_layers_matches(ir_len, block, spec_kw):
    sj, st = _spec_pair(**spec_kw)
    for head in (False, True):
        pj = j_nuc.plan_layers(ir_len, block, sj, head)
        pt = t_nuc.plan_layers(ir_len, block, st, head)
        assert pt.direct_taps == pj.direct_taps
        assert (pt.latency, pt.block_size, pt.ir_len) == (
            pj.latency, pj.block_size, pj.ir_len)
        assert [tuple(vars(lp).values()) for lp in pt.layers] == \
            [tuple(vars(lp).values()) for lp in pj.layers]


@pytest.mark.parametrize("fft_size", [1024, 65536, 2 ** 21])
@pytest.mark.parametrize("sr", [44100.0, 48000.0, 96000.0])
@pytest.mark.parametrize("hc,lc", [(0, 0), (1, 1), (2, 0)])
def test_spectrum_filter_gain_matches(fft_size, sr, hc, lc):
    sj, st = _spec_pair(sample_rate=sr, hc_mode=hc, lc_mode=lc)
    np.testing.assert_array_equal(t_nuc.spectrum_filter_gain(fft_size, st),
                                  j_nuc.spectrum_filter_gain(fft_size, sj))


@pytest.mark.parametrize("sr", [44100.0, 48000.0, 192000.0])
def test_svf_coeffs_match(sr):
    rng = np.random.default_rng(5)
    bt = rng.integers(0, 5, 64)
    freq = np.exp(rng.uniform(np.log(5), np.log(30000), 64))
    gain = rng.uniform(-60, 60, 64)
    q = np.exp(rng.uniform(np.log(0.005), np.log(30), 64))
    for a, b in zip(t_svf.svf_coeffs(bt, freq, gain, q, sr),
                    j_svf.svf_coeffs(bt, freq, gain, q, sr)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sr", [44100.0, 48000.0, 96000.0, 384000.0])
def test_output_filter_coeffs_match(sr):
    a = t_of.output_filter_coeffs(sr)
    b = j_of.output_filter_coeffs(sr)
    assert a == b


@pytest.mark.parametrize("sr,fc", [(48000.0, 3.0), (384000.0, 1.0),
                                   (44100.0, 3.0)])
def test_dc_and_pole_helpers_match(sr, fc):
    assert t_dc.dc_blocker_alphas(sr, fc) == j_dc.dc_blocker_alphas(sr, fc)
    for a1, a2 in ((-1.9, 0.91), (0.3, 0.5), (-1.99, 0.0), (0.1, -0.2)):
        assert t_scan._biquad_pole_radius(a1, a2) == \
            j_scan._biquad_pole_radius(a1, a2)


@pytest.mark.parametrize("seed,stereo,structure", [(0, True, 0), (1, False, 0),
                                                   (2, False, 1)])
def test_eq_response_helpers_match(seed, stereo, structure):
    pj, pt = _eq_pair(seed, stereo, structure)
    np.testing.assert_array_equal(t_eq.band_active_mask(pt),
                                  j_eq.band_active_mask(pj))
    freqs = np.linspace(0.0, 24000.0, 257)
    for a, b in zip(t_eq._band_matrix_response(pt, 48000.0, freqs),
                    j_eq._band_matrix_response(pj, 48000.0, freqs)):
        np.testing.assert_array_equal(a, b)
    assert t_eq._eq_ring_tail_samples(pt, 48000.0) == \
        j_eq._eq_ring_tail_samples(pj, 48000.0)
    c = [float(v[3]) for v in j_svf.svf_coeffs(pj.band_types, pj.freqs,
                                               pj.gains_db, pj.qs, 48000.0)]
    bq_t = t_eqa.svf_to_biquad(*c)
    assert bq_t == j_eqa.svf_to_biquad(*c)
    np.testing.assert_array_equal(t_eqa.biquad_response(bq_t, freqs, 48000.0),
                                  j_eqa.biquad_response(bq_t, freqs, 48000.0))


def test_dsputil_matches():
    assert t_dsp.K_OUTPUT_HEADROOM == j_dsp.K_OUTPUT_HEADROOM
    for m in (0.0, 0.3, 0.5, 1.0):
        assert float(t_dsp.equal_power_sin(m)) == float(j_dsp.equal_power_sin(m))
    for n in (0, 1, 2, 3, 1000, 65536, 65537):
        assert t_dsp.next_pow2(n) == j_dsp.next_pow2(n)
    db = np.linspace(-40, 20, 13)
    np.testing.assert_allclose(t_dsp.db_to_linear(db),
                               np.asarray(j_dsp.db_to_linear(db)), rtol=1e-13)


@pytest.mark.parametrize("cfg_kw,eq_seed,use_spec,dc_passes", [
    ({}, 0, True, 2),
    ({}, None, True, 2),
    ({"order": 0}, 3, False, 2),
    ({"conv_hc_mode": 0, "conv_lc_mode": 1}, 4, True, 1),
    ({"eq_lpf_mode": 2, "order": 0, "sample_rate": 44100.0}, 5, True, 2),
])
def test_fused_prefilter_ir_matches(cfg_kw, eq_seed, use_spec, dc_passes):
    cj = j_chain.ChainConfig(**cfg_kw)
    ct = t_chain.ChainConfig(**cfg_kw)
    pj, pt = _eq_pair(eq_seed) if eq_seed is not None else (None, None)
    sj, st = _spec_pair(sample_rate=ct.sample_rate)
    gj = j_chain.fused_prefilter_ir(cj, pj, spec=sj if use_spec else None,
                                    dc_passes=dc_passes)
    gt = t_chain.fused_prefilter_ir(ct, pt, spec=st if use_spec else None,
                                    dc_passes=dc_passes)
    assert gt.shape == gj.shape
    np.testing.assert_allclose(gt, gj, rtol=1e-13,
                               atol=1e-13 * np.abs(gj).max())
    assert t_chain.fused_eligible(ct, pt, True) == \
        j_chain.fused_eligible(cj, pj, True)


@pytest.mark.parametrize("ir_len", [10, 65_000, 85_149, 300_000, 1_065_149,
                                    2_100_000, 10 ** 7])
def test_throughput_partition_size_matches(ir_len):
    assert t_chain.throughput_partition_size(ir_len) == \
        j_chain.throughput_partition_size(ir_len, f64=False)


@pytest.mark.parametrize("req", [0, 1, 2, 3, 4, 8, 16])
def test_resolve_oversampling_factor_matches(req):
    for sr in (44100.0, 96000.0, 192000.0, 384000.0, 768000.0, 1e6):
        assert t_chain.resolve_oversampling_factor(req, sr) == \
            j_chain.resolve_oversampling_factor(req, sr)
