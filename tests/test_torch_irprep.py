"""The port's IR preparation (convopeq_tpu_torch/ir/: minimum and mixed
phase, the allpass designer and its CMA-ES, `analyze_ir`) and its host
copies (utils/wavio.py, engine/cache.py) against the JAX package's on
the same seeded inputs, f64 on the CPU: equal to <= 1e-12, with the same
allpass sections from the same seed; and against the reference binary's
`minphase`, `iranalyzer` and `allpass` vectors at the tolerances of
tests/test_ref_vectors.py."""
import json
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from convopeq_tpu.engine import cache as jcache
from convopeq_tpu.ir import allpass as ja
from convopeq_tpu.ir import analyzer as jan
from convopeq_tpu.ir import cmaes as jc
from convopeq_tpu.ir import phase as jp
from convopeq_tpu.utils import wavio as jw
from convopeq_tpu_torch.engine import cache as tcache
from convopeq_tpu_torch.ir import allpass as ta
from convopeq_tpu_torch.ir import analyzer as tan
from convopeq_tpu_torch.ir import cmaes as tc
from convopeq_tpu_torch.ir import phase as tp
from convopeq_tpu_torch.utils import wavio as tw

SR = 48000.0
VEC = Path(__file__).resolve().parent / "ref_harness" / "vectors"


def _load(name):
    return json.loads((VEC / name).read_text())


def _test_ir(n=3000, seed=21):
    t = np.arange(n)
    ir = np.random.default_rng(seed).normal(size=n) * np.exp(-t / 400.0)
    ir[0] = 1.0
    return ir


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b)))


def test_minimum_phase_and_fallback_match_jax():
    ir = np.stack([_test_ir(2000), np.concatenate([np.zeros(200),
                                                   _test_ir(1800, 5)])])
    mp = tp.minimum_phase(ir)
    _close(mp, jp.minimum_phase(ir))
    for ch in range(2):
        for lo, hi in ((200.0, 700.0), (200.0, 1000.0)):
            _close(tp.mixed_phase_fallback(ir[ch], mp[ch], SR, lo, hi),
                   jp.mixed_phase_fallback(ir[ch], mp[ch], SR, lo, hi))


def test_unwrap_and_group_delay_equal_jax():
    rng = np.random.default_rng(4)
    ph = rng.normal(size=700) * 2.5
    np.testing.assert_array_equal(tp.unwrap_phase(ph), jp.unwrap_phase(ph))
    np.testing.assert_array_equal(tp.unwrap_phase_delta(ph),
                                  jp.unwrap_phase_delta(ph))
    # the low-magnitude bins' fill, against the JAX package's loop
    # (phase.py:228-231) written out
    phi, mag = rng.normal(size=300), rng.uniform(0.0, 1.0, 300)
    mag[[0, 1, 7, 8, 9, 299]] = 0.0
    ref = phi.copy()
    for i in range(len(ref)):
        if mag[i] < 1e-10:
            ref[i] = ref[i - 1] if i > 0 else 0.0
    np.testing.assert_array_equal(
        tp._forward_fill(phi, ~(mag < 1e-10), first=0.0), ref)
    # steep, noisy and non-finite targets exercise the slope limit's holds
    for peak_delay, step in ((30, 0.05), (200, 0.4), (5, 1.5)):
        phi = np.cumsum(rng.normal(size=2049) * step) - 0.01 * np.arange(2049)
        phi[[17, 400, 401]] = np.nan
        np.testing.assert_array_equal(
            tp._target_group_delay(phi, peak_delay, 4096, 2049),
            jp._target_group_delay(phi, peak_delay, 4096, 2049))


@pytest.mark.parametrize("case", ["allpass", "fallback"])
def test_mixed_phase_allpass_matches_jax(case):
    """Both branches of the magnitude gate: an IR long enough to absorb
    the allpass delay takes the design, a truncating one is rejected
    (None) in both packages (tests/test_irprep.py's fixtures)."""
    if case == "allpass":
        ir = np.concatenate([np.zeros(64), _test_ir(4096)])[:4096]
        kw = dict(num_sections=6, freq_points=64, generations=12,
                  population=16)
    else:
        ir = np.concatenate([np.zeros(64), _test_ir(500)])[:512]
        kw = dict(num_sections=6, freq_points=64, generations=10,
                  population=12, max_mag_err_db=0.5)
    mp = tp.minimum_phase(ir)
    got = tp.mixed_phase_allpass(ir, mp, SR, 200.0, 700.0, **kw)
    ref = jp.mixed_phase_allpass(ir, mp, SR, 200.0, 700.0, **kw)
    if case == "fallback":
        assert got is None and ref is None
    else:
        assert got is not None and ref is not None
        _close(got, ref)


def test_design_cmaes_and_greedy_give_jax_sections():
    freq = np.exp(np.linspace(np.log(50.0), np.log(20000.0), 48))
    target = 8.0 + 4.0 * np.sin(np.linspace(0.0, 3.0, 48))
    cfg_t = ta.DesignerConfig(num_sections=4, cmaes_max_generations=30,
                              cmaes_population=24, cmaes_initial_sigma=1.0)
    cfg_j = ja.DesignerConfig(num_sections=4, cmaes_max_generations=30,
                              cmaes_population=24, cmaes_initial_sigma=1.0)
    for design in ("design_cmaes", "design_greedy_adagrad"):
        st, ct = getattr(ta, design)(SR, freq, target, cfg_t)
        sj, cj = getattr(ja, design)(SR, freq, target, cfg_j)
        assert [(s.rho, s.theta) for s in st] == \
            [(s.rho, s.theta) for s in sj], design
        assert ct == cj
    w = np.linspace(0.01, np.pi - 0.01, 64)
    _close(ta.compute_response(st, SR, w * SR / (2 * np.pi)),
           ja.compute_response(sj, SR, w * SR / (2 * np.pi)))
    _close(ta.sections_group_delay([0.6, 0.3], [0.8, 2.0], w),
           ja.sections_group_delay([0.6, 0.3], [0.8, 2.0], w))


def test_cmaes_equals_jax():
    target = np.array([0.5, -1.2, 2.0])

    def cost(x):
        return float(np.sum((x - target) ** 2))
    bt, ft = tc.minimize(cost, dim=3, generations=120, population=18,
                         elite=6, seed=1)
    bj, fj = jc.minimize(cost, dim=3, generations=120, population=18,
                         elite=6, seed=1)
    np.testing.assert_array_equal(bt, bj)
    assert ft == fj and ft < 1e-2
    u = np.array([-5.0, 0.0, 5.0])
    np.testing.assert_array_equal(tc.CmaEs.to_parcor(u), jc.CmaEs.to_parcor(u))
    np.testing.assert_allclose(np.tanh(tc.CmaEs.parcor_to_unconstrained(
        np.array([0.5]))), 0.5, atol=1e-12)


def test_analyze_ir_equals_jax():
    t = np.arange(8192)
    irs = [np.sin(2 * np.pi * 0.02 * t) * np.exp(-t / 2000.0),
           np.stack([_test_ir(5000), 0.5 * _test_ir(5000, 9)]),
           np.zeros(100)]
    for ir in irs:
        assert asdict(tan.analyze_ir(ir)) == asdict(jan.analyze_ir(ir))
    a = tan.analyze_ir(irs[1])
    assert a.l1_norm == np.abs(irs[1]).sum(axis=-1).max()


def test_wavio_round_trip_equals_jax(tmp_path):
    """The same bytes written, the same samples read, for every format."""
    x = np.random.default_rng(6).uniform(-1.0, 1.0, (2, 1001))
    for bits, flt in ((32, True), (64, True), (16, False), (24, False),
                      (32, False)):
        pt, pj = tmp_path / f"t{bits}{flt}.wav", tmp_path / f"j{bits}{flt}.wav"
        tw.write_wav(pt, x, 48000, bits=bits, float_format=flt)
        jw.write_wav(pj, x, 48000, bits=bits, float_format=flt)
        assert pt.read_bytes() == pj.read_bytes()
        rt = tw.read_wav(pt)
        rj = jw.read_wav(pt)
        assert rt.sample_rate == rj.sample_rate == 48000
        np.testing.assert_array_equal(rt.samples, rj.samples)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX0000WAVE")
    with pytest.raises(ValueError):
        tw.read_wav(bad)


def test_caches(tmp_path, monkeypatch):
    ir = _test_ir(300)
    assert tcache.content_hash(ir, 48000.0, "mixed") == \
        jcache.content_hash(ir, 48000.0, "mixed")
    lru = tcache.LRUCache(max_entries=2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1
    lru.put("c", 3)                      # evicts b, the least recent
    assert lru.get("b") is None and len(lru) == 2
    disk = tcache.MixedPhaseDiskCache(tmp_path / "mp", max_entries=2)
    keys = [disk.make_key(ir * (k + 1), 48000.0, "mixed", 200.0, 1000.0)
            for k in range(3)]
    for k, key in enumerate(keys):
        disk.store(key, ir * k)
    assert disk.load(keys[0]) is None
    np.testing.assert_array_equal(disk.load(keys[2]), ir * 2)
    assert len(list((tmp_path / "mp").glob("*.npz"))) == 2
    monkeypatch.setenv("HOME", str(tmp_path))     # the port's own default
    assert tcache.MixedPhaseDiskCache().dir == \
        tmp_path / ".cache" / "convopeq_tpu_torch" / "mixedphase"


def test_minimum_phase_matches_reference_binary():
    v = _load("minphase.json")
    for c in v["minphase"]:
        for ch in range(c["channels"]):
            want = np.asarray(c[f"output_{ch}"])
            got = tp.minimum_phase(np.asarray(c[f"input_{ch}"]))
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-13 * max(1.0, np.abs(want).max()))


def test_mixed_phase_fallback_matches_reference_binary():
    v = _load("minphase.json")
    mp_by = {c["name"]: c for c in v["minphase"]}
    for c in v["fallback"]:
        mp = mp_by[c["mp_case"]]
        for ch in range(c["channels"]):
            want = np.asarray(c[f"output_{ch}"])
            got = tp.mixed_phase_fallback(
                np.asarray(mp[f"input_{ch}"]), np.asarray(mp[f"output_{ch}"]),
                48000.0, float(c["lo"]), float(c["hi"]))
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-13 * max(1.0, np.abs(want).max()))


def _xs64(seed, n):
    """xorshift64* uniform in [-0.5, 0.5) (tests/test_ref_vectors.py's
    mirror of the reference dumps' generator)."""
    mask = (1 << 64) - 1
    s = seed
    out = np.empty(n)
    for i in range(n):
        s ^= (s >> 12)
        s = (s ^ (s << 25)) & mask
        s ^= (s >> 27)
        r = (s * 2685821657736338717) & mask
        out[i] = (r >> 11) * (1.0 / 9007199254740992.0) - 0.5
    return out


def test_ir_analyzer_matches_reference_binary():
    v = _load("iranalyzer.json")
    for c in v["cases"]:
        if c["ir"] is not None:
            ir = np.asarray(c["ir"])
        else:
            n = int(c["n"])
            ir = _xs64(0xC3, n) * np.exp(-np.arange(n) / 20000.0)
            i = np.arange(n)
            ir[70000:] += 0.8 * np.sin(2 * np.pi * i[70000:] * 0.02)
        got = tan.estimate_max_frequency_gain(ir)
        want = float(c["gain"])
        assert abs(got - want) <= 1e-11 * max(1.0, abs(want)), c["name"]


def test_allpass_formulas_match_reference_binary():
    d = _load("allpass.json")["formula"]
    gd = np.array([ta.sections_group_delay([r], [t], [o])[0]
                   for r, t, o in zip(d["rho"], d["theta"], d["omega"])])
    np.testing.assert_allclose(gd, d["gd"], rtol=0, atol=1e-12)
    h = np.array([ta.SecondOrderAllpass(r, t).response(np.array([o]))[0]
                  for r, t, o in zip(d["rho"], d["theta"], d["omega"])])
    np.testing.assert_allclose(h.real, d["h_re"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(h.imag, d["h_im"], rtol=0, atol=1e-12)
    c = _load("allpass.json")["compute_response"]
    secs = [ta.SecondOrderAllpass(r, t)
            for r, t in zip([0.2, 0.5, 0.8, 0.92, 0.97, 0.4],
                            [0.05, 0.3, 0.9, 1.7, 2.6, 3.0])]
    h = ta.compute_response(secs, 48000.0, c["freq_hz"])
    np.testing.assert_allclose(h.real, c["h_re"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(h.imag, c["h_im"], rtol=0, atol=1e-12)


def test_allpass_greedy_design_matches_reference_binary():
    for g in _load("allpass.json")["greedy"]:
        assert g["ok"] == 1
        secs, cost = ta.design_greedy_adagrad(
            48000.0, g["freq_hz"], g["target_gd"],
            ta.DesignerConfig(num_sections=g["num_sections"]))
        np.testing.assert_allclose([s.rho for s in secs], g["rho"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose([s.theta for s in secs], g["theta"],
                                   rtol=0, atol=1e-9)
        assert abs(cost - g["cost"]) <= 1e-6 * max(1.0, g["cost"])


def test_allpass_cmaes_quality_vs_reference_binary():
    c = _load("allpass.json")["cmaes"]
    freq, target = np.asarray(c["freq_hz"]), np.asarray(c["target_gd"])
    om = 2.0 * np.pi * freq / 48000.0

    def sqcost(secs):
        tau = ta.sections_group_delay([s.rho for s in secs],
                                      [s.theta for s in secs], om)
        return float(np.sum((tau - target) ** 2))
    cfg = ta.DesignerConfig(num_sections=8)
    secs, _ = ta.design_cmaes(48000.0, freq, target, cfg)
    assert sqcost(secs) <= 1.3 * c["cost"]
    _, gcost = ta.design_greedy_adagrad(48000.0, freq, target, cfg)
    assert gcost <= c["cost"]
