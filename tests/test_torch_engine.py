"""The port's ConvoPeqEngine (convopeq_tpu_torch/engine/engine.py) against
the JAX package's, in f64 on the CPU, on the same seeded inputs.

The JAX engine's `process` runs `jax.jit` closures; XLA's jit rounds the
output filter's near-DC f64 2x2 scans differently from its own eager run
(~4e-11 relative RMS on these chains), so the parity checks run it under
`jax.disable_jit()`, where the packages agree as the staged chain does
(tests/test_torch_staged_chain.py): end to end at <= 1e-11.  Each engine
gets its own temporary mixed-phase cache directory, so neither package's
cached design can stand in for the other's."""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.engine import engine as je
from convopeq_tpu_torch.engine import engine as te
from convopeq_tpu_torch.models.chain import (prepare_folded_convolver,
                                             process_chain_fused)
from convopeq_tpu_torch.models.gain_planner import CONVOLVER_THEN_EQ
from convopeq_tpu_torch.runtime.crossfade import crossfade_mix

SR = 48000.0
TOL = 1e-11
# 1,024-sample buffers through the output filter's near-DC 2x2 scans: the
# packages agree there at 1.2e-11 (8,192 samples: within TOL)
RAMP_TOL = 2e-11


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _ir(n=4000, seed=33):
    t = np.arange(n)
    ir = np.random.default_rng(seed).normal(size=(2, n)) * np.exp(-t / 600.0)
    ir[:, 0] = 1.0
    return ir


def _x(n=8192, seed=1, batch=(1,)):
    return np.random.default_rng(seed).normal(size=batch + (2, n)) * 0.2


@pytest.fixture
def engines(tmp_path):
    """A factory of (JAX engine, port engine) pairs: f64, the port on the
    CPU, each with its own mixed-phase cache directory."""
    count = iter(range(100))

    def make(block_size=512):
        k = next(count)
        return (je.ConvoPeqEngine(SR, block_size,
                                  mixed_phase_cache_dir=tmp_path / f"j{k}"),
                te.ConvoPeqEngine(SR, block_size, dtype=torch.float64,
                                  device="cpu",
                                  mixed_phase_cache_dir=tmp_path / f"t{k}"))
    return make


def _jax_process(eng, x, **kw):
    with jax.disable_jit():
        return np.asarray(eng.process(jnp.asarray(x), **kw))


def _configure(e, ir):
    e.load_impulse_response(ir, SR)
    e.set_eq_band(0, band_type=1, freq=1000.0, gain_db=6.0, q=1.0)
    e.set_eq_band(7, band_type=2, freq=6000.0, gain_db=-3.0, q=0.7)
    e.set_soft_clip(True, 0.3)
    e.set_auto_gain(True)
    return e


def test_end_to_end_matches_jax(engines):
    """EQ -> conv, soft clip 0.3, auto gain, no dither: the output, the
    plan, the effective config and the latency breakdown."""
    j, t = engines()
    ir, x = _ir(), _x()
    _configure(j, ir)
    _configure(t, ir)
    yj = _jax_process(j, x)
    yt = t.process(torch.from_numpy(x))
    assert isinstance(yt, torch.Tensor) and yt.dtype == torch.float64
    assert yt.shape == x.shape and torch.isfinite(yt).all()
    assert _rel(yt.numpy(), yj) <= TOL
    assert asdict(t.auto_gain_plan()) == asdict(j.auto_gain_plan())
    assert asdict(t._effective_config()) == asdict(j._effective_config())
    assert asdict(t.latency_breakdown()) == asdict(j.latency_breakdown())
    plan = t.auto_gain_plan()
    assert plan.input_headroom_db < 0.0 and plan.output_makeup_db > 0.0
    lb = t.latency_breakdown()
    assert lb.algorithm_latency_samples == 512
    assert lb.softclip_latency_samples == 15


@pytest.mark.parametrize("shaper", [1, 0])
def test_dither_on_grid_and_against_jax(engines, shaper):
    """Dither to 16 bits after the chain, the JAX engine's uniforms
    (jax.random.uniform of its key) passed to the port.  Both shapers:
    every sample on the grid.  fixed4 (1): no sample more than one LSB
    from the JAX output.  psycho (0) is held to the grid only: XLA:CPU
    contracts its 12-term sum into FMAs inside the jitted scan, which
    flips a rounding within a few hundred samples and the error feedback
    carries the flip on (tests/test_torch_dither.py; the port's psycho
    shaper is held bit for bit to the reference binary's psycho.json)."""
    j, t = engines()
    ir, x = _ir(), _x()
    for e in (j, t):
        _configure(e, ir).set_dither(shaper, 16)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, x.shape + (2,), dtype=jnp.float64))
    # jitted: run eagerly, the quantizer's lax.scan would loop in Python
    yj = np.asarray(j.process(jnp.asarray(x), key=key))
    yt = t.process(torch.from_numpy(x), uniforms=torch.from_numpy(u.copy()))
    grid = yt.numpy() * 32768.0
    np.testing.assert_allclose(grid, np.round(grid), atol=1e-9)
    assert np.abs(grid).max() > 100.0
    if shaper == 1:
        assert np.max(np.abs(grid - yj * 32768.0)) <= 1.0 + 1e-9
    # without uniforms or a generator: a deterministic default
    np.testing.assert_array_equal(t.process(torch.from_numpy(x)).numpy(),
                                  t.process(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("case", ["minimum", "mixed_allpass",
                                  "mixed_fallback"])
def test_phase_loads_match_jax(engines, case):
    """The loader's phase transforms: the prepared (trimmed, transformed,
    scaled) IR, its scale, peak latency and frequency peak equal the JAX
    engine's; mixed phase takes the allpass design on an IR long enough to
    absorb its delay and the spectral blend on a truncating one, and a
    second load of the same IR reads the disk cache."""
    j, t = engines()
    if case == "minimum":
        ir = np.zeros((2, 2000))
        ir[:, 300] = 1.0
        ir[1, 500] = 0.4
        mode, seconds = te.PHASE_MINIMUM, 2000 / SR
    elif case == "mixed_allpass":
        ir = np.stack([np.concatenate([np.zeros(64), _ir(4096, s)[0]])[:4096]
                       for s in (21, 22)])
        mode, seconds = te.PHASE_MIXED, 4096 / SR
    else:
        # 80 undamped taps: the allpass sections' ringing falls off the
        # IR's end and the magnitude gate rejects the design
        ir = np.stack([np.concatenate([np.zeros(16), np.random.default_rng(
            s).normal(size=64)]) for s in (21, 22)])
        mode, seconds = te.PHASE_MIXED, 80 / SR
    j.load_impulse_response(ir, SR, phase_mode=mode, target_seconds=seconds)
    t.load_impulse_response(ir, SR, phase_mode=mode, target_seconds=seconds)
    ref = j._ir_prepared
    assert np.max(np.abs(t._ir_prepared - ref)) <= 1e-12 * np.abs(ref).max()
    assert t._ir_peak_latency == j._ir_peak_latency
    assert abs(t._ir_scale - j._ir_scale) <= 1e-12 * j._ir_scale
    assert abs(t._ir_freq_peak_db - j._ir_freq_peak_db) <= 1e-9
    if case == "minimum":
        assert t._ir_peak_latency < 50
    else:
        branch = case.split("_")[1]
        assert t.mixed_phase_branches == [branch, branch]
        t2 = te.ConvoPeqEngine(SR, 512, dtype=torch.float64, device="cpu",
                               mixed_phase_cache_dir=t._mp_cache.dir)
        t2.load_impulse_response(ir, SR, phase_mode=mode,
                                 target_seconds=seconds)
        assert t2.mixed_phase_branches == ["cache", "cache"]
        np.testing.assert_array_equal(t2._ir_prepared, t._ir_prepared)


def test_prepared_cache_jump_protection_and_latency(engines):
    j, t = engines()
    ir = _ir(2000)
    t.load_impulse_response(ir, SR)
    first = t._conv_state
    t.load_impulse_response(ir, SR)            # identical -> cache hit
    assert t._conv_state is first
    # the loader's host functions equal the JAX package's
    rng = np.random.default_rng(11)
    quiet, loud = rng.normal(size=(2, 2000)) * 1e-3, rng.normal(
        size=(2, 2000)) * 0.5
    t_res = np.arange(8192)
    res = (np.sin(2 * np.pi * 0.02 * t_res) * np.exp(-t_res / 2000.0))[None]
    for f in ("energy_scale", "estimate_peak_latency"):
        for a in (ir, loud, res, np.zeros((1, 100))):
            assert getattr(te, f)(a) == getattr(je, f)(a)
    for a, cur in ((loud, quiet * je.compute_ir_scale(quiet)), (res, None),
                   (ir, loud)):
        assert te.compute_ir_scale(a, cur) == je.compute_ir_scale(a, cur)
    for args in ((0.8, 0.1, 0.1, 0.05), (0.3, 0.4, 0.2, 0.05),
                 (0.4, 0.2, 0.01, 0.01), (0.8, 0.4, 0.0, 0.0),
                 (0.6, 0.3, 0.2, 0.1)):
        assert te.jump_protection_clamp(*args) == \
            je.jump_protection_clamp(*args)
    assert te.jump_protection_clamp(0.8, 0.1, 0.1, 0.05) == 0.5
    np.testing.assert_array_equal(te.trim_ir(ir, SR, 1500),
                                  je.trim_ir(ir, SR, 1500))
    np.testing.assert_array_equal(te.trim_ir(ir, SR, 5000),
                                  je.trim_ir(ir, SR, 5000))
    # the latency model at 1x, 2x and 4x, with and without the soft clip
    j.load_impulse_response(ir, SR)
    for os_factor, clip in ((1, True), (2, False), (4, True)):
        for e in (j, t):
            e.set_oversampling(os_factor)
            e.set_soft_clip(clip, 0.5)
        assert asdict(t.latency_breakdown()) == asdict(j.latency_breakdown())
    assert t.latency_breakdown().oversampling_latency_samples > 0


def _jax_state_engine(tmp_path):
    j = je.ConvoPeqEngine(SR, 512, mixed_phase_cache_dir=tmp_path / "js")
    j.set_eq_band(3, band_type=2, freq=8000.0, gain_db=-4.0, q=0.9, mode=3)
    j.set_eq_band(11, enabled=False)
    j.set_processing_order(CONVOLVER_THEN_EQ)
    j.set_oversampling(4)
    j.set_soft_clip(True, 0.7)
    j.set_wet_dry_mix(0.8)
    j.set_dither(2, 24)
    j.set_auto_gain(True)
    j.phase_mode = te.PHASE_MIXED
    j.target_ir_seconds = 0.75
    j.mixed_f1, j.mixed_f2 = 150.0, 900.0
    j.filter_spec = replace(j.filter_spec, tail_start_seconds=0.1,
                            tail_strength=0.5, hc_mode=1)
    j.enable_direct_head = True
    j.learning_mode = 2
    j.adaptive_banks.set(SR, 24, 2, np.linspace(-0.5, 0.5, 9))
    return j


def test_state_json_across_packages(tmp_path):
    """The port's load_state reads the JAX engine's save_state text and
    gives the same engine: its own save_state equals the JAX text field
    for field; and the JAX engine reads the port's text back."""
    j = _jax_state_engine(tmp_path)
    text = j.save_state()
    t = te.ConvoPeqEngine(SR, 512, dtype=torch.float64, device="cpu",
                          mixed_phase_cache_dir=tmp_path / "ts")
    t.load_state(text)
    assert t.save_state() == text
    assert asdict(t.config) == asdict(j.config)
    assert t.eq_params.config_key() == j.eq_params.config_key()
    assert asdict(t.filter_spec) == asdict(j.filter_spec)
    np.testing.assert_array_equal(t.adaptive_banks.get(SR, 24, 2),
                                  j.adaptive_banks.get(SR, 24, 2))
    assert (t.phase_mode, t.target_ir_seconds, t.enable_direct_head,
            t.learning_mode) == (j.phase_mode, j.target_ir_seconds, True, 2)
    j2 = je.ConvoPeqEngine(SR, 512, mixed_phase_cache_dir=tmp_path / "j2")
    assert j2.load_state(t.save_state()).save_state() == text


def test_streaming_matches_offline(engines):
    """process_streaming (the staged step, eq scanned) against process in
    f64, then the stream continued with its carry; the folded chain
    against the offline folded chain past its warm-up."""
    _, t = engines()
    ir = np.zeros((2, 2000))
    ir[:, 0] = 1.0
    ir[:, 700] = 0.3
    t.load_impulse_response(ir, SR, target_seconds=2000 / SR)
    t.set_eq_band(0, band_type=1, freq=800.0, gain_db=4.0, q=1.0)
    t.config = replace(t.config, eq_method="scan")
    x = torch.from_numpy(_x(4096, 5, batch=()))
    off = t.process(x)
    y, carry = t.process_streaming(x)
    assert _rel(y.numpy(), off.numpy()) < 1e-9
    y2, carry2 = t.process_streaming(x, carry)
    assert y2.shape == x.shape and carry2.chain is carry.chain
    rep = t.telemetry_report()
    assert rep["steps"] == 16 and "xruns" in rep

    sc = t.streaming_chain(folded=True)
    assert sc.block_size == 512
    cfg = t._effective_config()
    st = prepare_folded_convolver(torch.from_numpy(t._ir_prepared), 512,
                                  t.filter_spec, cfg, t.eq_params,
                                  dtype=torch.float64, partition=None,
                                  device="cpu")
    xl = torch.from_numpy(_x(16384, 6, batch=()))
    y_off = process_chain_fused(xl, cfg, st).numpy()
    y_fold, _ = sc.process(xl)
    warm = sc.warmup_samples()
    assert _rel(y_fold.numpy()[..., warm:], y_off[..., warm:]) < 1e-9
    bb = t.streaming_chain(folded=True, partition=4 * 512)
    assert bb.block_size == 2048 and len(bb.layers) == 1
    with pytest.raises(ValueError):
        t.streaming_chain(partition=4096)


def test_streaming_dither_and_crossfade(engines):
    """Dithered streaming draws its uniforms from the engine's generator
    (on the 24-bit grid); a structural change mid-stream crossfades from
    the old chain, whose output fades out over the fade window."""
    _, t = engines()
    t.load_impulse_response(_ir(2000), SR, target_seconds=2000 / SR)
    t.set_bypass(eq=True)
    t.set_dither(0, 24)
    x = torch.from_numpy(_x(4096, 7))
    y, carry = t.process_streaming(x)
    grid = y.numpy() * 8388608.0
    np.testing.assert_allclose(grid, np.round(grid), atol=1e-6)
    assert carry.block == 8 and carry.dither.shape == (1, 2, 12)
    t.set_soft_clip(True, 0.4)
    y2, _ = t.process_streaming(x, carry)
    assert torch.isfinite(y2).all()
    events = [e for e in t.telemetry.events if e.category == "crossfade"]
    assert events and events[-1].detail["path"] == "streaming"


def test_structural_change_crossfades_as_jax(engines):
    """Soft clip on -> off between two process calls: the port's fade
    window equals crossfade_mix of the old and the new chains' outputs,
    and the whole output equals the JAX engine's."""
    j, t = engines()
    ir, x = _ir(), _x()
    for e in (j, t):
        _configure(e, ir)
    yj0 = _jax_process(j, x)
    t.process(torch.from_numpy(x))
    old_fn, old_conv = t._published["fn"], t._published["conv"]
    for e in (j, t):
        e.set_soft_clip(False)
    yj = _jax_process(j, x)
    yt = t.process(torch.from_numpy(x))
    assert torch.isfinite(yt).all()
    assert _rel(yt.numpy(), yj) <= TOL
    ev = [e for e in t.telemetry.events if e.category == "crossfade"][-1]
    fade_n = int(round(ev.detail["fade_ms"] * 1e-3 * SR))
    assert 1 < fade_n < x.shape[-1]
    y_old = old_fn(torch.from_numpy(x), old_conv)
    y_new = t._published["fn"](torch.from_numpy(x), t._conv_state)
    want = crossfade_mix(y_old[..., :fade_n], y_new[..., :fade_n], SR,
                         ev.detail["fade_ms"] * 1e-3)
    np.testing.assert_allclose(yt[..., :fade_n].numpy(), want.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(yt[..., fade_n:].numpy(),
                                  y_new[..., fade_n:].numpy())
    assert _rel(yj0[..., :fade_n], yj[..., :fade_n]) > 1e-6


def test_structural_change_with_mix_change_still_crossfades(engines):
    """A mix change riding along with a new IR does not suppress the
    structural crossfade (the mix-stripped chain key differs)."""
    _, t = engines()
    rng = np.random.default_rng(9)
    ir_a = rng.normal(size=1200) * np.exp(-np.arange(1200) / 200.0)
    ir_b = rng.normal(size=1200) * np.exp(-np.arange(1200) / 200.0)
    t.set_bypass(eq=True)
    t.load_impulse_response(ir_a, SR)
    x = torch.from_numpy(rng.normal(size=(1, 2, 8192)) * 0.25)
    t.process(x)
    t.set_wet_dry_mix(0.7)
    t.load_impulse_response(ir_b, SR)
    t.process(x)
    assert "crossfade" in [e.category for e in t.telemetry.events]


def test_mix_ramp_spans_short_buffers_as_jax(engines):
    """A mix change whose smoothing window (4,800 steps) outlasts a
    1,024-sample buffer ramps on across calls and retargets from the value
    reached; every call's output equals the JAX engine's."""
    j, t = engines()
    rng = np.random.default_rng(10)
    ir = np.zeros(800)
    ir[0] = 1.0
    ir[300] = 0.5
    for e in (j, t):
        e.set_bypass(eq=True)
        e.load_impulse_response(ir, SR)
        e.set_mix_smoothing_time(0.1)
        e.set_wet_dry_mix(0.0)
    x0 = rng.normal(size=(1, 2, 8192)) * 0.2
    _jax_process(j, x0)
    t.process(torch.from_numpy(x0))
    assert t._pending_mix_ramp is None
    for e in (j, t):
        e.set_wet_dry_mix(1.0)
    x = rng.normal(size=(1, 2, 1024)) * 0.2
    for k in (1, 2):
        yj = _jax_process(j, x)
        yt = t.process(torch.from_numpy(x)).numpy()
        assert _rel(yt, yj) <= RAMP_TOL
        reached, remaining = t._pending_mix_ramp
        assert (reached, remaining) == j._pending_mix_ramp
        np.testing.assert_allclose(reached, 1024 * k / 4800, rtol=1e-12)
        assert remaining == 4800 - 1024 * k
    t.set_wet_dry_mix(0.25)
    assert t._pending_mix_ramp == reached
    t.process(torch.zeros(1, 2, 8192, dtype=torch.float64))
    assert t._pending_mix_ramp is None


def test_progressive_upgrade_ladder(engines):
    """The ladder {1024, 2048, 4096} filtered to (current, target]; the
    background worker publishes each step (joined here); a new IR load
    (generation bump) or cancel() stops an upgrader; the upgraded engine
    processes on its new partition."""
    _, t = engines()
    rng = np.random.default_rng(5)
    ir = rng.normal(size=(2, 4000)) * np.exp(-np.arange(4000) / 600.0) * 0.2
    t.load_impulse_response(ir, SR)
    seen = []
    up = t.progressive_upgrade(4096, background=True, on_step=seen.append)
    up.join(timeout=120)
    assert not up.is_alive()
    assert seen == [1024, 2048, 4096] and t.block_size == 4096
    assert t.latency_breakdown().algorithm_latency_samples == 4096
    assert t._conv_state.left.layer_spectra[0].device.type == "cpu"
    y = t.process(torch.from_numpy(_x(8192)))
    assert torch.isfinite(y).all()
    assert te.ProgressiveUpgrader(t, 4096).steps == []

    _, t2 = engines()
    t2.load_impulse_response(ir, SR)
    assert te.ProgressiveUpgrader(t2, 2048).steps == [1024, 2048]
    t2.progressive_upgrade(2048)
    assert t2.latency_breakdown().algorithm_latency_samples == 2048
    _, t3 = engines()
    t3.load_impulse_response(ir, SR)
    up2 = te.ProgressiveUpgrader(t3, 4096)
    t3.load_impulse_response(ir * 0.5, SR)
    up2.run()
    assert up2.completed_steps == []
    up3 = te.ProgressiveUpgrader(t3, 4096)
    up3.cancel()
    up3.run()
    assert up3.completed_steps == []
    with pytest.raises(RuntimeError):
        te.ConvoPeqEngine(SR, 512, device="cpu").progressive_upgrade(2048)


def test_unported_paths_raise_and_cuda_needs_a_card(tmp_path):
    t = te.ConvoPeqEngine(SR, 512, device="cpu",
                          mixed_phase_cache_dir=tmp_path / "t")
    assert t.dtype == torch.float32
    # the paths once unported now run: no session yet, then a session
    # started and stopped, and the evidence set written
    assert t.stop_learning() is None
    assert t.start_learning() is t and t._learn_thread is not None
    assert t.stop_learning(timeout=30.0).generations == 0
    assert t._learn_thread is None
    assert t.export_evidence_dir(tmp_path / "ev")["artifactCount"] == 16
    with pytest.raises(ValueError):
        te.ConvoPeqEngine(SR, 512, dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            te.ConvoPeqEngine(SR, 512, mixed_phase_cache_dir=tmp_path / "c")
