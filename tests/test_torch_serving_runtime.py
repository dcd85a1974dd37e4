"""The serving runtime's host parts in convopeq_tpu_torch: the crossfade
plane (`runtime/crossfade.py`) against convopeq_tpu's on the same inputs
in f64 (bit for bit) and `LinearRamp` against the reference binary's
vectors; telemetry (`runtime/telemetry.py`) against convopeq_tpu's
through the same events on one injected clock (recorder drops, the
stage timer, xruns and the warm-up exemption, health hysteresis, the
policy ladder); `serve.py`'s state budget against the JAX
tool's arithmetic and `StreamingChain.state_bytes` against the bytes
`init_state` allocates, and its
entry on the CPU at a tiny size (JSON lines out, no file written)."""
import dataclasses
import importlib.util
import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.runtime import crossfade as j_xf
from convopeq_tpu.runtime import evidence as j_ev
from convopeq_tpu.runtime import telemetry as j_tel
from convopeq_tpu_torch import serve
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import convolver as t_conv
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.runtime import crossfade as t_xf
from convopeq_tpu_torch.runtime import evidence as t_ev
from convopeq_tpu_torch.runtime import telemetry as t_tel
from convopeq_tpu_torch.runtime.streaming import StreamingChain

ROOT = Path(__file__).resolve().parents[1]
VECTORS = ROOT / "tests" / "ref_harness" / "vectors"
SR = 48000.0
SMALL_TAPS = 20_000


# ------------------------------------------------------------- crossfade

def test_classify_and_fade_time_match_jax():
    old = {"conv_bypassed": False, "oversampling_factor": 1,
           "conv_hc_mode": 1, "conv_lc_mode": 0, "phase_mode": 0,
           "tail_mode": 1, "enable_direct_head": False,
           "target_ir_seconds": 1.0}
    changes = [{}, {"conv_bypassed": True, "oversampling_factor": 2},
               {"conv_lc_mode": 1}, {"phase_mode": 1, "tail_mode": 0},
               {"enable_direct_head": True}, {"target_ir_seconds": 2.0}]
    for ch in changes:
        new = dict(old, **ch)
        trig = t_xf.classify_transition(old, new)
        assert trig == j_xf.classify_transition(old, new)
        assert t_xf.fade_time_for(trig) == j_xf.fade_time_for(trig)
    cfg_a = t_chain.ChainConfig()
    cfg_b = dataclasses.replace(cfg_a, oversampling_factor=4)
    assert t_xf.classify_transition(cfg_a, cfg_b) == ("oversampling",)
    assert t_xf.FADE_TIMES_SEC == j_xf.FADE_TIMES_SEC


@pytest.mark.parametrize("fade,offset,start", [(0.05, 0, 0), (0.03, 37, 0),
                                               (0.08, 0, 1500)])
def test_crossfade_mix_matches_jax(fade, offset, start):
    rng = np.random.default_rng(55)
    old, new = rng.normal(size=(2, 2, 4800)), rng.normal(size=(2, 2, 4800))
    yj = np.asarray(j_xf.crossfade_mix(jnp.asarray(old), jnp.asarray(new),
                                       SR, fade, offset, start))
    yt = t_xf.crossfade_mix(torch.from_numpy(old), torch.from_numpy(new),
                            SR, fade, offset, start)
    np.testing.assert_array_equal(yt.numpy(), yj)


def test_crossfade_blocks_match_jax_and_oneshot():
    rng = np.random.default_rng(56)
    old, new = rng.normal(size=(2, 4096)), rng.normal(size=(2, 4096))
    sj = j_xf.CrossfadeState(fade_samples=1440)
    st = t_xf.CrossfadeState(fade_samples=1440)
    outs = []
    for k in range(8):
        blk = slice(512 * k, 512 * (k + 1))
        sj, yj = j_xf.crossfade_blocks(sj, jnp.asarray(old[:, blk]),
                                       jnp.asarray(new[:, blk]), SR)
        st, yt = t_xf.crossfade_blocks(st, torch.from_numpy(old[:, blk]),
                                       torch.from_numpy(new[:, blk]), SR)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert st.position == sj.position and st.active == sj.active
        outs.append(yt)
    one = t_xf.crossfade_mix(torch.from_numpy(old), torch.from_numpy(new),
                             SR, 1440 / SR)
    np.testing.assert_array_equal(torch.cat(outs, -1).numpy(), one.numpy())


def test_linear_ramp_matches_reference_binary():
    """LinearRamp: plain fade, mid-ramp retarget, idle retarget and an
    equal-target no-op, as tests/test_ref_vectors.py runs them."""
    d = json.loads((VECTORS / "engine_math.json").read_text())
    for sc in d["linear_ramp"]:
        r = t_xf.LinearRamp(current=sc["from"], target=sc["from"])
        r.reset(sc["sr"], sc["time"])
        if sc["kind"] == "plain":
            r.set_target(sc["to"])
            seq = [r.next_value() for _ in range(60)]
        elif sc["kind"] == "retarget":
            r.set_target(sc["to"])
            seq = [r.next_value() for _ in range(sc["retarget_at"])]
            r.set_target(sc["to2"])
            seq += [r.next_value() for _ in range(40)]
        else:
            r.set_target(sc["to"])
            seq = [r.next_value() for _ in range(12)]
            r.set_target(sc["to"])
            seq.append(r.next_value())
            r.set_target(sc["to2"])
            seq += [r.next_value() for _ in range(12)]
        np.testing.assert_array_equal(np.asarray(seq), np.asarray(sc["seq"]))


# ------------------------------------------------------------- telemetry
# The port's telemetry and the JAX package's go through the same events
# on one injected clock (each module's `time` replaced by `_Clock`), and
# everything they record is compared.

class _Clock:
    """monotonic() and perf_counter() of a clock moved by hand."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    perf_counter = monotonic


def _on_clock(monkeypatch):
    clock = _Clock()
    for mod in (j_tel, t_tel):
        monkeypatch.setattr(mod, "time", clock)
    return clock


@pytest.mark.parametrize("capacity", [4, 8, 64])
def test_recorder_stage_timer_and_drops(monkeypatch, capacity):
    """The same events through both recorders, read back through each
    package's `runtime_budget_report`.  The port's DiagEvent has no
    budget field (nothing set one) and its StageTimer adds the stage's
    stream time, which for work on the CPU is the host time."""
    clock = _on_clock(monkeypatch)

    def drive(mod, ev_mod):
        def stage(rec, cat):
            return (mod.StageTimer(rec, cat, device="cpu") if mod is t_tel
                    else mod.StageTimer(rec, cat))
        clock.t = 100.0
        rec = mod.TelemetryRecorder(capacity=capacity)
        out = []
        for k in range(20):
            clock.t += 0.001 * (k + 1)
            if k % 5 == 0:
                with stage(rec, "eq"):
                    clock.t += 0.0007 * (k + 1)
            elif k % 5 == 1:
                with stage(rec, "conv"):
                    clock.t += 0.0002
            else:
                rec.push("tick" if k % 2 else "conv",
                         duration_us=12.5 * k, block=k)
            out.append((rec.seq, rec.dropped, len(rec.events)))
            if k == 13:
                out.append([_event(e) for e in rec.drain()])
        report = ev_mod.EvidenceExporter(
            SimpleNamespace(telemetry=rec)).runtime_budget_report()
        return out, report, [_event(e) for e in rec.drain()]

    got, want = drive(t_tel, t_ev), drive(j_tel, j_ev)
    assert got[0] == want[0] and got[2] == want[2]
    report, want_report = got[1], want[1]
    assert {k: v for k, v in report.items() if k != "stages"} == \
        {k: v for k, v in want_report.items() if k != "stages"}
    stages = report["stages"]
    assert set(stages) == set(want_report["stages"]) == {"eq", "conv",
                                                         "tick"}
    for cat, st in want_report["stages"].items():
        assert {k: stages[cat][k] for k in st} == st
    timed = {"eq": 4, "conv": 4}            # the StageTimer's stages
    for cat, st in stages.items():
        if cat in timed:
            assert st["stream_count"] == timed[cat]
            assert st["stream_max_us"] == pytest.approx(
                max(1e6 * 0.0007 * (k + 1) for k in range(0, 20, 5))
                if cat == "eq" else 200.0)
        else:
            assert "stream_count" not in st
    assert report["events_seen"] == 20
    assert report["events_dropped"] == \
        max(0, 14 - capacity) + max(0, 6 - capacity)


def _event(e):
    """A DiagEvent's fields, without the JAX package's budget field."""
    d = dataclasses.asdict(e)
    d.pop("budget_permille", None)
    return d


# (seconds since the previous step, the step's duration, count_xrun)
XRUN_SEQUENCES = {
    "durations_10ms": (480, [(0.0, 0.005, True), (0.010, 0.020, True),
                             (0.010, 0.0149, True), (0.010, 0.0151, True)]),
    "gaps_and_warmup": (512, [(0.0, 1.0, True), (0.05, 0.0, False),
                              (0.001, 0.0, True), (0.017, 0.002, True),
                              (0.015, 0.002, True), (0.2, 0.5, False),
                              (0.009, 0.011, True)]),
    "bigblock_window": (8192, [(0.0, 0.3, False), (0.17, 0.1, True),
                               (0.25, 0.26, True), (0.26, 0.2, True)]),
}


@pytest.mark.parametrize("name", sorted(XRUN_SEQUENCES))
def test_xrun_detector_and_warmup_exemption(monkeypatch, name):
    clock = _on_clock(monkeypatch)
    block, events = XRUN_SEQUENCES[name]

    def drive(mod):
        clock.t = 100.0
        det = mod.XrunDetector(48000.0, block)
        out = []
        for gap, dur, count in events:
            clock.t += gap
            out.append((det.record_step(dur, count_xrun=count), det.xruns,
                        det.steps))
        return out, det.threshold_s, det.period_s

    got, want = drive(t_tel), drive(j_tel)
    assert got == want
    assert t_tel.XRUN_FACTOR == j_tel.XRUN_FACTOR
    assert any(x for x, _, _ in got[0]) and not all(x for x, _, _ in got[0])


# (seconds the clock moves, xruns, steps, failures) a tick
HEALTH_TICKS = {
    "degraded_hold": [(0, 0, 1000, 0), (1, 50, 1000, 0), (4, 0, 1000, 0),
                      (6.1, 0, 1000, 0), (1, 5, 1000, 0),
                      (9.9, 0, 1000, 0), (0.2, 0, 1000, 0)],
    "critical_hold": [(0, 200, 1000, 0), (15, 0, 1000, 0),
                      (14.5, 0, 1000, 0), (0.5, 0, 1000, 0),
                      (5, 0, 1000, 0), (10, 0, 1000, 0),
                      (0, 0, 0, 1), (31, 0, 0, 0), (30, 0, 0, 0)],
    "rates_at_the_limits": [(0, 10, 1000, 0), (1, 101, 10000, 0),
                            (40, 0, 1000, 0), (1, 11, 1000, 0),
                            (1, 100, 1000, 0), (1, 101, 1000, 0),
                            (40, 0, 1000, 0), (40, 0, 1000, 0)],
}


@pytest.mark.parametrize("name", sorted(HEALTH_TICKS))
def test_health_hysteresis_and_policy_ladder(monkeypatch, name):
    clock = _on_clock(monkeypatch)

    def drive(mod):
        clock.t = 100.0
        mon = mod.RuntimeHealthMonitor(now_fn=clock.monotonic)
        pol = mod.RuntimePolicyEngine()
        out = []
        for dt, xruns, steps, failures in HEALTH_TICKS[name]:
            clock.t += dt
            health = mon.tick(xruns, steps, failures)
            level = pol.evaluate(health)
            out.append((health.name, level.name, pol.actions))
        # the whole ladder up and down again
        for h in ("CRITICAL",) * 3 + ("DEGRADED", "HEALTHY", "HEALTHY",
                                      "DEGRADED") + ("HEALTHY",) * 6:
            clock.t += 0.5
            level = pol.evaluate(mod.Health[h])
            out.append((h, level.name, pol.actions))
        return out, list(mon.history), list(pol.history)

    got, want = drive(t_tel), drive(j_tel)
    assert got == want
    levels = [lv for _, lv, _ in got[0]]
    assert "CRITICAL" in levels and levels[-1] == "OBSERVE"
    assert len(got[1]) >= 2 and len(got[2]) >= 4


# ---------------------------------------------------------------- serve

def _jax_state_budget():
    spec = importlib.util.spec_from_file_location(
        "serving_bench", ROOT / "tools" / "serving_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._state_budget


def test_state_budget_matches_jax_tool():
    assert serve.state_budget(1_000_000) == _jax_state_budget()(1_000_000)


def _small_chains():
    fx = serve.serving_fixture(SMALL_TAPS)
    for tier in ("folded", "folded_f16", "bigblock_M16", "folded_f64",
                 "staged"):
        yield tier, serve.build_chain(tier, "cpu", fx)
    ir = np.random.default_rng(2).normal(size=(2, 3000)) * 0.1
    conv = t_conv.stereo_prepare(
        torch.from_numpy(ir), 1024, t_nuc.FilterSpec(2 * SR),
        enable_direct_head=True, device="cpu")
    cfg = t_chain.ChainConfig(sample_rate=SR, oversampling_factor=2,
                              soft_clip_enabled=True)
    eqp = fx[1]
    eqp.agc_enabled = True
    yield "os2_clip_agc_direct", StreamingChain(
        cfg, eqp, conv.left, conv.right, dtype=torch.float64, device="cpu")
    conv = t_conv.stereo_prepare(torch.from_numpy(ir), 512,
                                 t_nuc.FilterSpec(SR), device="cpu")
    yield "clip_1x", StreamingChain(
        dataclasses.replace(cfg, oversampling_factor=1), None, conv.left,
        conv.right, device="cpu")


def test_state_bytes_match_init_state():
    for tier, chain in _small_chains():
        for batch in ((1,), (3,)):
            got = chain.init_state(batch).nbytes()
            assert got == batch[0] * chain.state_bytes(), tier


def test_serve_main_prints_json_and_writes_nothing(tmp_path, capsys,
                                                   monkeypatch):
    serving = ROOT / "SERVING.json"
    before = serving.read_bytes()
    monkeypatch.chdir(tmp_path)
    serve.main(["--device", "cpu", "--ir-taps", str(SMALL_TAPS),
                "--blocks", "3", "--streams", "1", "2",
                "--tiers", "folded", "bigblock_M16_f16", "staged"])
    serve.main(["--device", "cpu", "--ir-taps", str(SMALL_TAPS),
                "--fidelity", "--seconds", "1", "--tiers", "folded",
                "folded_f16", "folded_f64", "staged"])
    serve.main(["--device", "cpu", "--ir-taps", str(SMALL_TAPS),
                "--frontier", "--windows", "2", "--streams", "1",
                "--blocks", "3"])
    serve.main(["--state-budget"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    per_block = [r for r in rows if r.get("mode") == "per_block"]
    assert [(r["tier"], r["streams"]) for r in per_block] == [
        (t, s) for t in ("folded", "bigblock_M16_f16", "staged")
        for s in (1, 2)]
    for r in per_block:
        assert r["finite"] and r["steps"] == 3 and r["median_ms"] > 0
        assert r["streams_x_realtime"] > 0
        assert r["streams_x_realtime_median"] > 0
        assert r["state_mb_per_stream"] == r["state_mb_per_stream_arith"]
    fid = {r["tier"]: r for r in rows if r.get("mode") == "fidelity"}
    assert set(fid) == {"folded", "folded_f16", "folded_f64"}
    for r in fid.values():
        assert r["finite"] and r["rel_rms"] <= r["limit"], r
    assert fid["folded_f64"]["rel_rms"] <= 1e-12
    assert any(r.get("mode") == "frontier" for r in rows)
    assert rows[-1]["mb_per_stream"]["3layer_f32"] == 21.86
    assert os.listdir(tmp_path) == []
    assert serving.read_bytes() == before


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 2e-3),
                                         (torch.float64, 1e-9)])
def test_staged_fidelity_on_cpu(dtype, limit):
    """chip_smoke's 14b at a tiny size: the staged step against the
    offline process_chain on the plain path."""
    fx = serve.serving_fixture(SMALL_TAPS)
    row, launches = serve.staged_fidelity(dtype, 1, 0.5, "cpu", fx)
    assert row["finite"] and row["rel_rms"] <= limit, row
    assert len(row["layers"]) == 2 and not any(launches.values())
