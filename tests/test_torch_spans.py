"""Spans and counters of convopeq_tpu_torch (`runtime/telemetry.py`), on
the CPU.

- With no profiler session the serving step, the folded and
  semi-folded render chains and the dither enter no `record_function`,
  make no CUDA event and add nothing to the span store.
- Under torch.profiler the serving step of a three-layer NUC (an
  immediate layer and two tail layers) opens one span tree a block:
  each layer fires on exactly the blocks where step % ratio == ratio -
  1, and each MAC span's partitions follow the plan's schedule.
- The store's records pair one to one with the exported trace's
  `user_annotation` events of the program, and each record's host
  interval lies inside its event's.
- Outputs and state are bit for bit the same with the profiler on and
  off.
- The staged chain (`process_chain`) opens one span tree a call, its
  stages in the chain's order, with the folded chains' names where the
  stage is the same; its output is bit for bit the same traced.
- The StageTimer's and the spans' stream time is the host time when
  their work is not on a CUDA device, even in a process that has
  initialized CUDA; the set-up spans, the engine's IR load among them.
- Every per-layer reader that reads the spans returns a number on a
  traced CPU run of the benchmark's small cells, and None once one
  record of the store is dropped.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.tests.conftest import SMALL
from benchmark.tests.test_app_cell import APP_SMALL
from convopeq_tpu_torch.engine.engine import ConvoPeqEngine
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import dither as t_dither
from convopeq_tpu_torch.models.convolver import stereo_prepare
from convopeq_tpu_torch.models.eq import EQParams
from convopeq_tpu_torch.models.gain_planner import CONVOLVER_THEN_EQ
from convopeq_tpu_torch.models.nuc import FilterSpec
from convopeq_tpu_torch.runtime import telemetry as tel
from convopeq_tpu_torch.runtime.streaming import StreamingChain

SR = 48000.0
BLOCK = 64
BLOCKS = 72          # more than the longest ratio (4096 / 64)
PROGRAM = ("chain", "dither", "step", "nuc")


def _ir(rng, n, decay):
    return rng.normal(size=(2, n)) * np.exp(-np.arange(n) / decay) * 0.05


@pytest.fixture(scope="module")
def serving():
    """A folded StreamingChain of three layers (64 x 32 immediate, 512 x
    64 at 2048, 4096 x 23 at 34816), 3 streams of 72 blocks, f64."""
    rng = np.random.default_rng(17)
    sc = StreamingChain.folded_from_ir(
        t_chain.ChainConfig(sample_rate=SR), None, _ir(rng, 60_000, 8000.0),
        FilterSpec(SR), block_size=BLOCK, dtype=torch.float64,
        partition=None, device="cpu")
    assert [(lp.part_size, lp.num_parts) for lp in sc.layers] == \
        [(64, 32), (512, 64), (4096, 23)]
    x = torch.from_numpy(np.clip(rng.normal(size=(3, 2, BLOCKS * BLOCK))
                                 * 0.3, -1.0, 1.0))
    return sc, x


@pytest.fixture(scope="module")
def render():
    """(FoldedChain, SemiFoldedChain, x (2, 2, N)) on a 3000-tap IR."""
    rng = np.random.default_rng(18)
    ir = _ir(rng, 3000, 600.0)
    eqp = EQParams()
    eqp.gains_db[:] = np.linspace(-3.0, 3.0, eqp.gains_db.shape[0])
    spec = FilterSpec(SR)
    cfg = t_chain.ChainConfig(sample_rate=SR)
    folded = t_chain.FoldedChain(cfg, t_chain.prepare_folded_convolver(
        ir, 512, spec, cfg, eqp, dtype=torch.float64, partition=1024,
        device="cpu"))
    scfg = t_chain.ChainConfig(sample_rate=SR, soft_clip_enabled=True,
                               saturation_amount=0.3,
                               output_makeup_gain=1.5)
    semi = t_chain.SemiFoldedChain(scfg, t_chain.prepare_semi_folded_convolver(
        ir, 512, spec, scfg, eqp, dtype=torch.float64, partition=1024,
        device="cpu"))
    x = torch.from_numpy(rng.normal(size=(2, 2, 6000)) * 0.3)
    return folded, semi, x


def _dither(y, u):
    return t_dither.apply_dither(y, t_dither.ADAPTIVE9, SR, 24, uniforms=u,
                                 adaptive_coeffs=np.full(9, 0.1))


def _run_all(serving, render, blocks=BLOCKS):
    sc, x = serving
    st = sc.init_state((x.shape[0],))
    ys = []
    for k in range(blocks):
        st, y = sc.step(st, x[..., k * BLOCK:(k + 1) * BLOCK])
        ys.append(y.clone())
    folded, semi, xr = render
    u = torch.from_numpy(np.random.default_rng(3).uniform(
        size=xr.shape + (2,)))
    yf = folded(xr)
    ys_ = semi(xr)
    return {"step": torch.cat(ys, -1), "state": st, "folded": yf,
            "semi": ys_, "dither": _dither(ys_, u)}


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _parents(recs):
    """The span each record (in opening order) nests in, from their host
    intervals; None at the top."""
    out, stack = [], []
    for r in recs:
        while stack and stack[-1].t1_ns < r.t1_ns:
            stack.pop()
        out.append(stack[-1] if stack else None)
        stack.append(r)
    return out


def test_no_session_enters_nothing(monkeypatch, serving, render):
    def refuse(*a, **k):
        raise AssertionError("a span ran with no profiler session")
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tel.SPANS, "add", refuse)
    n, dropped = len(tel.SPANS.records), tel.SPANS.dropped
    assert not torch.autograd.profiler._is_profiler_enabled
    _run_all(serving, render, blocks=4)
    assert (len(tel.SPANS.records), tel.SPANS.dropped) == (n, dropped)


def _schedule(step, layers):
    """[(p, partitions, in a fire)] of one block: the immediate layer
    sums its whole ring in its fire; a tail layer of P partitions firing
    every `ratio` blocks sums min(ppc, P - j0) partitions on slot s, j0
    = 1 + s ppc, ppc = ceil((P - 1) / ratio), and its newest partition
    in its fire."""
    out = []
    for p, P in layers:
        ratio = p // BLOCK
        if ratio == 1:
            out.append((p, P, True))
            continue
        s = step % ratio
        ppc = -(-(P - 1) // ratio)
        j0 = 1 + s * ppc
        if j0 < min(j0 + ppc, P):
            out.append((p, min(j0 + ppc, P) - j0, False))
        if s == ratio - 1:
            out.append((p, 1, True))
    return out


def test_step_span_tree_follows_the_schedule(serving):
    sc, x = serving
    st = sc.init_state((x.shape[0],))

    def run():
        nonlocal st
        for k in range(BLOCKS):
            st, _ = sc.step(st, x[..., k * BLOCK:(k + 1) * BLOCK])
    n0 = len(tel.SPANS.records)
    _traced(run)
    recs = tel.spans()[-(len(tel.SPANS.records) - n0):]
    parents = _parents(recs)
    steps = [r for r in recs if r.name == "step"]
    assert [r.counts for r in steps] == [
        {"streams": 3, "step": k} for k in range(BLOCKS)]
    layers = [(lp.part_size, lp.num_parts) for lp in sc.layers]
    fires, macs = set(), []
    step = None
    for r, parent in zip(recs, parents):
        if r.name == "step":
            step = r.counts["step"]
            assert parent is None
        elif r.name.startswith("step."):
            assert parent.name == "step"
        elif r.name.endswith(".fire"):
            assert parent.name == r.name[:-len(".fire")]
            fires.add((step, int(parent.name[len("nuc.L"):])))
        elif r.name.endswith(".mac"):
            layer = r.name[:-len(".mac")]
            assert parent.name in (layer, layer + ".fire")
            macs.append((step, int(layer[len("nuc.L"):]),
                         r.counts["partitions"], parent.name.endswith(
                             ".fire")))
            assert r.counts["bins"] == macs[-1][1] + 1
        elif r.name.startswith("nuc.L"):
            assert parent.name == "step.conv"
    assert fires == {(k, p) for k in range(BLOCKS) for p, _ in layers
                     if k % (p // BLOCK) == p // BLOCK - 1}
    assert macs == [(k,) + m for k in range(BLOCKS)
                    for m in _schedule(k, layers)]
    # a tail layer's MACs add up to P partitions over each whole frame
    for p, P in layers[1:]:
        ratio = p // BLOCK
        for f in range(BLOCKS // ratio):
            assert sum(m[2] for m in macs if m[1] == p
                       and f * ratio <= m[0] < (f + 1) * ratio) == P


def test_records_pair_with_the_trace(serving, render, tmp_path):
    n0 = len(tel.SPANS.records)
    prof, _ = _traced(lambda: _run_all(serving, render, blocks=9))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    events = sorted(
        (e for e in doc["traceEvents"] if e.get("ph") == "X"
         and e.get("cat") == "user_annotation"
         and e["name"].split(".", 1)[0] in PROGRAM),
        key=lambda e: (e["ts"], -e["dur"]))
    recs = tel.spans()[-(len(tel.SPANS.records) - n0):]
    assert len(recs) == len(events) > 9 * 10
    assert [r.name for r in recs] == [e["name"] for e in events]
    assert {"chain", "chain.soft_clip", "chain.dc_block", "dither",
            "dither.quantize"} <= {r.name for r in recs}
    for r, e in zip(recs, events):
        t0 = base + round(e["ts"] * 1e3)
        t1 = base + round((e["ts"] + e["dur"]) * 1e3)
        assert t0 <= r.t0_ns <= r.t1_ns <= t1, (r.name, t0, r.t0_ns,
                                                r.t1_ns, t1)
        assert r.stream_ms == r.host_ms          # no CUDA: synchronous


def test_bit_identical_with_tracing_on_and_off(serving, render):
    off = _run_all(serving, render)
    _, on = _traced(lambda: _run_all(serving, render))
    for k in ("step", "folded", "semi", "dither"):
        assert torch.equal(on[k], off[k]), k
    a, b = on["state"], off["state"]
    assert a.step == b.step == BLOCKS
    for ta, tb in zip(a.tensors(), b.tensors()):
        assert torch.equal(ta, tb)
    assert [ls.step for ls in a.conv_layers] == \
        [ls.step for ls in b.conv_layers]


# (config, spans in order) of the staged chain: EQ -> conv at 1x with
# every scalar gain, the soft clip and the output headroom; conv -> EQ
# oversampled 2x, no gains
STAGED = {
    "eq_conv_1x": (dict(input_headroom_gain=0.5, output_makeup_gain=2.0,
                        convolver_input_trim_gain=0.8,
                        soft_clip_enabled=True, saturation_amount=0.3),
                   ["chain", "chain.sanitize", "chain.post", "chain.dc_block",
                    "chain.eq", "chain.conv", "chain.output_filter",
                    "chain.post", "chain.soft_clip", "chain.dc_block",
                    "chain.post"]),
    "conv_eq_2x": (dict(order=CONVOLVER_THEN_EQ,
                        oversampling_factor=2, apply_output_headroom=False),
                   ["chain", "chain.sanitize", "chain.dc_block",
                    "chain.oversample", "chain.dc_block", "chain.conv",
                    "chain.eq", "chain.output_filter", "chain.oversample",
                    "chain.dc_block"]),
}


@pytest.fixture(scope="module")
def staged_parts():
    """(EQ parameters, a 2-layer stereo NUC at block 64, x (2, 2, 2048))
    of the staged chain, f64."""
    rng = np.random.default_rng(19)
    eqp = EQParams()
    eqp.gains_db[:] = np.linspace(-3.0, 3.0, eqp.gains_db.shape[0])
    conv = stereo_prepare(torch.from_numpy(_ir(rng, 3000, 600.0)), 64,
                          FilterSpec(SR), device="cpu")
    return eqp, conv, torch.from_numpy(rng.normal(size=(2, 2, 2048)) * 0.3)


def _staged(parts, case):
    eqp, conv, x = parts
    cfg = t_chain.ChainConfig(sample_rate=SR, **STAGED[case][0])
    return t_chain.process_chain(x, cfg, eqp, conv)


@pytest.mark.parametrize("case", sorted(STAGED))
def test_staged_chain_span_tree(staged_parts, case):
    n0 = len(tel.SPANS.records)
    _traced(lambda: _staged(staged_parts, case))
    recs = tel.spans()[-(len(tel.SPANS.records) - n0):]
    assert [r.name for r in recs] == STAGED[case][1]
    assert [None if p is None else p.name for p in _parents(recs)] == \
        [None] + ["chain"] * (len(recs) - 1)


@pytest.mark.parametrize("case", sorted(STAGED))
def test_staged_chain_bit_identical_traced(staged_parts, case):
    off = _staged(staged_parts, case)
    _, on = _traced(lambda: _staged(staged_parts, case))
    assert torch.equal(on, off)


def test_stage_timer_stream_time_on_the_cpu():
    """Work on the CPU: the stage's stream time is its host time, folded
    into the stats when the stage ends; nothing is left pending."""
    rec = tel.TelemetryRecorder()
    for _ in range(3):
        with tel.StageTimer(rec, "process", "cpu"):
            torch.ones(1000).cumsum(0)
    assert not rec._pending
    st = rec.stage_stats["process"]
    assert st["count"] == st["stream_count"] == 3
    assert st["stream_total_us"] == pytest.approx(st["total_us"])
    assert st["stream_max_us"] == pytest.approx(st["max_us"])


def test_cpu_work_takes_no_cuda_event(monkeypatch):
    """In a process that has initialized CUDA, a stage or a span whose
    work is on the CPU still times the host: no CUDA event is made."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA event for work on the CPU")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    rec = tel.TelemetryRecorder()
    with tel.StageTimer(rec, "process", torch.device("cpu")):
        torch.ones(100).cumsum(0)
    with tel.StageTimer(rec, "process"):
        pass
    assert rec.stage_stats["process"]["stream_count"] == 2
    n0 = len(tel.SPANS.records)
    with profile(activities=[ProfilerActivity.CPU]):
        with tel.span("test.cpu", torch.device("cpu")):
            torch.ones(100).cumsum(0)
    r = tel.spans()[n0]
    assert r.name == "test.cpu" and r.stream_ms == r.host_ms


def test_setup_spans_count_the_outermost_fold(render):
    """A semi-folded preparation runs the full fold inside it: one
    "setup.fold" call; a nested span of another name still counts."""
    before = tel.setup_seconds().get("setup.fold", {"seconds": 0.0,
                                                    "calls": 0})
    rng = np.random.default_rng(4)
    scfg = t_chain.ChainConfig(sample_rate=SR, soft_clip_enabled=True)
    t_chain.prepare_semi_folded_convolver(
        _ir(rng, 2000, 400.0), 512, FilterSpec(SR), scfg, None,
        dtype=torch.float64, partition=1024, device="cpu")
    after = tel.setup_seconds()["setup.fold"]
    assert after["calls"] == before["calls"] + 1
    assert after["seconds"] > before["seconds"]
    with tel.setup_span("test.outer"):
        with tel.setup_span("test.inner"):
            pass
        with tel.setup_span("test.outer"):
            pass
    got = tel.setup_seconds()
    assert got["test.outer"]["calls"] == 1
    assert got["test.inner"]["calls"] == 1


def test_engine_ir_load_is_a_setup_span():
    """`load_impulse_response` is one "setup.load" call, a cached load
    too; a load inside another "setup.load" adds nothing of its own."""
    def calls():
        return tel.setup_seconds().get("setup.load", {"calls": 0})["calls"]
    ir = _ir(np.random.default_rng(6), 2000, 400.0)
    eng = ConvoPeqEngine(SR, 64, torch.float64, device="cpu")
    n0 = calls()
    eng.load_impulse_response(ir)
    assert calls() == n0 + 1
    with tel.setup_span("setup.load"):
        eng.load_impulse_response(ir * 0.5)
        eng.load_impulse_response(ir)
    assert calls() == n0 + 2
    assert tel.setup_seconds()["setup.load"]["seconds"] > 0.0


@pytest.mark.parametrize("name", ["frame_conv", "error_feedback_quantize",
                                  "softclip", "iir_cascade"])
def test_library_load_is_a_setup_span(monkeypatch, name):
    """`ops/_build.load`'s first call of a library is one "setup.build"
    call; later calls add nothing (nvcc and the binding faked: no CUDA
    toolkit here)."""
    from convopeq_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda nm: (nm + ".so", ""))
    monkeypatch.setattr(_build, "bind", lambda lib, path: ("bound", path))
    before = tel.setup_seconds().get("setup.build", {"calls": 0})
    for _ in range(2):
        assert _build.load(name) == ("bound", name + ".so")
    assert tel.setup_seconds()["setup.build"]["calls"] == \
        before["calls"] + 1


# ------------------------------------------------ the benchmark's readers

CELLS = {"hall1m_48k.render": SMALL["hall1m_48k.render"],
         # a third of the small clip: the plain quantizer, a loop over
         # time, fills the CPU trace with ops
         "master384k_d24.render": (SMALL["master384k_d24.render"][0],
                                   {"batch": 1, "seconds": 0.004}),
         "hall1m_48k.live": SMALL["hall1m_48k.live"],
         "hall1m_48k.live32": (SMALL["hall1m_48k.live"][0],
                               {"streams": 2, "check_streams": 2,
                                "trace_blocks": 8}),
         "app_48k_psycho.render": APP_SMALL}
NEW = {"chain.sanitize_ms.render", "chain.conv_ms.render",
       "chain.soft_clip_ms.render", "chain.dc_block_ms.render",
       "dither.eager_ms.render", "nuc.ring_mac_ms.live",
       "nuc.ring_mac.roofline_pct.live", "nuc.fire_ms.live",
       "nuc.host_ms.live", "step.stream_ms.live", "setup.fold_s",
       "setup.build_s", "chain.eq_ms.app", "chain.output_filter_ms.app",
       "setup.load_s.app"}
# host seconds, not the store; the engine's cell loads its IR, no fold
SETUP = {"setup.fold_s", "setup.build_s", "setup.load_s.app"}


@pytest.fixture(scope="module", params=sorted(CELLS))
def traced_cell(request):
    cfg, mix = CELLS[request.param]
    ctx = {}
    r = harness.run_cell(request.param, 2 ** 31 + 11, 0.05, True, "cpu",
                         config_override=cfg, traffic_override=mix,
                         ctx_out=ctx)
    assert r["correct"], r["checks"]
    names = [m["name"] for m in harness.metrics_of(harness.load_spec(),
                                                   request.param, True)
             if m["name"] in NEW]
    return request.param, ctx, r, names


def test_new_readers_read_the_spans(traced_cell):
    cell, ctx, r, names = traced_cell
    setup = {"setup.load_s.app" if cell.startswith("app_")
             else "setup.fold_s", "setup.build_s"}
    assert setup == SETUP & set(names) and len(names) >= 3
    for name in names:
        v = harness.reader(name)(ctx)
        assert isinstance(v, float) and np.isfinite(v) and v >= 0.0, \
            (cell, name, v)
        assert r["metrics"][name]["value"] == pytest.approx(v), name
    assert 0.0 < r["metrics"].get(
        "nuc.ring_mac.roofline_pct.live", {"value": 1.0})["value"] <= 100.0


def test_new_readers_give_none_when_a_record_is_dropped(traced_cell):
    cell, ctx, _, names = traced_cell
    saved = tel.SPANS.records.copy()
    try:
        del tel.SPANS.records[-3]
        for name in sorted(set(names) - SETUP):
            assert harness.reader(name)(ctx) is None, (cell, name)
    finally:
        tel.SPANS.records.clear()
        tel.SPANS.records.extend(saved)
