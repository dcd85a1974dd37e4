"""The native plane of convopeq_tpu_torch on the CPU: `utils/native.py`
(the repo's native/convopeq_native.cpp, built by g++ into the port's
_build/ at first use), `runtime/native_serving.py` and the CLI's --serve.

- The rings (SPSC push / pop, wraparound, a producer and a consumer
  thread, the MPSC ring), the framing kernels against NumPy, and the
  block scheduler's gather / commit / pop, masks, underruns and stats.
- `read_wav` (the native parser) equal to `read_wav_numpy` (the JAX
  package's NumPy parser, copied) on every format, and both rejecting a
  file that is not RIFF/WAVE.
- `NativeServingLoop` at 3 streams x 12 blocks in f64 with producer
  threads: every window's step output (recorded inside the loop) against
  the JAX package's StreamingChain.step on the same gathered inputs at
  1e-12, and bit for bit against the port's direct step; the committed
  blocks the f32 casts of those outputs, in order, stream by stream.
- `serve.native_point` at 2 streams x 3 windows: SERVING.json's
  `native_serving` keys, and the dispatcher's host part of the wall
  beside its thread's CPU time in it.
- `cli.py --serve` on 1 s: out.wav equal to `process_streaming` of the
  same engine on the same input, bit for bit.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu.runtime import streaming as j_stream
from convopeq_tpu_torch import cli
from convopeq_tpu_torch import convert
from convopeq_tpu_torch import serve
from convopeq_tpu_torch.engine import ConvoPeqEngine
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models.gain_planner import EQ_THEN_CONVOLVER
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.runtime import native_serving
from convopeq_tpu_torch.runtime import streaming as t_stream
from convopeq_tpu_torch.utils import native, wavio

SR = 48000.0
BLOCK = 512


def test_build_lands_in_the_port_build_dir():
    """Built from the repo's native/ source into the port's _build/, never
    into native/ (the JAX package's build)."""
    path = native.library_path()
    assert native.build() == path and path.exists()
    assert path.parent == native.BUILD_DIR
    assert native.SOURCE.parent not in path.parents


def test_ring_push_pop_wraparound():
    r = native.NativeRing(8)
    assert (r.readable, r.writable) == (0, 8)
    with pytest.raises(ValueError):
        native.NativeRing(6)
    got = []
    for k in range(5):                 # 5 x 6 values through 8 slots
        v = np.arange(6, dtype=np.float64) + 10 * k
        assert r.push(v)
        assert not r.push(np.zeros(3))   # 2 free slots: all or nothing
        assert r.pop(7) is None
        got.append(r.pop(6))
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate([np.arange(6) + 10 * k
                                                  for k in range(5)]))


def test_ring_threaded_spsc():
    r = native.NativeRing(1024)
    n = 200_000
    src = np.random.default_rng(1).normal(size=n)

    def produce():
        i = 0
        while i < n:
            j = min(n, i + 333)
            if r.push(src[i:j]):
                i = j

    t = threading.Thread(target=produce)
    t.start()
    out = []
    have = 0
    while have < n:
        k = min(r.readable, n - have)
        if k:
            out.append(r.pop(k))
            have += k
    t.join(timeout=30)
    np.testing.assert_array_equal(np.concatenate(out), src)


def test_framing_and_mpsc():
    x = np.random.default_rng(2).normal(size=(3, 257)).astype(np.float32)
    inter = x.T.reshape(-1)
    np.testing.assert_array_equal(native.deinterleave(inter, 3, 0.5),
                                  x.astype(np.float64) * 0.5)
    planar = x.astype(np.float64)
    np.testing.assert_array_equal(native.interleave(planar, 2.0),
                                  np.clip(planar * 2.0, -1.0, 1.0).T
                                  .reshape(-1).astype(np.float32))
    m = native.NativeMpscRing(4, 8)
    with pytest.raises(ValueError):
        m.push(b"short")
    recs = [bytes([k] * 8) for k in range(4)]
    assert all(m.push(rec) for rec in recs)
    assert not m.push(bytes(8)) and m.size_approx == 4
    assert [m.pop() for _ in range(4)] == recs and m.pop() is None
    # many producers, one consumer
    m = native.NativeMpscRing(64, 8)

    def produce(p):
        for k in range(200):
            rec = np.array([p, k], np.int32).tobytes()
            while not m.push(rec):
                pass

    ts = [threading.Thread(target=produce, args=(p,)) for p in range(4)]
    for t in ts:
        t.start()
    seen = {p: [] for p in range(4)}
    while sum(map(len, seen.values())) < 800:
        rec = m.pop()
        if rec is not None:
            p, k = np.frombuffer(rec, np.int32)
            seen[int(p)].append(int(k))
    for t in ts:
        t.join(timeout=30)
    assert all(seen[p] == list(range(200)) for p in range(4))


def test_scheduler_gather_commit_stats():
    s = native.NativeBlockScheduler(3, 16, SR, capacity_blocks=4)
    rng = np.random.default_rng(3)
    blocks = rng.normal(size=(2, 2, 16)).astype(np.float32)
    with pytest.raises(ValueError):
        s.push(0, np.zeros((2, 8), np.float32))
    assert s.push(0, blocks[0]) and s.push(2, blocks[1])
    assert s.in_ready(0) == 1 and s.in_ready(1) == 0
    buf = np.full((3, 2, 16), 7.0, np.float32)
    batch, mask, n = s.gather(buf)
    assert batch is buf and n == 2 and mask.tolist() == [1, 0, 1]
    np.testing.assert_array_equal(buf[0], blocks[0])
    np.testing.assert_array_equal(buf[1], 0.0)     # underrun: silence
    s.commit(buf * 2, mask, int(30e6))             # 30 ms > 1.5 x 0.33 ms
    np.testing.assert_array_equal(s.pop(2), blocks[1] * 2)
    assert s.pop(1) is None and s.pop(2) is None
    assert s.gather()[2] == 0                      # nothing ready
    st = s.stats()
    assert (st["served_blocks"], st["underruns"], st["xruns"]) == (2, 1, 1)
    assert st["budget_ms"] == pytest.approx(16 / SR * 1e3)
    assert st["max_wall_ms"] == pytest.approx(30.0)
    for _ in range(4):
        assert s.push(1, blocks[0])
    assert not s.push(1, blocks[0])                # the ring is full
    assert s.stats()["in_overflows"] == 1


def test_read_wav_native_equals_numpy(tmp_path):
    x = np.random.default_rng(6).uniform(-1.0, 1.0, (3, 777))
    for bits, flt in ((32, True), (64, True), (16, False), (24, False),
                      (32, False)):
        p = tmp_path / f"t{bits}{flt}.wav"
        wavio.write_wav(p, x, 44100, bits=bits, float_format=flt)
        a, b = wavio.read_wav(p), wavio.read_wav_numpy(p)
        assert a.sample_rate == b.sample_rate == 44100
        assert a.samples.dtype == np.float64
        np.testing.assert_array_equal(a.samples, b.samples)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX0000WAVE")
    for read in (wavio.read_wav, wavio.read_wav_numpy):
        with pytest.raises(ValueError):
            read(bad)


def _jax_params():
    p = j_eq.EQParams()
    p.enabled[:] = False
    p.set_band(0, band_type=1, freq=200.0, gain_db=5.0, q=1.0,
               enabled=True)
    p.set_band(1, band_type=2, freq=9000.0, gain_db=2.0, q=0.7,
               enabled=True)
    return p


@pytest.fixture(scope="module")
def served():
    """3 streams x 12 blocks through NativeServingLoop over a folded f64
    chain, pushed by a producer thread a stream; the step's inputs and
    outputs recorded inside the loop, the blocks popped a stream."""
    rng = np.random.default_rng(11)
    ir = rng.normal(size=(2, 6000)) * np.exp(-np.arange(6000) / 1500.0) * 0.2
    jp = _jax_params()
    tp = convert.eq_params_from_arrays(
        jp.band_types, jp.freqs, jp.gains_db, jp.qs, jp.modes, jp.enabled,
        jp.structure, jp.saturation, jp.agc_enabled)
    kw = dict(sample_rate=SR, input_headroom_gain=0.9)
    ts = t_stream.StreamingChain.folded_from_ir(
        t_chain.ChainConfig(**kw), tp, ir, t_nuc.FilterSpec(SR),
        block_size=BLOCK, dtype=torch.float64, device="cpu")
    js = j_stream.StreamingChain.folded_from_ir(
        j_chain.ChainConfig(**kw), jp, jnp.asarray(ir),
        j_nuc.FilterSpec(sample_rate=SR), block_size=BLOCK,
        dtype=jnp.float64)
    n_streams, n_blocks = 3, 12
    x = (rng.normal(size=(n_streams, n_blocks, 2, BLOCK)) * 0.3) \
        .astype(np.float32)
    loop = native_serving.NativeServingLoop(ts, n_streams)
    rec = []
    step = ts.step

    def recording_step(state, block):
        state, y = step(state, block)
        rec.append((block.clone(), y.clone()))
        return state, y

    ts.step = recording_step

    def produce(i):
        for k in range(n_blocks):
            while not loop.push(i, x[i, k]):
                pass

    threads = [threading.Thread(target=produce, args=(i,))
               for i in range(n_streams)]
    for t in threads:
        t.start()
    popped = {i: [] for i in range(n_streams)}
    while sum(map(len, popped.values())) < n_streams * n_blocks:
        loop.serve_window()
        for i in range(n_streams):
            b = loop.pop(i)
            while b is not None:
                popped[i].append(b)
                b = loop.pop(i)
    for t in threads:
        t.join(timeout=30)
    del ts.step
    return ts, js, x, rec, popped, loop


def test_serving_loop_equals_direct_step_and_jax(served):
    ts, js, x, rec, popped, loop = served
    st = loop.stats()
    assert st["served_blocks"] == x.shape[0] * x.shape[1]
    assert st["out_drops"] == 0 and st["in_overflows"] == 0
    # the recorded windows replayed through the port's direct step (bit for
    # bit) and the JAX step (1e-12 of the output's peak)
    state = ts.init_state((x.shape[0],))
    jstate = js.init_state((x.shape[0],))
    worst = 0.0
    for xin, y in rec:
        state, yd = ts.step(state, xin)
        assert torch.equal(yd, y)
        jstate, yj = js.step(jstate, jnp.asarray(xin.numpy()))
        worst = max(worst, float(np.abs(np.asarray(yj) - y.numpy()).max()))
    peak = max(float(y.abs().max()) for _, y in rec)
    assert worst <= 1e-12 * peak, worst / peak
    # each stream's committed blocks: its own inputs, in order, and the
    # f32 casts of the step's outputs at the windows it was ready in
    for i in range(x.shape[0]):
        ready = [(xin[i], y[i]) for xin, y in rec
                 if xin[i].abs().max() > 0]
        assert len(ready) == len(popped[i]) == x.shape[1]
        for k, ((xin, y), out) in enumerate(zip(ready, popped[i])):
            np.testing.assert_array_equal(xin.numpy(),
                                          x[i, k].astype(np.float64))
            np.testing.assert_array_equal(out, y.numpy().astype(np.float32))


def test_native_point_reports_serving_json_keys(served):
    ts = served[0]
    row = serve.native_point(ts, 2, windows=3, threads=2, tier="folded",
                             timeout_s=60.0)
    for key in ("served_blocks", "underruns", "xruns", "in_overflows",
                "out_drops", "avg_wall_ms", "max_wall_ms", "budget_ms",
                "streams", "window_blocks", "windows_requested",
                "window_budget_ms", "tier", "total_wall_s",
                "streams_x_realtime", "plane"):
        assert key in row, key
    assert row["windows_served"] >= 3 and row["served_blocks"] >= 3
    # one thread's CPU time within its own wall (clock granularity aside)
    assert 0 < row["host_cpu_ms_per_window"] \
        <= row["host_ms_per_window"] * 1.05 + 0.01


def test_cli_serve_equals_process_streaming(tmp_path, capsys):
    rng = np.random.default_rng(12)
    n = int(SR)
    x = rng.normal(size=(2, n)) * 0.2
    inp, out = tmp_path / "in.wav", tmp_path / "out.wav"
    wavio.write_wav(inp, x, int(SR))
    eq = ["0:peaking:1000:+4:1.4", "1:highshelf:8000:-3:0.7"]
    assert cli.main([str(inp), str(out), "--serve", "--device", "cpu",
                     *sum((["--eq", e] for e in eq), [])]) == 0
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("serving:")]
    assert line and f"{-(-n // BLOCK)} blocks of {BLOCK}" in line[0]
    # the engine the CLI builds for these flags
    eng = ConvoPeqEngine(SR, BLOCK, device="cpu")
    eng.set_bypass(conv=True)
    eng.eq_params.enabled[:] = False
    for spec in eq:
        i, t, f, g, q, m = cli.parse_eq_band(spec)
        eng.set_eq_band(i, band_type=t, freq=f, gain_db=g, q=q, mode=m,
                        enabled=True)
    eng.set_processing_order(EQ_THEN_CONVOLVER)
    eng.set_oversampling(1)
    eng.set_wet_dry_mix(1.0)
    eng.set_auto_gain(False)
    xin = wavio.read_wav(inp).samples.astype(np.float32)
    xin = np.pad(xin, [(0, 0), (0, (-n) % BLOCK)])
    y, _ = eng.process_streaming(torch.from_numpy(xin)[None])
    want = y[0, :, :n].numpy().astype(np.float32)
    np.testing.assert_array_equal(wavio.read_wav(out).samples,
                                  want.astype(np.float64))
