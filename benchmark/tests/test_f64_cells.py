"""The f64 cells (hall1m_48k_f64.render and .live) at a size a test run
holds, on the CPU:

- both run from their files (configuration, traffic, BENCHMARK.json) and
  come out correct under the configuration's limits;
- the step below the stated precision fails those limits: the same
  small cell run in f32, and the live cell with an f32 delay line (its
  spectra rounded to complex64 where they are written, widened in the
  MAC as the f16 tier widens its own);
- `frame_kernels.roofline_pct.live_f64`, on hand-made contexts, counts
  one overlap-save frame of 2p samples a fire, accepts either f64
  forward's launches, and reads None on launches that do not follow the
  schedule;
- `step.state_mib.live` is the chain's `state_bytes()` / 2^20 on a
  traced run, in f64 and in f32.
"""
import math

import pytest
import torch

from benchmark import harness, system
from benchmark import trace as tr
from benchmark.systems import folded
from convopeq_tpu_torch.runtime import streaming

SEED = 2 ** 31 + 23
IR = {"taps": 20000, "decay_divisor": 10.0, "scale": 0.02}
SIZES = {
    "hall1m_48k_f64.render": ({"ir": IR, "render": {"fold": "folded",
                                                    "partition": 4096}},
                              {"batch": 2, "seconds": 0.5}),
    "hall1m_48k_f64.live": ({"ir": IR}, {"streams": 4, "check_streams": 2,
                                         "trace_blocks": 8}),
}
F32 = {"hall1m_48k_f64.render": {"dtype": "float32",
                                 "render": {"fold": "folded",
                                            "partition": 4096}},
       "hall1m_48k_f64.live": {"dtype": "float32"}}


def _run(workload, trace=False, cfg=None, ctx=None):
    base, mix = SIZES[workload]
    return harness.run_cell(workload, SEED, 0.05, trace, "cpu",
                            config_override={**base, **(cfg or {})},
                            traffic_override=mix, ctx_out=ctx)


def _limit(workload):
    _, cfg, mix = harness.cell_data(workload)
    return cfg["limits"][mix["kind"]]["rel_rms"]


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_f64_cell_is_correct(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["checks"]["rel_rms"]["limit"] == _limit(workload)


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_f32_fails_the_f64_limits(workload):
    r = _run(workload, cfg=F32[workload])
    assert not r["correct"]
    assert r["checks"]["rel_rms"]["value"] > 100 * _limit(workload)


def test_f32_delay_line_fails_the_f64_limit(monkeypatch):
    write = streaming._fdl_write

    def f32_fdl(fdl, X, slot):
        write(fdl, X.to(torch.complex64).to(X.dtype), slot)
    monkeypatch.setattr(streaming, "_fdl_write", f32_fdl)
    r = _run("hall1m_48k_f64.live")
    assert not r["correct"]
    assert r["checks"]["rel_rms"]["value"] > 100 * _limit(
        "hall1m_48k_f64.live")


# ------------------------------------- frame_kernels.roofline_pct.live_f64

LAYERS = [(512, 12, 1), (4096, 64, 8), (32768, 25, 64)]
C = 2 * 640


def _live_ctx(launches, first=60, steps=8, item=8, kernel_us=1000.0):
    fwd = "void fwd_packed_pass1<double2, true>(...)"
    inv = "void inv_packed_pass2<double2>(...)"
    dev = [(fwd, 0.0, kernel_us), (inv, 2000.0, kernel_us),
           ("at::native::elementwise_kernel", 4000.0, 5000.0)]
    return {"kind": "live", "item": item, "trace": tr.Trace(
        dev, [], (0.0, 1e5)), "live": {"C": C, "layers": LAYERS},
        "first_step": first, "traced_steps": steps, "launches": launches}


def _fires(first, steps):
    """(p of each fire) in steps [first, first + steps)."""
    return [p for g in range(first, first + steps)
            for p, _, ratio in LAYERS if g % ratio == ratio - 1]


def _by_hand(ps, kernel_us=1000.0):
    """100 x least time / device time: one 2p-sample frame in, p+1 f64
    bins out, a forward; p+1 bins in, p samples out, an inverse."""
    least = 0.0
    for p in ps:
        ops = C * (2.5 * p * math.log2(p) + 10 * p)
        fwd = C * (2 * p * 8 + (p + 1) * 16)
        inv = C * ((p + 1) * 16 + p * 8)
        least += max(fwd / 3.35e12, ops / 34e12) + max(inv / 3.35e12,
                                                       ops / 34e12)
    return 100.0 * least / (2 * kernel_us / 1e6)


@pytest.mark.parametrize("forward", ["frames_rfft_f64", "osa_rfft_f64"])
def test_live_f64_roofline_counts_one_2p_frame_a_fire(forward):
    read = harness.reader("frame_kernels.roofline_pct.live_f64")
    ps = _fires(60, 8)
    assert sorted(ps) == [512] * 8 + [4096, 32768]
    got = read(_live_ctx({forward: len(ps), "irfft_valid_f64": len(ps)}))
    assert got == pytest.approx(_by_hand(ps), rel=1e-12)
    # the stacked pair's two frames would have read more work
    old = harness.reader("frame_kernels.roofline_pct.live")
    assert old(_live_ctx({"frames_rfft_f64": len(ps),
                          "irfft_valid_f64": len(ps)})) > got


@pytest.mark.parametrize("launches", [
    {"frames_rfft_f64": 9, "irfft_valid_f64": 10},
    {"frames_rfft_f64": 10, "irfft_valid_f64": 11},
    {"frames_rfft_f64": 5, "osa_rfft_f64": 6, "irfft_valid_f64": 10},
    {"osa_rfft": 10, "irfft_valid": 10},
    {},
])
def test_live_f64_roofline_none_off_the_schedule(launches):
    read = harness.reader("frame_kernels.roofline_pct.live_f64")
    assert read(_live_ctx(launches)) is None


def test_live_f64_roofline_none_without_f64_or_trace():
    read = harness.reader("frame_kernels.roofline_pct.live_f64")
    good = {"frames_rfft_f64": 5, "osa_rfft_f64": 5,
            "irfft_valid_f64": 10}
    assert read(_live_ctx(good)) is not None
    assert read(_live_ctx(good, item=4)) is None
    assert read({**_live_ctx(good), "trace": None}) is None
    assert read(_live_ctx(good, kernel_us=0.0)) is None


# ------------------------------------------------------ step.state_mib.live

@pytest.mark.parametrize("workload, dtype", [
    ("hall1m_48k_f64.live", torch.float64),
    ("hall1m_48k.live", torch.float32)])
def test_state_mib_is_state_bytes_a_stream(workload, dtype):
    ctx = {}
    r = harness.run_cell(workload, SEED, 0.05, True, "cpu",
                         config_override={"ir": IR},
                         traffic_override=SIZES["hall1m_48k_f64.live"][1],
                         ctx_out=ctx)
    _, cfg, _ = harness.cell_data(workload)
    cfg["ir"] = IR
    chain = folded.Live(cfg, system.ir_from_seed(cfg, SEED), "cpu").chain
    assert chain.dtype == chain.fdl_dtype == dtype
    want = chain.state_bytes() / 2 ** 20
    assert harness.reader("step.state_mib.live")(ctx) == want
    assert r["metrics"]["step.state_mib.live"]["value"] == want
