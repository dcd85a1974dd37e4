"""The application's own offline path, app_48k_psycho.render, at a size a
test run holds on the CPU: the cell through the harness, the same run in
a fresh interpreter that loads neither JAX nor the JAX package, the
staged reference's parts against their textbook forms, the plain
loader on hand cases, and the staged roofline counts."""
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness
from benchmark import roofline as rl
from benchmark import roofline_staged as rs
from benchmark.reference import coeffs as C

# block 64, so that a 40,000-tap IR gives the NUC all three layers; the
# plain quantizer is a loop over time, so the clip is short
APP_SMALL = (
    {"ir": {"taps": 40000, "decay_divisor": 10.0, "scale": 0.02},
     "block_size": 64},
    {"batch": 1, "seconds": 0.02})


def test_app_cell_runs_from_its_files():
    """The engine's cell, its configuration, system, reference and
    metrics all new files, runs through the harness at a tiny size and
    is correct; untraced it reports the end-to-end metrics."""
    cfg, mix = APP_SMALL
    r = harness.run_cell("app_48k_psycho.render", 2 ** 31 + 23, 0.05, False,
                         "cpu", config_override=cfg, traffic_override=mix)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"rel_rms", "q_mismatch"}
    assert set(r["metrics"]) == {"rtf", "peak_gib", "setup_s"}


def test_app_run_loads_no_jax():
    """Import every module a run imports, run the tiny app cell traced in
    a fresh interpreter, check it correct; then look at sys.modules."""
    cfg, mix = APP_SMALL
    code = (
        "import sys, json\n"
        "from benchmark import harness, control, knee, run\n"
        "r = harness.run_cell('app_48k_psycho.render', 5, 0.05, True,\n"
        f"    'cpu', config_override={cfg!r}, traffic_override={mix!r})\n"
        "assert r['correct'], r['checks']\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_staged_reference_parts_are_their_textbook_forms():
    """The staged reference's overlap-save with unfiltered partitions is
    the linear convolution; its output filter by response is the
    biquads' recurrence (scipy's lfilter), both in f64."""
    from scipy.signal import lfilter
    from benchmark.reference import staged as S
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5000))
    h = rng.normal(size=700)
    p = 128
    P = -(-h.size // p)
    parts = np.zeros((P, 2 * p))
    parts[:, :p] = np.pad(h, (0, P * p - h.size)).reshape(P, p)
    y = S.overlap_save(torch.from_numpy(x),
                       torch.from_numpy(np.fft.rfft(parts, axis=-1)), p)
    want = np.stack([np.convolve(r, h)[:x.shape[-1]] for r in x])
    assert np.abs(y.numpy() - want).max() < 1e-12
    sr = 48000.0
    want = x
    for b0, b1, b2, a1, a2 in C.output_filter_stages(
            sr, True, C.HC_NATURAL, C.LC_NATURAL, C.HC_NATURAL):
        want = lfilter([b0, b1, b2], [1.0, a1, a2], want, axis=-1)
    got = S.through(torch.from_numpy(x), *S.output_filter_response(
        x.shape[-1], sr, {})).numpy()
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_loader_copies_on_hand_cases():
    """The plain loader's trim fades the last 2% (at least 256 samples)
    linearly; a unit impulse is scaled by its -6 dB energy margin, then
    down to the 0.5 peak ceiling; the plan with a flat EQ trims the IR's
    peak over 1 dB and makes it up."""
    from benchmark.reference import loader as L
    ir = np.ones((2, 1000))
    t = L.trim(ir, 48000.0, 600)
    assert t.shape == (2, 600)
    assert np.array_equal(t[:, :344], np.ones((2, 344)))
    assert np.allclose(t[0, 344:], 1.0 - np.arange(256) / 256, rtol=0,
                       atol=1e-15)
    assert np.array_equal(L.trim(ir, 48000.0, 1200)[:, 1000:],
                          np.zeros((2, 200)))
    d = np.zeros((1, 4096))
    d[0, 0] = 1.0
    assert L.ENERGY_MARGIN > 0.5 and L.ir_scale(d) == 0.5
    assert abs(L.max_frequency_gain(d) - 1.0) < 1e-12
    flat = C.eq_params(np.zeros(C.NUM_BANDS))
    g_in, g_mk, g_trim = L.auto_gain_eq_conv(flat, 48000.0, 3.0)
    assert g_in == 1.0
    assert np.isclose(g_trim, 10 ** (-2.0 / 20)) and \
        np.isclose(g_mk, 10 ** (2.0 / 20))


def test_staged_counts_and_the_fused_passes():
    """The fused convolution's bound at app_48k_psycho's EQ (C 128, K
    1,407, p 2048, P 4): 0.881 ms by bytes, as PERF.md's row 4 gives it;
    a trace's forward pass just before `fused_packed_rows` and the
    inverse pass just after it count as the fused convolution's, every
    other pass as the frame kernels'."""
    ms, what = rl.bound(*rs.fused_conv(128, 1407, 2048, 4))
    assert (round(ms, 3), what) == (0.881, "bytes")
    fwd1 = "void fwd_packed_pass1<float2, false>(float const*)"
    dev = [(fwd1, 0.0, 1.0), ("void fwd_packed_pass2<float2>()", 2.0, 2.0),
           ("causal_mac_kernel<float2>", 5.0, 4.0),
           (fwd1, 10.0, 8.0), ("fused_packed_rows", 20.0, 16.0),
           ("void inv_packed_pass2<float2, true>()", 40.0, 32.0),
           ("void inv_packed_pass2<float2, false>()", 80.0, 64.0),
           ("aten::add", 150.0, 128.0)]
    fused, frame, n = rs.split_fused(SimpleNamespace(device=dev))
    assert (fused * 1e6, frame * 1e6, n) == (56.0, 71.0, 1)


def test_a_delayed_layer_counts_the_frames_it_needs():
    """A layer delayed by its offset needs ceil((N - offset) / p) frames:
    app_48k_psycho's 32768 layer at offset 267,904 of N 2,880,000 needs
    80 of the 88 frames the program computes; the MAC's least time sums
    its layers."""
    assert rs.layer_frames(2880000, 32768, 267904) == 80
    assert rs.layer_frames(2880000, 512, 0) == 5625
    assert rs.layer_frames(100, 64, 200) == 0
    layers = [(512, 12, 0), (4096, 64, 5760), (32768, 23, 267904)]
    want = sum(rl.least_s(*rl.causal_mac(64, rs.layer_frames(2880000, p, o),
                                         p, P)) for p, P, o in layers)
    assert rs.nuc_mac_least_s(64, 2880000, layers) == want
