"""The streaming runtime of convopeq_tpu_torch (`runtime/streaming.py`:
`StreamingChain`, its per-block step and layers, the folded and bigblock
builds, the f16 FDL tier; `convert.stream_state_from_arrays`) against
convopeq_tpu's `runtime/streaming.py` on the CPU in f64: the same numpy
inputs through both packages' streaming chains, relative RMS over the
whole output.

Tolerances.  Chains whose step runs no ill-conditioned scan (the folded
and bigblock chains: sanitize, gains and the NUC layers) are held at
F64_TOL = 1e-12.  A staged chain runs the output filter every block,
whose 15-20 Hz high-passes take the f64 2x2 route, which carries ~6e-11
of rounding against the exact recurrence in either package
(tests/test_torch_scan_eq.py::test_output_filter_near_dc_2x2_f64); the
JAX step runs it under jax.jit, whose fusion rounds that route
differently again (1.1-1.9e-11 from the port measured on these cases
with both packages' matmul affine scans), and the JAX package holds its
own streaming chain to its offline chain at 1e-9 (tests/
test_streaming.py).  Staged chains are held at F64_STAGED_TOL = 1e-10.
At 2x oversampling the same high-pass runs at 96 kHz, closer to its
pole: there the JAX step sits 1.0e-8 from the JAX package's own offline
chain and the port's 2.1e-10 from it (the two offline chains agree at
4e-12), so the port is held to the JAX step at the JAX package's bound
for that case, 1e-7 (test_streaming_oversampled_matches_offline), and
to its own offline chain, which tests/test_torch_oversampled_chain.py
holds to the JAX package, at 1e-9.  The JAX package's affine scans are
pinned to their matmul form, the form the port has: its "auto" rule
takes a VPU scan form under 4096 samples, which the port does not port,
and which compiles ~3x slower on the CPU.

The tail-layer case (a 2-layer plan on a 40k-tap IR) is held against
the port's own offline `nuc_convolve`, which tests/test_torch_chain.py
holds to the JAX package at 1e-12: the JAX streaming chain at that size
compiles for minutes (its own test of it is slow-marked).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import convolver as j_conv
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu.ops import scan_iir as j_scan
from convopeq_tpu.runtime import streaming as j_stream
from convopeq_tpu_torch import convert
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import convolver as t_conv
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.runtime import streaming as t_stream
from convopeq_tpu_torch.utils.dsputil import equal_power_sin

SR = 48000.0
F64_TOL = 1e-12
F64_STAGED_TOL = 1e-10
F64_OS_TOL = 1e-7
BLOCK = 512


@pytest.fixture(autouse=True)
def _jax_matmul_scans(monkeypatch):
    monkeypatch.setattr(j_scan, "AFFINE_BACKEND", "matmul")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _params(n_bands=4):
    """tests/test_streaming.py's bands: peaking, low shelf, a mid-mode
    peak and a high shelf."""
    p = j_eq.EQParams()
    p.enabled[:] = False
    specs = [(1, 200.0, 5.0, 1.0, 0), (0, 80.0, -3.0, 0.7, 0),
             (1, 2000.0, 4.0, 2.0, j_eq.MID), (2, 9000.0, 2.0, 0.7, 0)]
    for i, (t, f, g, q, m) in enumerate(specs[:n_bands]):
        p.set_band(i, band_type=t, freq=f, gain_db=g, q=q, mode=m,
                   enabled=True)
    return p


def _port_params(p):
    if p is None:
        return None
    return convert.eq_params_from_arrays(
        p.band_types, p.freqs, p.gains_db, p.qs, p.modes, p.enabled,
        p.structure, p.saturation, p.agc_enabled)


def _decaying(rng, shape, n, tau, scale=1.0):
    return rng.normal(size=shape + (n,)) * np.exp(-np.arange(n) / tau) \
        * scale


def _bypass(sr):
    return (j_nuc.FilterSpec(sample_rate=sr, tail_mode=j_nuc.TAIL_BYPASS),
            t_nuc.FilterSpec(sr, tail_mode=t_nuc.TAIL_BYPASS))


def _case(name):
    """(JAX chain, port chain, input (..., 2, N) numpy, tolerance)."""
    rng = np.random.default_rng(17)
    if name in ("folded", "bigblock"):
        ir = _decaying(rng, (2,), 20_000, 4000.0, 0.2)
        eqp = _params(2)
        kw = dict(sample_rate=SR, input_headroom_gain=0.9,
                  output_makeup_gain=1.1, convolver_input_trim_gain=0.95)
        part = None if name == "folded" else 8 * BLOCK
        js = j_stream.StreamingChain.folded_from_ir(
            j_chain.ChainConfig(**kw), eqp, jnp.asarray(ir),
            j_nuc.FilterSpec(sample_rate=SR), block_size=BLOCK,
            dtype=jnp.float64, partition=part)
        ts = t_stream.StreamingChain.folded_from_ir(
            t_chain.ChainConfig(**kw), _port_params(eqp), ir,
            t_nuc.FilterSpec(SR), block_size=BLOCK, dtype=torch.float64,
            partition=part, device="cpu")
        x = rng.normal(size=(2, 16 * (part or 2 * BLOCK))) * 0.3
        return js, ts, x, F64_TOL
    os_f, n, batch, direct = 1, 4096, (), False
    kw = dict(sample_rate=SR, eq_method="scan")
    eqp = _params()
    if name == "l0_only":
        ir = _decaying(rng, (2,), 3000, 500.0)
    elif name == "direct_head":
        ir = rng.normal(size=(2, 2000))
        eqp, direct, n = None, True, 2048
        kw.update(eq_bypassed=True, apply_output_headroom=False)
    elif name == "batch3":
        ir = rng.normal(size=(2, 2500)) * 0.3
        eqp, batch, n = _params(2), (3,), 2048
        kw.update(soft_clip_enabled=True, saturation_amount=0.3)
    elif name == "os2_clip":
        os_f = 2
        ir = _decaying(rng, (2,), 1500 * os_f, 300.0 * os_f)
        eqp = _params(3)
        kw.update(oversampling_factor=2, soft_clip_enabled=True,
                  saturation_amount=0.3)
    elif name == "agc":
        ir = _decaying(rng, (2,), 2000, 400.0)
        eqp = _params(3)
        eqp.agc_enabled = True
        kw.update(agc_block_size=BLOCK)
    else:
        raise ValueError(name)
    jspec, tspec = _bypass(SR * os_f)
    jc = j_conv.stereo_prepare(jnp.asarray(ir), BLOCK * os_f, jspec,
                               enable_direct_head=direct,
                               apply_spectrum_filter=False)
    tc = t_conv.stereo_prepare(torch.from_numpy(ir), BLOCK * os_f, tspec,
                               enable_direct_head=direct,
                               apply_spectrum_filter=False, device="cpu")
    js = j_stream.StreamingChain(j_chain.ChainConfig(**kw), eqp, jc.left,
                                 jc.right, dtype=jnp.float64)
    ts = t_stream.StreamingChain(t_chain.ChainConfig(**kw),
                                 _port_params(eqp), tc.left, tc.right,
                                 dtype=torch.float64, device="cpu")
    x = rng.normal(size=batch + (2, n)) * 0.3
    x[..., 0, 100] = np.nan                   # sanitize: NaN -> 0
    x[..., 1, 7] = 3.0                        # clamp
    return js, ts, x, F64_OS_TOL if os_f > 1 else F64_STAGED_TOL


_CASES = {}


def _get(name):
    if name not in _CASES:
        _CASES[name] = _case(name)
    return _CASES[name]


@pytest.mark.parametrize("name", ["l0_only", "direct_head", "batch3",
                                  "os2_clip", "agc", "folded", "bigblock"])
def test_streaming_matches_jax(name):
    js, ts, x, tol = _get(name)
    assert ts.block_size == js.block_size and ts.os_factor == js.os_factor
    yj, _ = js.process(jnp.asarray(x))
    yt, st = ts.process(torch.from_numpy(x))
    assert yt.shape == x.shape and bool(torch.isfinite(yt).all())
    assert _rel(yt, yj) <= tol, _rel(yt, yj)
    if name == "agc":
        assert st.agc is not None and st.agc.shape[-1] == 3
    if name == "os2_clip":
        off = t_chain.process_chain(
            torch.from_numpy(x), ts.cfg, ts.eq_params,
            t_conv.StereoConvolverState(left=ts.left, right=ts.right))
        assert _rel(yt, off) <= 1e-9, _rel(yt, off)
    if name == "bigblock":
        assert ts.block_size == 8 * BLOCK      # one step a window
        assert len(ts.left.plan.layers) == 1
    if name == "folded":
        assert len(ts.left.plan.layers) >= 2   # the tail layers stream


def _jax_state_arrays(st):
    """A JAX StreamState as `convert.stream_state_from_arrays` takes it."""
    opt = lambda v: None if v is None else np.asarray(v)

    def layer(ls):
        return {"prev": np.asarray(ls.prev),
                "fdl": np.asarray(ls.fdl_r) + 1j * np.asarray(ls.fdl_i),
                "acc": np.asarray(ls.acc), "ring": np.asarray(ls.ring),
                "par": np.asarray(ls.par_r) + 1j * np.asarray(ls.par_i),
                "step": int(ls.step)}
    return {"dc_in": np.asarray(st.dc_in), "dc_out": np.asarray(st.dc_out),
            "eq_states": np.asarray(st.eq_states),
            "of_states": np.asarray(st.of_states),
            "conv_layers": tuple(tuple(layer(ls) for ls in side)
                                 for side in st.conv_layers),
            "direct_hist": (None if st.direct_hist is None else
                            tuple(np.asarray(h) for h in st.direct_hist)),
            "sc_up_hist": opt(st.sc_up_hist),
            "sc_down_hist": opt(st.sc_down_hist),
            "os_up_hists": tuple(np.asarray(h) for h in st.os_up_hists),
            "os_down_hists": tuple(np.asarray(h) for h in st.os_down_hists),
            "dc_os": opt(st.dc_os), "agc": opt(st.agc), "step": int(st.step)}


@pytest.mark.parametrize("name,split", [("folded", 8), ("folded", 12),
                                        ("agc", 4)])
def test_state_carried_from_jax(name, split):
    """A stream the JAX package advanced `split` blocks continues in the
    port: both go on `split` more blocks from the converted state.  The
    folded chain at 12 blocks carries a partial tail MAC, at 8 a frame
    just fired (L1 fires every 8 blocks)."""
    js, ts, x, tol = _get(name)
    bs = js.block_size
    xj = jnp.asarray(x)
    jst = js.init_state(tuple(x.shape[:-2]))
    for k in range(split):
        jst, _ = js.step(jst, xj[..., k * bs:(k + 1) * bs])
    tst = convert.stream_state_from_arrays(ts, _jax_state_arrays(jst))
    assert tst.step == split
    xs = x[..., split * bs:2 * split * bs]
    yj, _ = js.process(jnp.asarray(xs), jst)
    yt, _ = ts.process(torch.from_numpy(xs), tst)
    assert _rel(yt, yj) <= tol, _rel(yt, yj)


def test_multi_step_equals_single_steps():
    """multi_step over 8 blocks: the outputs and every tensor of the
    carried state equal 8 single steps bit for bit."""
    _, ts, x, _ = _get("agc")
    xt = torch.from_numpy(x[..., :8 * BLOCK])
    st1 = ts.init_state(())
    outs = []
    for k in range(8):
        st1, y = ts.step(st1, xt[..., k * BLOCK:(k + 1) * BLOCK])
        outs.append(y)
    st2, ym = ts.multi_step(ts.init_state(()), xt)
    assert torch.equal(ym, torch.cat(outs, dim=-1))
    assert st1.step == st2.step == 8
    for a, b in zip(st1.tensors(), st2.tensors()):
        assert torch.equal(a, b)


def test_clone_keeps_an_old_state():
    """The step mutates its state; a clone taken before it continues the
    stream as the original would have."""
    _, ts, x, _ = _get("folded")
    xt = torch.from_numpy(x)
    st = ts.init_state(())
    _, st = ts.process(xt[..., :10 * BLOCK], st)
    saved = st.clone()
    _, y1 = ts.multi_step(st, xt[..., 10 * BLOCK:20 * BLOCK])
    _, y2 = ts.multi_step(saved, xt[..., 10 * BLOCK:20 * BLOCK])
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [100, 512, 1000])
def test_scan_operands_kept_by_key(dtype, n):
    """affine_scan_2x2 with a key (the streaming step's scans: its A made
    from host coefficients) keeps the operands that depend only on A and
    returns, on the first call and on later ones, bit for bit what the
    scan makes without a key."""
    from convopeq_tpu_torch.ops import scan_iir as t_scan
    rng = np.random.default_rng(n)
    A = torch.tensor([[0.999, 0.01], [-0.02, 0.97]], dtype=dtype)
    key = ("test", n)
    for k in range(3):
        bu = torch.from_numpy(rng.normal(size=(2, 2, n, 2))).to(dtype)
        s0 = torch.from_numpy(rng.normal(size=(2, 2, 2))).to(dtype)
        want = t_scan.affine_scan_2x2(A, bu, s0)
        got = t_scan.affine_scan_2x2(A, bu, s0, key=key)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        chunk = min(t_scan.MATMUL_CHUNK, n)
        kept = t_scan._SCAN_OPERANDS[(key, chunk, -(-n // chunk), dtype,
                                      torch.device("cpu"))]
        assert k == 0 or kept is first
        first = kept


@pytest.fixture(scope="module")
def tail_nuc():
    """A 40k-tap IR as the 2-layer NUC (512 x 12, 4096 x 9 at offset
    5760, contour gain 1.4375), no spectrum filter."""
    rng = np.random.default_rng(5)
    ir = _decaying(rng, (), 40_000, 8000.0)
    st = t_nuc.nuc_prepare(torch.from_numpy(ir), BLOCK, t_nuc.FilterSpec(SR),
                           apply_spectrum_filter=False, device="cpu")
    x = np.clip(rng.normal(size=(2, 24 * 4096)) * 0.3, -1.0, 1.0)
    return st, torch.from_numpy(x)


def test_tail_layers_match_offline_nuc(tail_nuc):
    """The layer machinery alone (the NUC through a folded chain: no DC
    blockers, EQ or output filter): the amortized tail MAC, the fire
    path and the output ring against the offline `nuc_convolve`, over
    the whole output, warm-up included."""
    st, x = tail_nuc
    assert len(st.plan.layers) >= 2
    assert any(lp.num_parts > 1 and lp.part_size > BLOCK
               for lp in st.plan.layers)
    cfg = t_chain.ChainConfig(sample_rate=SR, apply_output_headroom=False)
    sc = t_stream.StreamingChain(cfg, None, st, st, dtype=torch.float64,
                                 folded=True, device="cpu")
    y, state = sc.process(x)
    ref = t_nuc.nuc_convolve(x, st) * float(equal_power_sin(1.0))
    assert _rel(y, ref) <= F64_TOL, _rel(y, ref)
    assert state.conv_layers[1].step == x.shape[-1] // BLOCK


def test_tail_layers_staged_match_offline_chain(tail_nuc):
    """The staged step with the tail layers against the port's offline
    `process_chain` (eq_method scan): the block-wise scans against the
    whole-signal ones, the JAX package's own streaming-vs-offline bound
    (tests/test_streaming.py, 1e-9)."""
    st, x = tail_nuc
    eqp = _port_params(_params(3))
    cfg = t_chain.ChainConfig(sample_rate=SR, eq_method="scan")
    conv = t_conv.StereoConvolverState(left=st, right=st)
    sc = t_stream.StreamingChain(cfg, eqp, st, dtype=torch.float64,
                                 device="cpu")
    y, _ = sc.process(x)
    ref = t_chain.process_chain(x, cfg, eqp, conv)
    assert _rel(y, ref) <= 1e-9, _rel(y, ref)


def test_fdl_f16_tracks_f32(tail_nuc):
    """The f16 FDL tier (frame spectra stored in f16, the MAC in f32)
    tracks the f32 FDL within 1e-3 (tests/test_streaming.py's bound)."""
    st, x = tail_nuc
    st32 = t_nuc.NUCState(plan=st.plan, layer_spectra=[
        H.to(torch.complex64) for H in st.layer_spectra])
    cfg = t_chain.ChainConfig(sample_rate=SR, eq_bypassed=True,
                              apply_output_headroom=False)
    outs = {}
    for tag, fdt in (("f32", None), ("f16", torch.float16)):
        sc = t_stream.StreamingChain(cfg, None, st32, dtype=torch.float32,
                                     fdl_dtype=fdt, device="cpu")
        y, state = sc.process(x[..., :16 * 4096].float())
        outs[tag] = y
        if fdt is not None:
            assert state.conv_layers[1].fdl.dtype == torch.float16
    err = _rel(outs["f16"], outs["f32"])
    assert 0.0 < err <= 1e-3, err


def test_offset_under_partition_raises():
    plan = t_nuc.NUCPlan(
        layers=(t_nuc.NUCLayerPlan(0, 1024, 512, 2, 1.0, None),
                t_nuc.NUCLayerPlan(1024, 8192, 4096, 2, 1.0, None)),
        direct_taps=0, latency=512, block_size=512, ir_len=9216)
    st = t_nuc.NUCState(plan=plan, layer_spectra=[
        torch.zeros((2, 513), dtype=torch.complex128),
        torch.zeros((2, 4097), dtype=torch.complex128)])
    with pytest.raises(ValueError, match="offset"):
        t_stream.StreamingChain(t_chain.ChainConfig(sample_rate=SR), None,
                                st, dtype=torch.float64, device="cpu")


def test_folded_rejects_ineligible():
    ir = np.random.default_rng(3).normal(size=(2, 4000)) * 0.1
    spec = t_nuc.FilterSpec(SR, tail_mode=t_nuc.TAIL_BYPASS)
    for cfg in (t_chain.ChainConfig(sample_rate=SR, soft_clip_enabled=True),
                t_chain.ChainConfig(sample_rate=SR, wet_dry_mix=0.5)):
        with pytest.raises(ValueError, match="fused-eligible"):
            t_stream.StreamingChain.folded_from_ir(cfg, None, ir, spec,
                                                   device="cpu")


def test_f32_step_no_further_from_f64_than_jax():
    """The staged step in f32 against the port's f64 step: no further
    than the JAX package's f32 step (its 15-20 Hz high-passes in f32 on
    the 2x2 form; the port's in f64, see runtime/streaming.py)."""
    rng = np.random.default_rng(23)
    ir = _decaying(rng, (2,), 3000, 500.0)
    eqp = _params()
    kw = dict(sample_rate=SR, eq_method="scan")
    jspec, tspec = _bypass(SR)
    jc = j_conv.stereo_prepare(jnp.asarray(ir, jnp.float32), BLOCK, jspec,
                               apply_spectrum_filter=False)
    tc = t_conv.stereo_prepare(torch.from_numpy(ir), BLOCK, tspec,
                               apply_spectrum_filter=False, device="cpu")
    x = rng.normal(size=(2, 8192)) * 0.3
    js = j_stream.StreamingChain(j_chain.ChainConfig(**kw), eqp, jc.left,
                                 jc.right, dtype=jnp.float32)
    yj, _ = js.process(jnp.asarray(x, jnp.float32))
    out = {}
    for dt in (torch.float32, torch.float64):
        ts = t_stream.StreamingChain(t_chain.ChainConfig(**kw),
                                     _port_params(eqp), tc.left, tc.right,
                                     dtype=dt, device="cpu")
        out[dt], _ = ts.process(torch.from_numpy(x).to(dt))
    err_t = _rel(out[torch.float32], out[torch.float64])
    err_j = _rel(np.asarray(yj), out[torch.float64])
    assert err_t <= err_j and err_t <= 1e-5, (err_t, err_j)
