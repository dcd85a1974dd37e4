"""The IIR cascade's CUDA kernel (convopeq_tpu_torch/csrc/iir_cascade.cu)
and its wrapper (ops/iir_cascade.py), on the CPU.

- The kernel runs on the host through tests/iir_cascade_host_emulation.cpp
  (every thread of a block a coroutine, each barrier and warp collective
  a yield; skipped without g++), built twice: every tile publishing its
  inclusive state, and only every third tile, so that the look-back walks
  over the others' aggregates.  The emulated block's eight warps take
  tiles in turn, so tiles of one row are in flight together.
- It is held, on the DC blocker at 48 kHz (3 Hz) and 384 kHz (1 Hz) and
  on both output-filter cascades (convolver-last, EQ-last) at 48 and
  96 kHz, to the sequential recurrence (`_sequential`: the sections'
  per-sample arithmetic in f64, sample after sample) and to the plain
  version `iir_cascade_plain` (the JAX package's forms):
  - f64 out <= 1e-10 relative RMS from the sequential recurrence (the
    final states likewise).  The kernel sits ~1e-12 from one run in long
    double on these signals (a DC offset over noise), the recurrence in
    f64 up to ~1e-11.  Carries made in double instead of double-double
    sat ~1e-9 from it, a lost or doubled carry > 1e-4.
  - f64 out within 1e-10 plus the plain version's own distance from the
    recurrence of the plain version: that distance is ~1e-15 for the DC
    blocker's Toeplitz form, but up to ~2e-8 for the f64 2x2 route of the
    15-20 Hz biquads (their companion matrices' scans), so the kernel is
    held to the plain version as closely as the plain version holds to
    the recurrence.
  - f32 out <= 1e-6 relative RMS against the plain version in f64 of the
    same f32 input and states: the kernel's state is f64, so its f32
    output is the f64 value rounded once (~3e-8 RMS); the plain version's
    f32 routes drift to ~5e-4 on the 18 Hz high-pass, which a kernel in
    f32 state would show.
  - f64 out and final states <= 1e-12 relative RMS from the recurrence
    run in long double, at 48 and 192 kHz and on the 384 kHz DC blocker,
    over 20 tiles a row: the kernel sits ~1e-13 from it on this signal.
    With the host's powers of the cascade's matrix made in long double
    alone, their rounding, carried from tile to tile, put the kernel
    ~6e-11 from it on the 192 kHz convolver-last cascade.
- The FFT form `iir_cascade_fft` (the plain path's reference), in f64:
  <= 1e-13 relative RMS from the recurrence in long double on the same
  cascades (it sits ~4e-15 from it; the plain version's f64 2x2 route
  ~6e-11 at 48 kHz).  Inside `dispatch.plain()`, `dc_block` and
  `output_filter_process` take it, and the chain's plain path runs every
  DC blocker and the output filter through it, and the kernel never.
- Shapes: N = 1, N under one tile (2,048 f32 / 1,024 f64 samples),
  ragged last tiles, up to 20 tiles a row, R not a multiple of the
  block's eight warps, a row length off the 16-byte vector and a
  misaligned pointer (the scalar loads); zero and non-zero initial states
  and the final state.
- The wrapper: the CPU route is today's forms bit for bit (`dc_block` and
  `output_filter_process` against the Toeplitz form and the chain of
  `biquad_df2t_scan` calls); the launch counter moves by one on a launch
  and on nothing else (a faked launch on meta tensors); a strided signal
  launches on a contiguous copy; the wrapper and the C entry reject what
  the kernel does not take.
"""
import ctypes
import shutil
import subprocess
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from convopeq_tpu_torch.models import output_filter as of
from convopeq_tpu_torch.ops import dc_blocker as dcb
from convopeq_tpu_torch.ops import iir_cascade as ic
from convopeq_tpu_torch.ops.dispatch import plain, reset_launches
from convopeq_tpu_torch.ops.scan_iir import biquad_df2t_scan

ROOT = Path(__file__).resolve().parent.parent
F64_REL_RMS = 1e-10
F32_REL_RMS = 1e-6

SHAPES = [(3, 5001), (2, 2, 1300), (1, 4100), (5, 1), (4, 300), (13, 700),
          (2, 20011)]


def _dc(sr, fc):
    return (ic.dc_section(*dcb.dc_blocker_alphas(sr, fc)),)




CASCADES = {"dc48k": _dc(48000.0, 3.0), "dc384k": _dc(384000.0, 1.0),
            "conv_last48k": of.output_filter_sections(48000.0, True),
            "eq_last48k": of.output_filter_sections(48000.0, False),
            "conv_last96k": of.output_filter_sections(96000.0, True),
            "eq_last96k": of.output_filter_sections(96000.0, False)}
# held to the recurrence in long double, over LD_SHAPE
LD_CASCADES = {"conv_last48k": CASCADES["conv_last48k"],
               "conv_last192k": of.output_filter_sections(192000.0, True),
               "eq_last192k": of.output_filter_sections(192000.0, False),
               "dc192k": _dc(192000.0, 1.0), "dc384k": CASCADES["dc384k"]}
LD_SHAPE = (2, 20011)
F64_LD_REL_RMS = 1e-12
FFT_LD_REL_RMS = 1e-13


@pytest.fixture(scope="module", params=[1, 3],
                ids=["inclusive_every_tile", "inclusive_every_third"])
def emulated(request, tmp_path_factory):
    """The emulated library, its entries' argument types set; skips the
    test without a host C++ compiler."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    out = tmp_path_factory.mktemp("emu") / "libiir_cascade_emu.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-fno-strict-aliasing",
                    "-shared", "-fPIC",
                    f"-DIIR_INCLUSIVE_EVERY={request.param}", "-o", str(out),
                    str(ROOT / "tests" / "iir_cascade_host_emulation.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    for name in ("iir_cascade_f32", "iir_cascade_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P_, P_, I_, I_, I_, I_, I_,
                       ctypes.POINTER(ctypes.c_double), P_, P_, P_, P_, P_]
        fn.restype = I_
    return lib


def _run(lib, x, sections, state0=None):
    """The emulated kernel on x (contiguous): (y, final states)."""
    n = x.shape[-1]
    count = x.numel() // n * ic.tiles(n, x.element_size())
    y = torch.empty_like(x)
    final = torch.empty(x.shape[:-1] + (len(sections), 2), dtype=x.dtype)
    flags = torch.zeros(count + 1, dtype=torch.int32)
    vals = torch.empty(count * 8 * len(sections), dtype=torch.float64)
    fn = (lib.iir_cascade_f32 if x.dtype == torch.float32
          else lib.iir_cascade_f64)
    assert fn(*ic._entry_args(x, y, sections, state0, final, flags, vals),
              None) == 0
    assert int(flags[-1]) >= count          # every tile taken
    return y, final


def _signal(shape, seed):
    """Noise x 0.5 over a DC offset of 0.3, with full-scale values at every
    row's first samples."""
    x = np.random.default_rng(seed).normal(size=shape) * 0.5 + 0.3
    k = min(3, shape[-1])
    x[..., :k] = [1.5, -1.5, 0.95][:k]
    return torch.from_numpy(x)


def _state(shape, sections, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape[:-1] + (len(sections), 2)) * 0.2)


def _rel_rms(got, want):
    return float(((got - want).pow(2).mean()
                  / want.pow(2).mean().clamp_min(1e-300)).sqrt())


def _sequential(x, sections, state0=None, dtype=np.float64):
    """The cascade sample after sample in `dtype` (f64, or long double for
    the accuracy tests), in each section's own arithmetic (the kernel's
    per-sample step): (y, final states), f64."""
    x = x.double().numpy().astype(dtype)
    batch = x.shape[:-1]
    finals = []
    for k, sec in enumerate(sections):
        s = (np.zeros(batch + (2,), dtype) if state0 is None
             else state0[..., k, :].double().numpy().astype(dtype))
        y = np.empty_like(x)
        if sec.kind == "dc":
            a0, a1 = sec.coeffs
            for n in range(x.shape[-1]):
                s[..., 0] += a0 * (x[..., n] - s[..., 0])
                u = x[..., n] - s[..., 0]
                s[..., 1] += a1 * (u - s[..., 1])
                y[..., n] = u - s[..., 1]
        else:
            b0, b1, b2, a1, a2 = sec.coeffs
            for n in range(x.shape[-1]):
                v = x[..., n]
                y[..., n] = b0 * v + s[..., 0]
                s[..., 0] = b1 * v - a1 * y[..., n] + s[..., 1]
                s[..., 1] = b2 * v - a2 * y[..., n]
        x = y
        finals.append(s)
    return (torch.from_numpy(x.astype(np.float64)),
            torch.from_numpy(np.stack(finals, -2).astype(np.float64)))


_REFERENCES = {}


def _references(shape, name, with_state):
    """(x, state0, sequential (y, final), plain (y, final)) of one f64
    case, made once for both emulator builds."""
    key = (shape, name, with_state)
    if key not in _REFERENCES:
        sections = CASCADES[name]
        x = _signal(shape, shape[-1] + len(shape))
        s0 = _state(shape, sections, 5) if with_state else None
        _REFERENCES[key] = (x, s0, _sequential(x, sections, s0),
                            ic.iir_cascade_plain(x, sections, s0))
    return _REFERENCES[key]


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "state"])
@pytest.mark.parametrize("name", list(CASCADES))
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_source_f64_matches_plain_emulated(emulated, shape, name,
                                                with_state):
    x, s0, (seq, seq_fin), (plain, plain_fin) = _references(shape, name,
                                                            with_state)
    got, fin = _run(emulated, x, CASCADES[name], s0)
    assert got.shape == x.shape and fin.shape == plain_fin.shape
    assert _rel_rms(got, seq) <= F64_REL_RMS
    assert _rel_rms(fin, seq_fin) <= F64_REL_RMS
    assert _rel_rms(got, plain) <= F64_REL_RMS + _rel_rms(plain, seq)
    assert _rel_rms(fin, plain_fin) <= F64_REL_RMS + _rel_rms(plain_fin,
                                                              seq_fin)


_LD_REFERENCES = {}


def _long_double(name, shape=LD_SHAPE):
    """(x, the recurrence in long double (y, final)) of LD_CASCADES[name],
    made once."""
    key = (name, shape)
    if key not in _LD_REFERENCES:
        x = _signal(shape, 3)
        _LD_REFERENCES[key] = x, _sequential(x, LD_CASCADES[name], None,
                                             np.longdouble)
    return _LD_REFERENCES[key]


@pytest.mark.parametrize("name", list(LD_CASCADES))
def test_cuda_source_f64_matches_long_double_emulated(emulated, name):
    x, (want, want_fin) = _long_double(name)
    got, fin = _run(emulated, x, LD_CASCADES[name])
    assert _rel_rms(got, want) <= F64_LD_REL_RMS
    assert _rel_rms(fin, want_fin) <= F64_LD_REL_RMS


@pytest.mark.parametrize("name", list(CASCADES))
@pytest.mark.parametrize("shape", [(3, 5001), (13, 700), (5, 1)])
def test_cuda_source_f32_matches_plain_f64_emulated(emulated, shape, name):
    sections = CASCADES[name]
    x = _signal(shape, 11 + shape[-1]).float()
    s0 = _state(shape, sections, 9).float()
    want, want_fin = ic.iir_cascade_plain(x.double(), sections, s0.double())
    got, fin = _run(emulated, x, sections, s0)
    assert got.dtype == torch.float32 and fin.dtype == torch.float32
    assert _rel_rms(got.double(), want) <= F32_REL_RMS
    assert _rel_rms(fin.double(), want_fin) <= F32_REL_RMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_source_misaligned_rows_emulated(emulated, dtype):
    """A signal one value past a 16-byte boundary, rows of a length off
    the vector, takes the scalar loads and stores; rows are not carried
    into each other."""
    sections = CASCADES["eq_last48k"]
    base = _signal((3 * 1031 + 1,), 5).to(dtype)
    x = base[1:].view(3, 1031)
    assert x.data_ptr() % 16 != 0
    want, _ = _sequential(x, sections)
    got, _ = _run(emulated, x, sections)
    tol = F64_REL_RMS if dtype == torch.float64 else F32_REL_RMS
    assert _rel_rms(got.double(), want) <= tol
    for r in range(3):
        alone, _ = _run(emulated, x[r].clone(), sections)
        assert torch.equal(alone, got[r])


def test_cuda_source_split_call_carries_the_state_emulated(emulated):
    """Two calls that carry the final state are the whole call, to the
    kernel's accuracy (the split moves the tiles' boundaries, so the
    roundings differ)."""
    sections = CASCADES["conv_last96k"]
    x = _signal((2, 3000), 3)
    y, fin = _run(emulated, x, sections)
    y1, f1 = _run(emulated, x[:, :1777].contiguous(), sections)
    y2, f2 = _run(emulated, x[:, 1777:].contiguous(), sections, f1)
    assert _rel_rms(torch.cat([y1, y2], -1), y) <= F64_REL_RMS
    assert _rel_rms(f2, fin) <= F64_REL_RMS


def test_cuda_source_rejects_what_it_does_not_take_emulated(emulated):
    x = torch.zeros(2, 100, dtype=torch.float64)
    flags = torch.zeros(64, dtype=torch.int32)
    vals = torch.zeros(1024, dtype=torch.float64)
    coef = (ctypes.c_double * 20)(*([0.5] * 20))
    t = ic.tiles(100, 8)

    def call(R, N, tiles, K, kind):
        return emulated.iir_cascade_f64(
            x.data_ptr(), x.data_ptr(), R, N, tiles, K, kind, coef, None,
            None, flags.data_ptr(), vals.data_ptr(), None)

    for args in ((0, 100, t, 1, 1), (2, 0, 1, 1, 1), (2, 100, t + 1, 1, 1),
                 (2, 100, t, 2, 0), (2, 100, t, 4, 1), (2, 100, t, 0, 1),
                 (2, 100, t, 1, 2)):
        assert call(*args) == -1, args


# ------------------------------------------------------------ the wrapper

def test_cpu_route_is_todays_forms_bit_for_bit():
    reset_launches()
    x = _signal((2, 3, 1000), 7)
    s0 = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 2)))
    a0, a1 = dcb.dc_blocker_alphas(48000.0, 3.0)
    for state in (None, s0):
        y, fin = dcb.dc_block(x, 48000.0, 3.0, state)
        wy, wfin = ic.dc_block_toeplitz(x, a0, a1, state)
        assert torch.equal(y, wy) and torch.equal(fin, wfin)
    c = of.output_filter_coeffs(48000.0)
    natural = of.HC_NATURAL
    for conv_is_last, stages in (
            (True, (c["hc"][natural][0], c["hc"][natural][1],
                    c["lc"][of.LC_NATURAL])),
            (False, (c["hpf"], c["lp"][natural][0], c["lp"][natural][1]))):
        for xt in (x, x.float()):
            y = of.output_filter_process(xt, 48000.0, conv_is_last)
            want = xt
            for st in stages:
                if tuple(st) != of.IDENTITY:
                    want, _ = biquad_df2t_scan(want, *st)
            assert torch.equal(y, want)
    assert ic.launch_counts == {"iir_cascade": 0}


def test_launch_counter_moves_only_on_a_launch(monkeypatch):
    """A non-CPU tensor (meta here) goes to the kernel: one launch a call
    with R rows of N and the call's scratch, the count up by one; a failed
    launch raises and counts nothing."""
    calls, codes = [], [0]

    def fake_launch(x, y, sections, state0, final, flags, vals):
        calls.append((x.numel() // x.shape[-1], x.shape[-1], len(sections),
                      None if state0 is None else state0.dtype,
                      tuple(final.shape), flags.numel(), vals.numel()))
        return codes[0]

    monkeypatch.setattr(ic, "_launch", fake_launch)
    reset_launches()
    x = torch.empty((4, 2, 1000), device="meta")
    y, fin = dcb.dc_block(x, 48000.0, 3.0)
    assert y.shape == x.shape and fin.shape == (4, 2, 2)
    t32, t64 = ic.tiles(1000, 4), ic.tiles(1000, 8)
    assert calls == [(8, 1000, 1, None, (4, 2, 1, 2), 8 * t32 + 1,
                      8 * t32 * 8)]
    assert ic.launch_counts["iir_cascade"] == 1
    y = of.output_filter_process(x, 48000.0, False)
    assert y.shape == x.shape and calls[-1][2] == 3
    assert ic.launch_counts["iir_cascade"] == 2
    dcb.dc_block(x.double(), 384000.0, 1.0,
                 torch.zeros((4, 2, 2), device="meta"))
    assert calls[-1][3] == torch.float64 and calls[-1][6] == 8 * t64 * 8
    assert ic.launch_counts["iir_cascade"] == 3
    codes[0] = 700
    with pytest.raises(RuntimeError, match="code 700"):
        dcb.dc_block(x, 48000.0, 3.0)
    assert ic.launch_counts["iir_cascade"] == 3
    reset_launches()
    assert ic.launch_counts["iir_cascade"] == 0


def test_strided_signal_goes_through_a_contiguous_copy(monkeypatch):
    """A strided view (the staged chain hands the output filter one)
    launches on a contiguous copy of itself."""
    seen = []
    monkeypatch.setattr(ic, "_launch", lambda x, y, *a: seen.append(
        (x.is_contiguous(), tuple(x.shape), tuple(y.shape))) or 0)
    x = torch.empty((64, 2), device="meta").T
    y, _ = ic.iir_cascade(x, of.output_filter_sections(48000.0, True))
    assert seen == [(True, (2, 64), (2, 64))] and y.shape == (2, 64)


@pytest.mark.parametrize("bad", ["float16", "empty", "scalar",
                                 "dc_and_biquad", "two_dc", "four_biquads",
                                 "no_sections", "state_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, bad):
    monkeypatch.setattr(ic, "_launch", lambda *a: pytest.fail("launched"))
    reset_launches()
    dc, bq = _dc(48000.0, 3.0), of.output_filter_sections(48000.0, True)
    x = torch.empty((2, 64), device="meta")
    sections, state0 = bq, None
    if bad in ("float16", "empty", "scalar"):
        x = {"float16": torch.empty((2, 64), device="meta",
                                    dtype=torch.float16),
             "empty": torch.empty((2, 0), device="meta"),
             "scalar": torch.empty((), device="meta")}[bad]
    else:
        sections, state0 = {
            "dc_and_biquad": (dc + bq[:1], None), "two_dc": (dc + dc, None),
            "four_biquads": (bq + bq[:1], None), "no_sections": ((), None),
            "state_shape": (bq, torch.zeros((2, 2, 2), device="meta"))}[bad]
    with pytest.raises(ValueError):
        ic.iir_cascade(x, sections, state0)
    assert ic.launch_counts["iir_cascade"] == 0


# ------------------------------------------------------- the FFT form

@pytest.mark.parametrize("shape", [LD_SHAPE, (3, 1), (1, 700)])
@pytest.mark.parametrize("name", list(LD_CASCADES))
def test_fft_form_matches_the_long_double_recurrence(name, shape):
    x, (want, _) = _long_double(name, shape)
    got = ic.iir_cascade_fft(x, LD_CASCADES[name])
    assert got.shape == x.shape and got.dtype == torch.float64
    assert _rel_rms(got, want) <= FFT_LD_REL_RMS


def test_fft_route_of_the_callers():
    """Inside plain(), the callers run `iir_cascade_fft` bit for bit, from
    zero state and with no final state; on any device (meta here) they
    launch nothing, and take no initial state."""
    reset_launches()
    x = _signal((2, 3, 1000), 7)
    with plain():
        y, fin = dcb.dc_block(x, 192000.0, 1.0)
        assert fin is None and torch.equal(
            y, ic.iir_cascade_fft(x, _dc(192000.0, 1.0)))
        for conv_is_last in (True, False):
            y = of.output_filter_process(x, 96000.0, conv_is_last)
            assert y.is_contiguous() and torch.equal(y, ic.iir_cascade_fft(
                x, of.output_filter_sections(96000.0, conv_is_last)))
        with pytest.raises(ValueError, match="zero state"):
            ic.iir_cascade(x, _dc(48000.0, 3.0), torch.zeros((2, 3, 1, 2)))
        y, fin = dcb.dc_block(torch.empty((2, 1000), device="meta"),
                              48000.0, 3.0)
        assert fin is None and y.shape == (2, 1000)
    assert ic.launch_counts["iir_cascade"] == 0


@pytest.mark.parametrize("path", ["plain", "auto"])
def test_plain_chain_runs_the_fft_form(monkeypatch, path):
    """The chain's plain path runs its two DC blockers and its output
    filter (`process_chain`) and its output DC blocker
    (`process_chain_semi_fused`) in the FFT form; outside `plain()` the
    chain never does."""
    from convopeq_tpu_torch.models import chain
    from convopeq_tpu_torch.models import convolver
    from convopeq_tpu_torch.models.eq import EQParams
    from convopeq_tpu_torch.models.nuc import FilterSpec

    seen = []
    fft = ic.iir_cascade_fft
    monkeypatch.setattr(ic, "iir_cascade_fft", lambda x, sections: (
        seen.append(tuple(s.kind for s in sections)) or fft(x, sections)))
    x = _signal((1, 2, 3000), 4)
    cfg = chain.ChainConfig(sample_rate=48000.0)
    ctx = plain if path == "plain" else nullcontext
    with ctx():
        chain.process_chain(x, cfg, EQParams())
    want = [("dc",), ("biquad",) * 3, ("dc",)]
    assert seen == (want if path == "plain" else [])
    ir = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 600))
                          * 0.05)
    state = convolver.stereo_prepare(ir, 512, FilterSpec(48000.0),
                                     device="cpu")
    seen.clear()
    with ctx():
        chain.process_chain_semi_fused(x, cfg, state)
    assert seen == ([("dc",)] if path == "plain" else [])
