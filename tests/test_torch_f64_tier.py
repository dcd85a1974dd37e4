"""The <=1e-9 tier of convopeq_tpu_torch (native f64) against the JAX
package's f64 CPU path, on the CPU.

- uniform_partitioned_conv in f64 at P <= 8 and P > 8 (1e-12 relative
  RMS), and against the JAX dd pipeline `uniform_partitioned_conv_dd` in
  interpret mode at p = 512 (1e-10 of max: its double-f32 arithmetic
  truncates at ~2^-42), as tests/test_pallas_dd.py runs it.
- The parity lines of `convopeq_tpu_torch.parity` at a cut IR: the f64
  folded headline, the f64 prefilter chain and config5 (1e-12), and
  config5d32 / config5d24 dithered with the same uniforms (1e-9), with
  the JAX side on its plain f64 scans (CONVOPEQ_DD_DITHER=scan, as
  tools/tpu_parity.py runs its golden), which keeps the JAX package's
  f32 clip-bound fault of its residual route out of the comparison.
- Routing by dtype (f64 layers never reach the f32-only fused kernel), a
  mixed-dtype call raising, and `convert` taking split (Hr, Hi) spectra.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import convolver as j_conv
from convopeq_tpu.models import dither as j_dither
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu.ops import pallas_dd_fft as dd
from convopeq_tpu.ops import partitioned_conv as j_pc
from convopeq_tpu_torch import convert, parity
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import convolver as t_conv
from convopeq_tpu_torch.ops import frame_conv_kernels as fk
from convopeq_tpu_torch.ops import partitioned_conv as t_pc

SR = 48000.0
IR_CUT = 6000          # taps of the cut parity IRs


def _rel_rms(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _ir_case(seed, taps):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=taps) * np.exp(-np.arange(taps) / (taps / 4))
    return rng, h


@pytest.mark.parametrize("p,P", [(512, 3), (512, 8), (1024, 11),
                                 (2048, 9)])
def test_uniform_partitioned_conv_f64_matches_jax(p, P):
    rng, h = _ir_case(p + P, P * p - 37)
    x = rng.normal(size=(2, 3, 5 * p + 123))
    Hj = j_pc.partition_spectra(jnp.asarray(h), p, dtype=jnp.float64)
    y_ref = np.asarray(j_pc.uniform_partitioned_conv(jnp.asarray(x), Hj, p))
    Ht = t_pc.partition_spectra(h, p, dtype=torch.float64, device="cpu")
    assert Ht.dtype == torch.complex128 and Ht.shape == (P, p + 1)
    y = t_pc.uniform_partitioned_conv(torch.from_numpy(x), Ht, p)
    assert y.dtype == torch.float64 and y.shape == x.shape
    assert _rel_rms(y.numpy(), y_ref) <= 1e-12


@pytest.mark.skipif(dd.pl is None, reason="pallas unavailable")
def test_uniform_partitioned_conv_f64_matches_dd_pipeline():
    p = 512
    rng, h = _ir_case(42, 3 * p + 21)
    x = rng.normal(size=(2, 5 * p + 37))
    nparts = -(-h.size // p)
    hp = np.zeros((nparts, 2 * p))
    hp[:, :p] = np.pad(h, (0, nparts * p - h.size)).reshape(nparts, p)
    H = np.fft.rfft(hp, axis=-1)
    y_dd = np.asarray(dd.uniform_partitioned_conv_dd(
        jnp.asarray(x), jnp.asarray(H.real), jnp.asarray(H.imag), p,
        interpret=True))
    Ht = convert.prefilter_from_arrays((H.real, H.imag), p, device="cpu")[0]
    y = t_pc.uniform_partitioned_conv(torch.from_numpy(x), Ht, p).numpy()
    np.testing.assert_allclose(y, y_dd, rtol=0,
                               atol=1e-10 * np.abs(y_dd).max())


def _j_eq():
    eqp = j_chain.EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    return eqp


def _fid_input(line, seconds=0.2, batch=2):
    line.fid = (batch, seconds)
    x, u = parity.fidelity_signal(line, "cpu")
    return x, u


def test_parity_folded_headline_line_matches_jax():
    line = parity.make_line("headline_f64", "cpu", ir_len=IR_CUT)
    x, _ = _fid_input(line)
    ir, _eqp = parity.build_headline_fixture(IR_CUT)
    cfg = j_chain.ChainConfig(sample_rate=SR)
    state = j_chain.prepare_folded_convolver(
        ir, 512, j_nuc.FilterSpec(SR), cfg, _j_eq(), dtype=jnp.float64)
    y_ref = np.asarray(j_chain.process_chain_fused(jnp.asarray(x.numpy()),
                                                   cfg, state))
    y, q = line.run(x)
    assert q is None and y.dtype == torch.float64
    assert _rel_rms(y.numpy(), y_ref) <= 1e-12


def test_parity_prefilter_line_matches_jax():
    line = parity.make_line("prefilter_f64", "cpu", ir_len=IR_CUT)
    assert line.chain.prefilter_spectra.dtype == torch.complex128
    x, _ = _fid_input(line)
    ir, _eqp = parity.build_headline_fixture(IR_CUT)
    cfg = j_chain.ChainConfig(sample_rate=SR)
    spec = j_nuc.FilterSpec(SR)
    jpre = j_chain.prepare_fused_prefilter(cfg, _j_eq(), dtype=jnp.float64,
                                           spec=spec, ir_len=IR_CUT)
    jconv = j_conv.stereo_prepare(jnp.asarray(ir), 512, spec,
                                  apply_spectrum_filter=False)
    y_ref = np.asarray(j_chain.process_chain_fused(jnp.asarray(x.numpy()),
                                                   cfg, jconv, jpre))
    y, _ = line.run(x)
    assert _rel_rms(y.numpy(), y_ref) <= 1e-12


@pytest.fixture(scope="module")
def jax_semi():
    """The JAX package's semi-folded chain of the config5 fixture (cut
    IR), f64 on the CPU."""
    ir, eqp, cfg, x, _u, _k9, _bits = parity.build_semi_fixture(
        "config5", 0.25, ir_len=IR_CUT)
    jcfg = j_chain.ChainConfig(**cfg.__dict__)
    state = j_chain.prepare_semi_folded_convolver(
        ir, 512, j_nuc.FilterSpec(SR), jcfg, _j_eq(), dtype=jnp.float64)
    y = np.asarray(j_chain.process_chain_semi_fused(jnp.asarray(x), jcfg,
                                                    state))
    return x, y


def test_parity_config5_line_matches_jax(jax_semi):
    x, y_ref = jax_semi
    line = parity.make_line("config5", "cpu", ir_len=IR_CUT)
    for frame_mac in ("auto", "plain"):
        y, q = line.run(torch.from_numpy(x), frame_mac=frame_mac)
        assert q is None and y.shape == x.shape
        assert np.abs(y.numpy()).max() > 0.25          # the clip engaged
        assert _rel_rms(y.numpy(), y_ref) <= 1e-12


@pytest.mark.parametrize("name,bits", [("config5d32", 32),
                                       ("config5d24", 24)])
def test_parity_dithered_lines_match_jax(jax_semi, monkeypatch, name, bits):
    monkeypatch.setenv("CONVOPEQ_DD_DITHER", "scan")
    x, y_ref = jax_semi
    _ir, _eqp, _cfg, x2, u, k9, b = parity.build_semi_fixture(
        name, 0.25, ir_len=IR_CUT)
    assert b == bits and np.array_equal(x2, x) and u.shape == x.shape + (2,)
    q_ref = np.asarray(j_dither.apply_dither(
        jnp.asarray(y_ref), j_dither.ADAPTIVE9, SR, bits,
        uniforms=jnp.asarray(u), adaptive_coeffs=k9, lattice_ladder="fir"))
    line = parity.make_line(name, "cpu", ir_len=IR_CUT)
    assert line.bits == bits and np.array_equal(line.k9, k9)
    _y, q = line.run(torch.from_numpy(x), torch.from_numpy(u))
    q = q.numpy()
    grid = q * 2.0 ** (bits - 1)
    np.testing.assert_array_equal(grid, np.round(grid))
    assert _rel_rms(q, q_ref) <= 1e-9


def test_semi_fixture_is_the_jax_fixture_at_batch_one():
    _ir, _eqp, cfg, x, u, k9, bits = parity.build_semi_fixture(
        "config6", 0.01, ir_len=1000)
    n = int(384000.0 * 0.01)
    np.testing.assert_array_equal(
        x[0], np.random.default_rng(7).normal(size=(2, n)) * 0.25)
    np.testing.assert_array_equal(
        u[0], np.random.default_rng(11).random(size=(2, n, 2)))
    assert cfg.sample_rate == 384000.0 and bits == 24 and k9.shape == (9,)


@pytest.mark.parametrize("P", [8, 40])
def test_f64_layers_route_to_the_f64_frame_kernels(monkeypatch, P):
    """An f64 layer of any P goes through the three frame steps, whose
    wrappers launch the f64 kernels for these dtypes; an f32 layer of
    P <= 8 goes to the fused kernel."""
    entries, fused = [], []
    spies = tuple(
        (lambda op, fn: lambda *a: (entries.append(
            fk.kernel_entry(op, a[0].dtype)), fn(*a))[1])(op, fn)
        for op, fn in zip(("frames_rfft", "causal_mac", "irfft_valid"),
                          t_pc._FRAME_STEPS["auto"]))
    monkeypatch.setitem(t_pc._FRAME_STEPS, "auto", spies)
    monkeypatch.setattr(t_pc, "fused_conv",
                        lambda fr, H: fused.append(fr.dtype) or
                        fk.irfft_valid_plain(fk.causal_mac_plain(
                            fk.frames_rfft_plain(fr), H)))
    rng, h = _ir_case(P, P * 512 - 11)
    x = torch.from_numpy(rng.normal(size=(2, 2000)))
    H = t_pc.partition_spectra(h, 512, dtype=torch.float64, device="cpu")
    t_pc.uniform_partitioned_conv(x, H, 512)
    assert fused == []
    assert entries == ["frames_rfft_f64", "causal_mac_c128",
                       "irfft_valid_f64"]
    entries.clear()
    H32 = t_pc.partition_spectra(h, 512, dtype=torch.float32, device="cpu")
    t_pc.uniform_partitioned_conv(x.float(), H32, 512)
    if P <= 8:
        assert fused == [torch.float32] and entries == []
    else:
        assert fused == [] and entries == ["frames_rfft_f32",
                                           "causal_mac_c64",
                                           "irfft_valid_f32"]


def test_kernel_entries_by_dtype():
    assert fk.kernel_entry("osa_rfft", torch.float32) == "osa_rfft_f32"
    for op, dt in (("frames_rfft", torch.float16),
                   ("osa_rfft", torch.float64),
                   ("causal_mac", torch.float64),
                   ("irfft_valid", torch.float32)):
        with pytest.raises(ValueError):
            fk.kernel_entry(op, dt)


def test_mixed_dtype_call_raises():
    rng, h = _ir_case(5, 700)
    x = torch.from_numpy(rng.normal(size=(1, 3000)))
    H64 = t_pc.partition_spectra(h, 512, dtype=torch.float64, device="cpu")
    H32 = t_pc.partition_spectra(h, 512, dtype=torch.float32, device="cpu")
    for sig, H in ((x, H32), (x.float(), H64)):
        for frame_mac in ("auto", "plain"):
            with pytest.raises(ValueError, match="spectra"):
                t_pc.uniform_partitioned_conv(sig, H, 512, frame_mac)


def test_convert_takes_split_spectra():
    """The dd mode's split (Hr, Hi) f64 spectra give the state, and the
    output, of the complex ones."""
    rng = np.random.default_rng(9)
    ir = rng.normal(size=(2, 5000)) * np.exp(-np.arange(5000) / 800.0)
    jstate = j_conv.stereo_prepare(jnp.asarray(ir), 512,
                                   j_nuc.FilterSpec(SR))
    plan = jstate.left.plan
    layers = [(lp.offset, lp.length, lp.part_size, lp.num_parts, lp.gain,
               lp.damping) for lp in plan.layers]

    def state(split):
        side = [[(np.asarray(H).real, np.asarray(H).imag) if split
                 else np.asarray(H) for H in s.layer_spectra]
                for s in (jstate.left, jstate.right)]
        return convert.stereo_state_from_arrays(
            side[0], side[1], layers, plan.latency, plan.block_size,
            plan.ir_len, device="cpu")

    complex_state, split_state = state(False), state(True)
    for a, b in zip(complex_state.left.layer_spectra,
                    split_state.left.layer_spectra):
        assert b.dtype == torch.complex128 and torch.equal(a, b)
    x = torch.from_numpy(rng.normal(size=(2, 2, 6000)) * 0.25)
    y = t_conv.convolver_process(x, split_state, 1.0)
    assert torch.equal(y, t_conv.convolver_process(x, complex_state, 1.0))
    y_ref = np.asarray(j_conv.convolver_process(jnp.asarray(x.numpy()),
                                                jstate, 1.0))
    assert _rel_rms(y.numpy(), y_ref) <= 1e-12
    Hg = (np.ones((2, 513)), np.zeros((2, 513)))
    assert convert.prefilter_from_arrays(Hg, 512, device="cpu")[0].dtype \
        == torch.complex128
    with pytest.raises(ValueError):
        convert.prefilter_from_arrays((np.ones((2, 513)), np.ones((2, 512))),
                                      512, device="cpu")


@pytest.mark.parametrize("ir_len", [10, 300_000, 1_065_149, 2_100_000,
                                    10 ** 7])
def test_f64_throughput_partition_size_matches_jax_cpu(ir_len):
    """f64 caps at 65536, as the JAX package's f64 path off the TPU."""
    assert t_chain.throughput_partition_size(ir_len, f64=True) == \
        j_chain.throughput_partition_size(ir_len, f64=True)
    assert t_chain.throughput_partition_size(10 ** 7, f64=True) == 65536


def test_parity_and_sweep_import_no_jax():
    code = ("import sys, convopeq_tpu_torch.parity, convopeq_tpu_torch.sweep,"
            " convopeq_tpu_torch.staged, convopeq_tpu_torch.models.metering;"
            "print('jax' in sys.modules, 'convopeq_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.stdout.split() == ["False", "False"]
