"""The soft-clipped, dithered render chain of convopeq_tpu_torch (bench
config6's path) against convopeq_tpu, in f64 on the CPU.

- affine_scan_2x2 and dc_block (odd N and the final state included),
  the fast tanh approximations (against tests/ref_harness/vectors/
  fast_tanh.json too), the halfband design, soft_clip and
  soft_clip_local2x: relative max error <= 1e-12.
- The semi-folded chain, prepared by the port and carried over from the
  JAX package by convopeq_tpu_torch.convert: a 6000-tap stereo IR, the
  20-band EQ and the soft clip at 48 kHz, 1 x 2 x 32768 samples, relative
  RMS <= 1e-12 before the quantizer.  Then the adaptive lattice shaper to
  24 bits on a learned bank carried across by convert.banks_from_dict:
  equal to the JAX output except for at most a few single-LSB flips.  The
  two pre-quantizer signals differ by ~1e-16 of full scale, so a sample
  whose shaped value lies that close to a rounding boundary may round the
  other way; the fir ladder forgets a flip within 9 samples.
- config6's own helpers at a cut size on the CPU, the entry points'
  default device (the card), and imports that leave JAX out.
"""
import json
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import dither as j_dither
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import learner as j_learner
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu.ops import dc_blocker as j_dc
from convopeq_tpu.ops import fast_tanh as j_ft
from convopeq_tpu.ops import oversample as j_os
from convopeq_tpu.ops import scan_iir as j_scan
from convopeq_tpu.ops import softclip as j_sc
from convopeq_tpu_torch import config6, convert
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import dither as t_dither
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.ops import dc_blocker as t_dc
from convopeq_tpu_torch.ops.dispatch import launches, plain, reset_launches
from convopeq_tpu_torch.ops import fast_tanh as t_ft
from convopeq_tpu_torch.ops import oversample as t_os
from convopeq_tpu_torch.ops import partitioned_conv as t_pc
from convopeq_tpu_torch.ops import scan_iir as t_scan
from convopeq_tpu_torch.ops import softclip as t_sc

ROOT = Path(__file__).resolve().parent.parent
SR = 48000.0


def _rel_max(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("n", [1, 128, 20000])
def test_affine_scan_2x2_matches_jax(n):
    rng = np.random.default_rng(n)
    A = np.array([[0.9, 0.05], [-0.1, 0.97]])
    bu = rng.normal(size=(3, n, 2))
    s0 = rng.normal(size=(3, 2))
    Ab = A[None] * np.array([1.0, 0.99, 1.01])[:, None, None]
    for a in (A, Ab):
        pj, fj = j_scan.affine_scan_2x2(jnp.asarray(a), jnp.asarray(bu),
                                        jnp.asarray(s0))
        pt, ft = t_scan.affine_scan_2x2(torch.from_numpy(a),
                                        torch.from_numpy(bu),
                                        torch.from_numpy(s0))
        assert pt.shape == (3, n, 2) and ft.shape == (3, 2)
        assert _rel_max(pt.numpy(), pj) <= 1e-12
        assert _rel_max(ft.numpy(), fj) <= 1e-12


@pytest.mark.parametrize("n", [77, 5001])
def test_dc_block_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, 3, n)) * 0.5
    s0 = rng.normal(size=(2, 3, 2)) * 0.1
    for sr, fc in ((384000.0, 3.0), (44100.0, 20.0)):
        yj, fj = j_dc.dc_block(jnp.asarray(x), sr, fc, jnp.asarray(s0))
        yt, ft = t_dc.dc_block(torch.from_numpy(x), sr, fc,
                               torch.from_numpy(s0))
        assert _rel_max(yt.numpy(), yj) <= 1e-12
        assert _rel_max(ft.numpy(), fj) <= 1e-12
    # streaming: two blocks carrying the final state are the whole call
    y, f = t_dc.dc_block(torch.from_numpy(x), SR, 3.0)
    y1, f1 = t_dc.dc_block(torch.from_numpy(x[..., :n // 2]), SR, 3.0)
    y2, f2 = t_dc.dc_block(torch.from_numpy(x[..., n // 2:]), SR, 3.0, f1)
    assert _rel_max(torch.cat([y1, y2], -1).numpy(), y.numpy()) <= 1e-12
    assert _rel_max(f2.numpy(), f.numpy()) <= 1e-12


def test_fast_tanh_matches_jax_and_reference_vectors():
    v = json.loads((ROOT / "tests" / "ref_harness" / "vectors" /
                    "fast_tanh.json").read_text())
    xv = np.asarray(v["x"])
    x = np.concatenate([xv, np.linspace(-9.0, 9.0, 2001)])
    for name, key in (("fast_tanh_eq", "eq_scalar"),
                      ("fast_tanh_eq_v", "eq_v128"),
                      ("fast_tanh_clip", "clip_v128")):
        got = getattr(t_ft, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(j_ft, name)(jnp.asarray(x)))
        assert _rel_max(got, want) <= 1e-12
        assert _rel_max(got[:len(xv)], v[key]) <= 1e-12


def test_halfband_design_matches_jax():
    for taps, atten in ((31, 90.0), (127, 110.0), (511, 140.0), (63, 120.0)):
        for gain in ("reference", "unity"):
            st = t_os.design_halfband(taps, atten, gain)
            sj = j_os.design_halfband(taps, atten, gain)
            for f in ("taps", "center_tap", "center_parity", "conv_parity",
                      "center_delay", "center_gain"):
                assert getattr(st, f) == getattr(sj, f)
            assert _rel_max(st.conv, np.asarray(sj.conv)) <= 1e-12
    x = np.linspace(0.0, 30.0, 61)
    assert _rel_max(t_os.bessel_i0(x), np.asarray(j_os.bessel_i0(x))) <= 1e-12


@pytest.mark.parametrize("sat", [0.0, 0.3, 1.0])
def test_soft_clip_matches_jax(sat):
    rng = np.random.default_rng(int(sat * 10))
    x = rng.normal(size=(2, 3, 5001)) * 0.6
    x[0, 0, :5] = [0.0, -0.0, 1.5, -1.5, 0.95]
    p = t_sc.soft_clip_params(sat)
    assert p == j_sc.soft_clip_params(sat)
    y = t_sc.soft_clip(torch.from_numpy(x), *p).numpy()
    assert _rel_max(y, j_sc.soft_clip(jnp.asarray(x), *p)) <= 1e-12
    y2 = t_sc.soft_clip_local2x(torch.from_numpy(x), *p).numpy()
    assert y2.shape == x.shape
    assert _rel_max(y2, j_sc.soft_clip_local2x(jnp.asarray(x), *p)) <= 1e-12
    # knee -> 0 is the hard clip
    h = t_sc.soft_clip(torch.from_numpy(x), 0.8, 0.0, 0.0).numpy()
    np.testing.assert_array_equal(h, np.clip(x, -0.8, 0.8))


# ------------------------------------------------------ the semi-fold

def _cfg(mod):
    return mod.ChainConfig(sample_rate=SR, soft_clip_enabled=True,
                           saturation_amount=0.3, output_makeup_gain=1.2,
                           apply_output_headroom=False)


@pytest.fixture(scope="module")
def jax_render():
    """The JAX package's semi-folded chain and lattice dither, in f64."""
    rng = np.random.default_rng(63)
    n_ir = 6000
    ir = rng.normal(size=(2, n_ir)) * np.exp(-np.arange(n_ir) / 900.0) * 0.2
    eqp = j_eq.EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    cfg = _cfg(j_chain)
    state = j_chain.prepare_semi_folded_convolver(
        ir, 512, j_nuc.FilterSpec(SR), cfg, eqp, dtype=jnp.float64)
    x = rng.normal(size=(1, 2, 32768)) * 0.25
    y = np.asarray(j_chain.process_chain_semi_fused(jnp.asarray(x), cfg,
                                                    state))
    with open(ROOT / "convopeq_tpu" / "data" / "learned_banks.json") as f:
        banks = j_learner.AdaptiveCoefficientBanks.from_dict(
            json.load(f)["banks"])
    u = rng.random(size=y.shape + (2,))
    q = np.asarray(j_dither.apply_dither(
        jnp.asarray(y), j_dither.ADAPTIVE9, SR, 24, uniforms=jnp.asarray(u),
        adaptive_coeffs=banks.get(SR, 24, 5)))
    return ir, x, state, y, banks, u, q


def _port_eq():
    eqp = t_chain.EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    return eqp


def test_semi_folded_chain_port_prep_matches_jax(jax_render):
    ir, x, jstate, y_ref, _banks, _u, _q = jax_render
    cfg = _cfg(t_chain)
    state = t_chain.prepare_semi_folded_convolver(
        ir, 512, t_nuc.FilterSpec(SR), cfg, _port_eq(), dtype=torch.float64,
        device="cpu")
    for side in ("left", "right"):
        jl, tl = getattr(jstate, side), getattr(state, side)
        assert [tuple(vars(lp).values()) for lp in tl.plan.layers] == \
            [tuple(vars(lp).values()) for lp in jl.plan.layers]
        Hj = np.asarray(jl.layer_spectra[0])
        assert _rel_max(tl.layer_spectra[0].numpy(), Hj) <= 1e-12
    y = t_chain.process_chain_semi_fused(torch.from_numpy(x), cfg,
                                         state).numpy()
    assert y.shape == x.shape and np.isfinite(y).all()
    assert np.abs(y).max() > cfg.output_makeup_gain * 0.25   # clip engaged
    assert _rel_rms(y, y_ref) <= 1e-12


def test_semi_folded_render_carried_state_matches_jax(jax_render):
    _ir, x, jstate, y_ref, jbanks, u, q_ref = jax_render
    plan = jstate.left.plan
    state = convert.stereo_state_from_arrays(
        [np.asarray(H) for H in jstate.left.layer_spectra],
        [np.asarray(H) for H in jstate.right.layer_spectra],
        [(lp.offset, lp.length, lp.part_size, lp.num_parts, lp.gain)
         for lp in plan.layers],
        plan.latency, plan.block_size, plan.ir_len, device="cpu")
    chain = t_chain.SemiFoldedChain(_cfg(t_chain), state)
    for path in (nullcontext(), plain()):
        with path:
            y = chain(torch.from_numpy(x))
        assert _rel_rms(y.numpy(), y_ref) <= 1e-12
    k9 = convert.banks_from_dict(jbanks.to_dict()).get(SR, 24, 5)
    q = t_dither.apply_dither(y, t_dither.ADAPTIVE9, SR, 24,
                              uniforms=torch.from_numpy(u),
                              adaptive_coeffs=k9).numpy()
    assert q.shape == x.shape
    grid = q * 2.0 ** 23
    np.testing.assert_array_equal(grid, np.round(grid))
    flips = np.abs(q - q_ref) * 2.0 ** 23
    assert flips.max() <= 1.0 and np.count_nonzero(flips) <= 4


def test_semi_folded_chain_rejects_what_does_not_fold():
    with pytest.raises(ValueError):          # soft clip off: full fold
        t_chain.prepare_semi_folded_convolver(
            np.ones(100), 512, t_nuc.FilterSpec(SR),
            t_chain.ChainConfig(sample_rate=SR), None, device="cpu")
    cfg = t_chain.ChainConfig(sample_rate=SR, soft_clip_enabled=True,
                              wet_dry_mix=0.5)
    with pytest.raises(ValueError):
        t_chain.prepare_semi_folded_convolver(
            np.ones(100), 512, t_nuc.FilterSpec(SR), cfg, None, device="cpu")


# ------------------------------------------------------------- config6

def test_config6_helpers_at_a_cut_size_on_cpu():
    """config6's chain at a 20k-tap IR, one stream of 5 ms: the output of
    the f32 path is on the 24-bit grid and tracks the f64 path."""
    chain32 = config6.config6_chain("cpu", torch.float32, ir_len=20_000)
    chain64 = config6.config6_chain("cpu", torch.float64, ir_len=20_000)
    assert chain32.cfg.sample_rate == 384000.0
    x = config6.config6_input(1, 0.005, "cpu")
    assert x.shape == (1, 2, 1920) and x.dtype == torch.float32
    k9 = config6.config6_bank()
    np.testing.assert_array_equal(
        k9, t_dither.lattice_coeffs(k9))            # inside +-0.85
    reset_launches()
    gen = torch.Generator().manual_seed(1)
    q = config6.render(chain32, x, k9, gen)
    assert set(launches().values()) == {0}
    grid = q.double() * 2.0 ** 23
    assert torch.equal(grid, torch.round(grid)) and q.shape == x.shape
    y32 = chain32(x).double().numpy()
    y64 = chain64(x.double()).numpy()
    assert _rel_rms(y32, y64) <= 2e-5


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = t_chain.ChainConfig(sample_rate=SR, soft_clip_enabled=True)
    calls = [
        lambda: t_chain.prepare_semi_folded_convolver(
            np.ones(100), 512, t_nuc.FilterSpec(SR), cfg, None),
        lambda: t_chain.prepare_folded_convolver(
            np.ones(100), 512, t_nuc.FilterSpec(SR), t_chain.ChainConfig(),
            None),
        lambda: t_nuc.nuc_prepare_uniform(np.ones(100), 512),
        lambda: t_pc.partition_spectra(np.ones(100), 512),
        lambda: convert.stereo_state_from_arrays(
            [np.ones((1, 513), complex)], [np.ones((1, 513), complex)],
            [(0, 100, 512, 1, 1.0)], 0, 512, 100),
        lambda: config6.config6_input(1, 0.01),
        lambda: config6.config6_chain(ir_len=1000),
        lambda: t_dither.dither_state_init((1, 2), t_dither.ADAPTIVE9),
    ]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()


def test_config6_and_chip_smoke_import_no_jax():
    code = ("import sys, chip_smoke, convopeq_tpu_torch.config6;"
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "False"
