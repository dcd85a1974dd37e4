"""The 3-layer convolver and the fused-prefilter chain of convopeq_tpu_torch
against convopeq_tpu, in f64 on the CPU.

- `nuc_prepare`: plans and spectra equal to the JAX package's at 1e-12
  across tail modes, the direct head, `scale` and the spectrum filter,
  and the exact-delivery convolution at 1e-12 relative RMS.
- `nuc_convolve(tail_delivery="reference")` against the reference
  binary's vectors (tests/ref_harness/vectors/nuc.json), every case and
  the 600k-tap "long" case, at tests/test_ref_vectors.py's tolerances.
- `tail_delivery_map` equal to the JAX one.
- `convolver_process` at mix 0.7 and with a mix ramp, and the chains
  (`process_chain_fused(prefilter=)`, partition=None), at 1e-12 relative
  RMS: once prepared by the port, once from the JAX state carried over by
  convopeq_tpu_torch.convert.
- The headline's plans, and no kernel launch on the CPU.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import convolver as j_conv
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu_torch import convert, headline, nuc3
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import convolver as t_conv
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.ops.dispatch import launches, reset_launches

SR = 48000.0
VECTORS = Path(__file__).resolve().parent / "ref_harness" / "vectors"


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _plan_fields(plan):
    return ([tuple(vars(lp).values()) for lp in plan.layers],
            plan.direct_taps, plan.latency, plan.block_size, plan.ir_len)


def _assert_state_equal(t_state, j_state, tol=1e-12):
    assert _plan_fields(t_state.plan) == _plan_fields(j_state.plan)
    for Ht, Hj in zip(t_state.layer_spectra, j_state.layer_spectra):
        Hj = np.asarray(Hj)
        np.testing.assert_allclose(Ht.numpy(), Hj, rtol=0,
                                   atol=tol * np.abs(Hj).max())
    if j_state.direct_ir is None:
        assert t_state.direct_ir is None
    else:
        np.testing.assert_allclose(t_state.direct_ir.numpy(),
                                   np.asarray(j_state.direct_ir), rtol=0,
                                   atol=0)


def _converted(jstate):
    """A JAX StereoConvolverState as the port's, through convert.py."""
    plan = jstate.left.plan
    direct = None
    if jstate.left.direct_ir is not None:
        direct = (np.asarray(jstate.left.direct_ir),
                  np.asarray(jstate.right.direct_ir))
    return convert.stereo_state_from_arrays(
        [np.asarray(H) for H in jstate.left.layer_spectra],
        [np.asarray(H) for H in jstate.right.layer_spectra],
        [(lp.offset, lp.length, lp.part_size, lp.num_parts, lp.gain,
          lp.damping) for lp in plan.layers],
        plan.latency, plan.block_size, plan.ir_len, direct=direct,
        device="cpu")


# ------------------------------------------------------------ nuc_prepare

AIR, CONTOUR, BYPASS = (t_nuc.TAIL_AIR_ABSORPTION, t_nuc.TAIL_CONTOUR,
                        t_nuc.TAIL_BYPASS)


@pytest.mark.parametrize("tail_mode,direct,scale,filt", [
    (AIR, False, 1.0, True), (AIR, True, 2.0, False),
    (CONTOUR, True, 0.5, True), (CONTOUR, False, 1.0, False),
    (BYPASS, False, 1.0, False), (BYPASS, True, 0.7, True)])
def test_nuc_prepare_matches_jax(tail_mode, direct, scale, filt):
    """Block 64 puts all three layers on a 40k-tap IR (L0 2048, L1
    32768, L2 the rest); AIR damps L1 and L2."""
    rng = np.random.default_rng(tail_mode * 8 + direct)
    ir = rng.normal(size=40_000) * np.exp(-np.arange(40_000) / 9000.0)
    kw = dict(scale=scale, enable_direct_head=direct,
              apply_spectrum_filter=filt)
    js = j_nuc.nuc_prepare(ir, 64, j_nuc.FilterSpec(SR, tail_mode=tail_mode),
                           **kw)
    ts = t_nuc.nuc_prepare(ir, 64, t_nuc.FilterSpec(SR, tail_mode=tail_mode),
                           device="cpu", **kw)
    _assert_state_equal(ts, js)
    assert (ts.plan.num_layers == 1) == (tail_mode == BYPASS)
    assert (ts.plan.layers[-1].damping is not None) == (tail_mode == AIR)
    x = rng.normal(size=(2, 30_000))
    y_ref = np.asarray(j_nuc.nuc_convolve(jnp.asarray(x), js))
    y = t_nuc.nuc_convolve(torch.from_numpy(x), ts).numpy()
    assert _rel_rms(y, y_ref) <= 1e-12


@pytest.mark.parametrize("part,block,nparts,delay,nblocks", [
    (4096, 512, 64, 5760, 200), (32768, 512, 11, 267904, 710),
    (512, 64, 32, 2048, 300), (8192, 1000, 5, 3000, 90)])
def test_tail_delivery_map_matches_jax(part, block, nparts, delay, nblocks):
    np.testing.assert_array_equal(
        t_nuc.tail_delivery_map(part, block, nparts, delay, nblocks),
        j_nuc.tail_delivery_map(part, block, nparts, delay, nblocks))


# ------------------------------------------- the reference binary's vectors

def _xs64(seed, n, scale=1.0):
    """xorshift64* uniform in [-0.5, 0.5), as tests/ref_harness/dump_nuc
    draws it."""
    mask = (1 << 64) - 1
    s = seed
    out = np.empty(n)
    for i in range(n):
        s ^= (s >> 12)
        s = (s ^ (s << 25)) & mask
        s ^= (s >> 27)
        r = (s * 2685821657736338717) & mask
        out[i] = (r >> 11) * (1.0 / 9007199254740992.0) - 0.5
    return out * scale


def _case_ir_input(c):
    ir_len = int(c["ir_len"])
    total = int(c["nblocks"]) * int(c["block"])
    if int(c["ir_seed"]) == 0:
        ir = np.where(np.sin(np.arange(ir_len) * 0.1) > 0.0, 1.0, -1.0)
    else:
        ir = _xs64(int(c["ir_seed"]), ir_len) * np.exp(
            -np.arange(ir_len) / float(c["ir_tau"]))
    if int(c["in_seed"]) == 0:
        x = np.zeros(total)
        x[0] = 1.0
        if total > 700:
            x[700] = -0.75
    else:
        x = _xs64(int(c["in_seed"]), total, scale=0.8)
    return ir, x


def _case_spec(c):
    if not c.get("has_spec", True):
        return t_nuc.FilterSpec(SR), False
    s = c["spec"]
    return t_nuc.FilterSpec(
        SR, hc_mode=int(s["hc"]), lc_mode=int(s["lc"]),
        tail_mode=int(s["tail_mode"]), tail_enabled=bool(s["tail_enabled"]),
        tail_start_seconds=float(s["tail_start"]),
        tail_strength=float(s["tail_strength"]),
        tail_l1l2_multiplier=int(s["mult"])), True


def _reference_output(c, ir, x):
    spec, apply_filter = _case_spec(c)
    st = t_nuc.nuc_prepare(ir, int(c["block"]), spec, scale=float(c["scale"]),
                           enable_direct_head=bool(c["direct_head"]),
                           apply_spectrum_filter=apply_filter, device="cpu")
    assert st.plan.latency == int(c["latency"])
    return t_nuc.nuc_convolve(torch.from_numpy(x), st,
                              tail_delivery="reference").numpy()


@pytest.fixture(scope="module")
def nuc_vectors():
    return json.loads((VECTORS / "nuc.json").read_text())


def test_nuc_reference_delivery_matches_reference_binary(nuc_vectors):
    for c in nuc_vectors["cases"]:
        ir, x = _case_ir_input(c)
        got = np.asarray(c["output"])
        np.testing.assert_allclose(
            _reference_output(c, ir, x), got, rtol=0,
            atol=1e-12 * max(1.0, np.abs(got).max()), err_msg=c["name"])


def test_nuc_reference_delivery_long_3layer_matches_reference_binary(
        nuc_vectors):
    L = nuc_vectors["long"]
    ir_len = int(L["ir_len"])
    total = int(L["nblocks"]) * int(L["block"])
    ir = _xs64(int(L["ir_seed"]), ir_len) * np.exp(
        -np.arange(ir_len) / float(L["ir_tau"]))
    x = _xs64(int(L["in_seed"]), total, scale=0.8)
    np.testing.assert_allclose(x[:64], np.asarray(L["input_head"]), rtol=0,
                               atol=0)
    c = dict(ir_len=ir_len, block=int(L["block"]), latency=int(L["latency"]),
             scale=1.0, direct_head=False, has_spec=True,
             spec=dict(hc=1, lc=0, tail_mode=1, tail_enabled=True,
                       tail_start=0.085, tail_strength=1.0, mult=8))
    y = _reference_output(c, ir, x)
    atol = 1e-12 * max(1.0, np.abs(y).max())
    np.testing.assert_allclose(y[:8192], L["out_first"], rtol=0, atol=atol)
    np.testing.assert_allclose(y[270336:270336 + 4096], L["out_mid"], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(y[::61], L["out_strided61"], rtol=0,
                               atol=atol)
    rms = np.sqrt(np.mean(y[:total - total % 4096].reshape(-1, 4096) ** 2,
                          axis=1))
    np.testing.assert_allclose(rms, L["out_rms4096"], rtol=1e-9, atol=0)


# -------------------------------------------------------------- convolver

@pytest.fixture(scope="module")
def room():
    """A 6000-tap room IR through the JAX stereo_prepare (direct head and
    spectrum filter on: 32 taps, 512 x 12, 4096 x 1) and the input."""
    ir = nuc3.room_ir(6000, seed=2)
    js = j_conv.stereo_prepare(jnp.asarray(ir), 512, j_nuc.FilterSpec(SR),
                               enable_direct_head=True)
    x = np.random.default_rng(9).normal(size=(2, 2, 9000)) * 0.3
    return ir, js, x


@pytest.mark.parametrize("ramp", [False, True])
def test_convolver_mix_matches_jax(room, ramp):
    ir, js, x = room
    mix_ramp = (t_conv.linear_mix_ramp(x.shape[-1], 1.0, 0.7, SR, 0.1,
                                       device="cpu") if ramp else None)
    y_ref = np.asarray(j_conv.convolver_process(
        jnp.asarray(x), js, 0.7,
        mix_ramp=None if mix_ramp is None else jnp.asarray(
            mix_ramp.numpy())))
    ts = t_conv.stereo_prepare(ir, 512, t_nuc.FilterSpec(SR),
                               enable_direct_head=True, device="cpu")
    _assert_state_equal(ts.left, js.left)
    _assert_state_equal(ts.right, js.right)
    for state in (ts, _converted(js)):
        module = t_conv.StereoConvolver(state)
        y = module(torch.from_numpy(x), 0.7, mix_ramp=mix_ramp).numpy()
        assert _rel_rms(y, y_ref) <= 1e-12


def test_stereo_prepare_duplicates_a_mono_ir():
    ir = nuc3.room_ir(3000)[0]
    st = t_conv.stereo_prepare(ir, 512, t_nuc.FilterSpec(SR),
                               enable_direct_head=True, device="cpu")
    for Hl, Hr in zip(st.left.layer_spectra, st.right.layer_spectra):
        assert torch.equal(Hl, Hr)
    assert torch.equal(st.left.direct_ir, st.right.direct_ir)


# ----------------------------------------------------------------- chains

@pytest.fixture(scope="module")
def chain_case():
    ir = headline.headline_ir(20_000, seed=3)
    cfg = j_chain.ChainConfig(sample_rate=SR)
    x = np.random.default_rng(4).normal(size=(2, 2, int(0.25 * SR))) * 0.25
    x[0, 0, 100] = np.nan
    x[1, 1, 7] = 3.0
    return ir, cfg, x


def _j_eq():
    from convopeq_tpu.models.eq import EQParams
    eqp = EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    return eqp


def test_prefilter_chain_matches_jax(chain_case):
    ir, cfg, x = chain_case
    spec = j_nuc.FilterSpec(SR)
    jpre = j_chain.prepare_fused_prefilter(cfg, _j_eq(), dtype=jnp.float64,
                                           spec=spec, ir_len=20_000)
    jconv = j_conv.stereo_prepare(jnp.asarray(ir), 512, spec,
                                  apply_spectrum_filter=False)
    y_ref = np.asarray(j_chain.process_chain_fused(jnp.asarray(x), cfg,
                                                   jconv, jpre))
    tcfg = t_chain.ChainConfig(sample_rate=SR)
    chain = nuc3.prefilter_chain("cpu", torch.float64, ir_len=20_000, seed=3)
    assert chain.prefilter_part == 8192
    np.testing.assert_allclose(chain.prefilter_spectra.numpy(),
                               np.asarray(jpre[0]), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jpre[0])).max())
    _assert_state_equal(chain.convolver.state.left, jconv.left)
    converted = t_chain.PrefilterChain(
        tcfg, convert.prefilter_from_arrays(np.asarray(jpre[0]), jpre[1],
                                            device="cpu"), _converted(jconv))
    for c in (chain, converted):
        y = c(torch.from_numpy(x)).numpy()
        assert y.shape == x.shape and np.isfinite(y).all()
        assert _rel_rms(y, y_ref) <= 1e-12


@pytest.mark.parametrize("partition", [None])
def test_folded_plans_match_jax(chain_case, partition):
    ir, cfg, x = chain_case
    jstate = j_chain.prepare_folded_convolver(
        ir, 512, j_nuc.FilterSpec(SR), cfg, _j_eq(), dtype=jnp.float64,
        partition=partition)
    y_ref = np.asarray(j_chain.process_chain_fused(jnp.asarray(x), cfg,
                                                   jstate))
    tcfg = t_chain.ChainConfig(sample_rate=SR)
    tstate = t_chain.prepare_folded_convolver(
        ir, 512, t_nuc.FilterSpec(SR), tcfg, headline.headline_eq(),
        dtype=torch.float64, partition=partition, device="cpu")
    _assert_state_equal(tstate.left, jstate.left)
    _assert_state_equal(tstate.right, jstate.right)
    for state in (tstate, _converted(jstate)):
        y = t_chain.FoldedChain(tcfg, state)(torch.from_numpy(x)).numpy()
        assert _rel_rms(y, y_ref) <= 1e-12


def test_headline_plans():
    """The prefilter is 65,150 taps as 8192 x 8; the 1M-tap IR plans as
    512 x 12, 4096 x 64 (gain 1.4375), 32768 x 23 (gain 1.1), as in the
    JAX package."""
    spec = t_nuc.FilterSpec(SR)
    g = t_chain.fused_prefilter_ir(t_chain.ChainConfig(),
                                   headline.headline_eq(), spec=spec)
    assert g.shape == (65_150,)
    plan = t_nuc.plan_layers(headline.IR_LEN, 512, spec)
    assert _plan_fields(plan) == _plan_fields(
        j_nuc.plan_layers(headline.IR_LEN, 512, j_nuc.FilterSpec(SR)))
    assert [(lp.part_size, lp.num_parts) for lp in plan.layers] == [
        (512, 12), (4096, 64), (32768, 23)]
    assert [round(lp.gain, 4) for lp in plan.layers] == [1.0, 1.4375, 1.1]
    room = t_nuc.plan_layers(nuc3.ROOM_IR_LEN, 512, spec, True)
    assert room.direct_taps == 32
    assert [(lp.part_size, lp.num_parts) for lp in room.layers] == [
        (512, 12), (4096, 5)]


def test_cpu_runs_launch_no_kernel():
    reset_launches()
    x = headline.headline_input(1, 0.2, "cpu")
    chain = nuc3.prefilter_chain("cpu", torch.float32, ir_len=12_000)
    conv = nuc3.roomcorr_convolver("cpu", ir_len=8000)
    for y in (chain(x), nuc3.roomcorr_process(conv, x)):
        assert y.shape == x.shape and torch.isfinite(y).all()
    assert set(launches().values()) == {0}
