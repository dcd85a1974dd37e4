"""The folded chain of convopeq_tpu_torch against convopeq_tpu, in f64 on
the CPU: 2 streams x 0.25 s through a 20k-tap stereo IR and the 20-band
EQ at +-4 dB, at relative RMS <= 1e-12 — once with the port's own
preparation, once with the JAX package's prepared state carried over by
convopeq_tpu_torch.convert."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import chain as j_chain
from convopeq_tpu.models import eq as j_eq
from convopeq_tpu.models import nuc as j_nuc
from convopeq_tpu_torch import convert, headline
from convopeq_tpu_torch.device import resolve_device
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.models import nuc as t_nuc
from convopeq_tpu_torch.ops import frame_conv_kernels as fk

SR = 48000.0


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX package's folded chain, prepared and run in f64."""
    ir = headline.headline_ir(20_000, seed=3)
    eqp = j_eq.EQParams()
    eqp.gains_db[:] = np.linspace(-4.0, 4.0, 20)
    cfg = j_chain.ChainConfig(sample_rate=SR)
    state = j_chain.prepare_folded_convolver(
        ir, 512, j_nuc.FilterSpec(SR), cfg, eqp, dtype=jnp.float64)
    x = np.random.default_rng(4).normal(size=(2, 2, int(0.25 * SR))) * 0.25
    x[0, 0, 100] = np.nan                     # sanitize: NaN -> 0
    x[1, 1, 7] = 3.0                          # clamp
    x[0, 1, 50] = -np.inf                     # Inf survives to the clamp
    x[1, 0, 9] = 1e-21                        # denormal-range flush
    y = np.asarray(j_chain.process_chain_fused(jnp.asarray(x), cfg, state))
    return ir, x, state, y


def test_folded_slice_port_prep_matches_jax(jax_slice):
    ir, x, jstate, y_ref = jax_slice
    cfg = t_chain.ChainConfig(sample_rate=SR)
    state = t_chain.prepare_folded_convolver(
        ir, 512, t_nuc.FilterSpec(SR), cfg, headline.headline_eq(),
        dtype=torch.float64, device="cpu")
    plan_fields = lambda pl: ([tuple(vars(lp).values()) for lp in pl.layers],
                              pl.direct_taps, pl.latency, pl.block_size,
                              pl.ir_len)
    assert plan_fields(state.left.plan) == plan_fields(jstate.left.plan)
    for side in ("left", "right"):
        Ht = getattr(state, side).layer_spectra[0].numpy()
        Hj = np.asarray(getattr(jstate, side).layer_spectra[0])
        np.testing.assert_allclose(Ht, Hj, rtol=0,
                                   atol=1e-12 * np.abs(Hj).max())
    y = t_chain.process_chain_fused(torch.from_numpy(x), cfg, state).numpy()
    assert y.shape == x.shape and np.isfinite(y).all()
    assert _rel_rms(y, y_ref) <= 1e-12


def test_folded_slice_converted_state_matches_jax(jax_slice):
    _ir, x, jstate, y_ref = jax_slice
    plan = jstate.left.plan
    state = convert.stereo_state_from_arrays(
        [np.asarray(H) for H in jstate.left.layer_spectra],
        [np.asarray(H) for H in jstate.right.layer_spectra],
        [(lp.offset, lp.length, lp.part_size, lp.num_parts, lp.gain)
         for lp in plan.layers],
        plan.latency, plan.block_size, plan.ir_len, device="cpu")
    chain = t_chain.FoldedChain(t_chain.ChainConfig(sample_rate=SR), state)
    for frame_mac in ("auto", "plain"):
        y = chain(torch.from_numpy(x), frame_mac).numpy()
        assert _rel_rms(y, y_ref) <= 1e-12


def test_folded_chain_f32_tracks_f64(jax_slice):
    """The f32 chain (the card's working type, here on the plain path)
    against the f64 reference: the tolerance the card run is held to."""
    ir, x, _jstate, y_ref = jax_slice
    chain = headline.headline_chain("cpu", torch.float32, ir_len=20_000,
                                    seed=3)
    assert chain.convolver.left_spectra_0.dtype == torch.complex64
    y = chain(torch.from_numpy(x).float()).double().numpy()
    assert _rel_rms(y, y_ref) <= 2e-5


def test_folded_chain_rejects_unported_plans():
    """The 3-layer (None) and "fused2" plans run and give the auto plan's
    convolution; an unknown plan and AIR tail mode still raise."""
    cfg = t_chain.ChainConfig()
    ir = headline.headline_ir(3000, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 2, 4000)))
    prep = lambda partition, **kw: t_chain.prepare_folded_convolver(
        ir, 512, t_nuc.FilterSpec(), cfg, None, dtype=torch.float64,
        partition=partition, device="cpu", **kw)
    y_auto = t_chain.process_chain_fused(x, cfg, prep("auto")).numpy()
    for partition in (None, "fused2"):
        state = prep(partition, p_near=512)
        assert state.left.plan.num_layers >= 2
        y = t_chain.process_chain_fused(x, cfg, state).numpy()
        assert _rel_rms(y, y_auto) <= 1e-12
    with pytest.raises(ValueError):
        prep("three-layer")
    with pytest.raises(ValueError):             # AIR tail mode
        t_chain.prepare_folded_convolver(
            np.ones(20_000), 512, t_nuc.FilterSpec(tail_mode=0), cfg, None,
            device="cpu")


def test_import_leaves_jax_out():
    """Every module of the port (walked with pkgutil, the engine, the CLI
    and the IR preparation included) and chip_smoke.py import without
    bringing in jax or the JAX package."""
    code = ("import importlib, pkgutil, sys, convopeq_tpu_torch as p;"
            "names = [m.name for m in pkgutil.walk_packages("
            "p.__path__, 'convopeq_tpu_torch.')];"
            "[importlib.import_module(n) for n in names];"
            "import chip_smoke;"
            "print(' '.join(names));"
            "print('jax' in sys.modules, 'convopeq_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parent.parent)
    names, flags = out.stdout.strip().splitlines()
    for name in ("engine.engine", "engine.cache", "cli", "ir.phase",
                 "ir.allpass", "ir.cmaes", "models.metering",
                 "models.analyzer_view", "ops.limiter", "utils.wavio",
                 "headline", "ops.frame_conv_kernels", "runtime.streaming"):
        assert f"convopeq_tpu_torch.{name}" in names.split(), name
    assert flags == "False False"


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        headline.headline_input(1, 0.01, "cuda")
    with pytest.raises(RuntimeError):
        t_chain.prepare_folded_convolver(
            np.ones(100), 512, t_nuc.FilterSpec(), t_chain.ChainConfig(),
            None, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cpu_run_launches_no_kernel():
    fk.reset_launch_counts()
    chain = headline.headline_chain("cpu", torch.float32, ir_len=5_000)
    y = chain(headline.headline_input(1, 0.05, "cpu"))
    assert torch.isfinite(y).all()
    assert set(fk.launch_counts.values()) == {0}
