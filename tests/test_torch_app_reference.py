"""ConvoPeqEngine.process, the application's staged chain, against the
benchmark's plain reference of it (benchmark/reference/staged.py and
psycho.py), on the CPU at a small size: the app_48k_psycho
configuration with a 40,000-tap IR at block 64, so that the NUC has all
three layers (64 x 32, 512 x 64 at 2,048, 4096 x 2 at 34,816).

- The reference's own set-up (its copies of the loader's trim and
  scale and of the auto-gain plan) against the engine's, from the same
  raw IR.
- The chain's output y in f64 within 1e-9 of the reference (the output
  filter's scans sit ~1e-11 from the exact recurrence; the rest ~1e-13),
  and in f32 within the configuration's rel_rms limit.
- The plain psycho quantizer against the port's plain quantizer in f32,
  bit for bit.
- q bit for bit the same with return_chain_output on and off.
"""
import numpy as np
import pytest
import torch

from benchmark import harness, system
from benchmark.reference import coeffs as C
from benchmark.reference import loader as L
from benchmark.reference.psycho import psycho_quantize
from benchmark.reference.staged import StagedReference
from benchmark.systems import engine as E
from convopeq_tpu_torch.models.dither import psycho_coeffs
from convopeq_tpu_torch.ops.quantize_kernels import \
    error_feedback_quantize_plain

SMALL = {"ir": {"taps": 40000, "decay_divisor": 10.0, "scale": 0.02},
         "block_size": 64}


@pytest.fixture(scope="module")
def app():
    """(configuration, IR, x (2, 2, N), u (2, 2, N, 2)) as f64 tensors."""
    cfg = harness.cell_data("app_48k_psycho.render")[1]
    cfg.update(SMALL)
    ir = system.ir_from_seed(cfg, 2 ** 31 + 3)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 2, 6000)) * 0.25)
    u = torch.from_numpy(rng.uniform(size=(2, 2, 6000, 2)))
    return cfg, ir, x, u


def _rel(y, ref):
    return float(((y.double() - ref).norm(dim=-1)
                  / ref.norm(dim=-1)).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_engine_against_the_reference(app, dtype):
    cfg, ir, x, u = app
    cfg = dict(cfg, dtype=dtype)
    eng = E._engine(cfg, ir, "cpu")
    assert [(lp.part_size, lp.num_parts, lp.offset) for lp in
            eng._conv_state.left.plan.layers] == \
        [(64, 32, 0), (512, 64, 2048), (4096, 2, 34816)]
    dt = E.DTYPES[dtype]
    y, q = eng.process(x.to(dt), uniforms=u.to(dt), return_chain_output=True)
    assert y.dtype == q.dtype == dt and y.shape == q.shape == x.shape
    err = _rel(y, StagedReference(cfg, ir, "cpu")(x))
    limit = 1e-9 if dtype == "float64" else \
        cfg["limits"]["render"]["rel_rms"]
    assert err <= limit, err


def test_reference_set_up_is_the_engines(app):
    """The plain loader's prepared IR and the plain plan's gains, from
    the raw IR and the configuration, are the engine's to rounding."""
    cfg, ir = app[:2]
    sr = cfg["sample_rate"]
    eng = E._engine(dict(cfg, dtype="float64"), ir, "cpu")
    prepared, peak_db = L.prepare_ir(ir, sr, ir.shape[-1] / sr)
    want = eng._ir_prepared
    assert np.abs(prepared - want).max() <= 1e-13 * np.abs(want).max()
    assert abs(peak_db - eng._ir_freq_peak_db) <= 1e-12
    c = eng._effective_config()
    got = L.auto_gain_eq_conv(C.eq_params(cfg["eq_gains_db"]), sr, peak_db)
    want = (c.input_headroom_gain, c.output_makeup_gain,
            c.convolver_input_trim_gain)
    assert np.allclose(got, want, rtol=1e-13, atol=0.0), (got, want)
    assert got != (1.0, 1.0, 1.0)


def test_q_is_the_same_with_the_chain_output_returned(app):
    cfg, ir, x, u = app
    eng = E._engine(cfg, ir, "cpu")
    x32, u32 = x.float(), u.float()
    q_off = eng.process(x32, uniforms=u32)
    y, q_on = eng.process(x32, uniforms=u32, return_chain_output=True)
    assert torch.equal(q_off, q_on)
    assert not torch.equal(y, q_on)
    eng.set_dither(0, 0)
    y, y2 = eng.process(x32, return_chain_output=True)
    assert y is y2


def test_psycho_reference_is_the_ports_quantizer_bit_for_bit(app):
    cfg = app[0]
    d = cfg["dither"]
    assert d["coeffs"] == list(psycho_coeffs(48000.0, d["bit_depth"]))
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(4, 4096)) * 0.3).astype(np.float32)
    u = rng.uniform(size=(4, 4096, 2)).astype(np.float32)
    q_ref = psycho_quantize(x, u, d["coeffs"], d["bit_depth"],
                            C.K_OUTPUT_HEADROOM)
    q, _ = error_feedback_quantize_plain(
        torch.from_numpy(x), torch.from_numpy(u), d["coeffs"],
        2.0 ** -(d["bit_depth"] - 1), C.K_OUTPUT_HEADROOM, "psycho")
    assert q_ref.dtype == np.float32
    assert np.array_equal(q.numpy(), q_ref)
