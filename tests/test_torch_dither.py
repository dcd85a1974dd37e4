"""The dither shapers of convopeq_tpu_torch on the CPU, against
convopeq_tpu and against the reference binary.

- Tables, coefficients, the three RNGs and the learned banks equal the
  JAX package's exactly.
- The plain shapers in f64 reproduce tests/ref_harness/vectors/
  shapers.json and psycho.json bit for bit over the full sequence (the
  binary was built with -ffp-contract=off; eager PyTorch rounds every
  multiply and every add on its own).
- Against the JAX lax.scan shapers.  XLA:CPU fuses a multiply and the
  add that consumes it into one FMA inside a jitted scan, and no flag
  turns that off; eager PyTorch never does.  So:
  * f64, R = 3, N = 700, jitted: fixed4, fixed15 and both lattice
    ladders give the same q bit for bit over the full sequence (at 2^-53
    a contracted product moves no rounding decision here); their states
    out (errors q - y, with |y| < 1) differ only by the rounding of y
    that contraction moves, within 16 ULP of full scale;
  * the states bit for bit: 24 samples from a random state with jit
    disabled, where JAX runs one op at a time and contracts nothing;
  * psycho: its 12-term sum turns the contraction into a rounding flip
    within a few hundred samples (by sample ~47 at 384 kHz,
    tests/test_ref_vectors.py), so it is held bitwise over the first 32
    samples and on the quantization grid after that; its full-sequence
    bitwise pin is psycho.json;
  * f32, one step, bitwise (jit disabled) over 4096 random states that
    reach the +-2 clamps;
  * f32 over the full sequence for fixed4, jitted: the contraction flips
    a rounding decision, so q is held to the grid and to a bounded
    divergence (at most 4 LSB).
- apply_dither on the CPU against the JAX one in f64.
- The CUDA source's arithmetic (the step, the copy warp's terms and the
  chain warp's batched loop over a stage), compiled for the host with
  g++ -ffp-contract=off by tests/quantize_host_emulation.cpp and driven
  in tiles and batches as the kernel drives it, against the plain version
  bit for bit in all five modes, f32 and f64: one sample, fewer samples
  than a batch, one past a tile, three tiles and a ragged batch, and
  calls split inside a batch that carry the state.
"""
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.models import dither as jd
from convopeq_tpu.models import learner as jl
from convopeq_tpu_torch import convert
from convopeq_tpu_torch.models import dither as td
from convopeq_tpu_torch.models import learner as tl
from convopeq_tpu_torch.ops import quantize_kernels as qk
from convopeq_tpu_torch.ops.dispatch import reset_launches

ROOT = Path(__file__).resolve().parent.parent
VECTORS = ROOT / "tests" / "ref_harness" / "vectors"
H = td.K_OUTPUT_HEADROOM
K_TEST = np.clip(np.random.default_rng(71).normal(size=9) * 0.15, -0.85,
                 0.85)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shapers(mode):
    """(JAX shaper, port shaper) for a mode, each f(x, u, bits, state)."""
    sr = 48000.0
    if mode == "fixed4":
        c = jd.fixed4_coeffs(sr)
        return (lambda x, u, b, s: jd.fixed_shaper_dither(
                    x, u, c, b, state=s, return_state=True),
                lambda x, u, b, s: td.fixed_shaper_dither(
                    x, u, c, b, state=s, return_state=True))
    if mode == "fixed15":
        c = jd.fixed15_coeffs(sr)
        return (lambda x, u, b, s: jd.fixed_shaper_dither(
                    x, u, c, b, range_clamp=True, state=s,
                    return_state=True),
                lambda x, u, b, s: td.fixed_shaper_dither(
                    x, u, c, b, range_clamp=True, state=s,
                    return_state=True))
    if mode == "psycho":
        return (lambda x, u, b, s: jd.psycho_dither(
                    x, u, sr, b, state=s, return_state=True),
                lambda x, u, b, s: td.psycho_dither(
                    x, u, sr, b, state=s, return_state=True))
    ladder = {"lattice": "reference", "lattice_fir": "fir"}[mode]
    return (lambda x, u, b, s: jd.lattice_dither(
                x, u, K_TEST, b, state=s, return_state=True, ladder=ladder),
            lambda x, u, b, s: td.lattice_dither(
                x, u, K_TEST, b, state=s, return_state=True, ladder=ladder))


ORDERS = {"psycho": 12, "fixed4": 4, "fixed15": 16, "lattice": 9,
          "lattice_fir": 9}


def _run_both(mode, x, u, bits, s0=None):
    jf, tf = _shapers(mode)
    qj, sj = jf(jnp.asarray(x), jnp.asarray(u), bits,
                None if s0 is None else jnp.asarray(s0))
    qt, st = tf(_t(x), _t(u), bits, None if s0 is None else _t(s0))
    return np.asarray(qj), np.asarray(sj), qt.numpy(), st.numpy()


# ------------------------------------------------------- tables and RNGs

@pytest.mark.parametrize("sr", [44100.0, 48000.0, 50000.0, 96000.0,
                                200000.0, 384000.0, 800000.0])
def test_tables_and_coefficients_equal_jax(sr):
    for name in ("PSYCHO_COEFF_TABLE", "FIXED4_PRESET_RATES",
                 "FIXED4_PRESETS", "FIXED15_DEFAULT", "FIXED15_PRESETS"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    for name in ("PSYCHOACOUSTIC", "FIXED4", "FIXED15", "ADAPTIVE9",
                 "NS_ORDER_PSYCHO", "NS_ORDER_FIXED4", "NS_ORDER_FIXED15",
                 "NS_ORDER_LATTICE", "LATTICE_COEFF_LIMIT",
                 "LATTICE_STATE_LIMIT", "ERROR_CLAMP_FACTOR"):
        assert getattr(td, name) == getattr(jd, name)
    assert td.psycho_sr_band(sr) == jd.psycho_sr_band(sr)
    for bits in (16, 20, 24, 32):
        np.testing.assert_array_equal(td.psycho_coeffs(sr, bits),
                                      jd.psycho_coeffs(sr, bits))
        assert td.quant_scales(bits) == jd.quant_scales(bits)
    np.testing.assert_array_equal(td.fixed4_coeffs(sr), jd.fixed4_coeffs(sr))
    np.testing.assert_array_equal(td.fixed15_coeffs(sr),
                                  jd.fixed15_coeffs(sr))


def test_rngs_equal_jax():
    for ch in (0, 1, 2):
        np.testing.assert_array_equal(td.xoshiro_uniforms(3000, channel=ch),
                                      jd.xoshiro_uniforms(3000, channel=ch))
        for sr, bits in ((44100.0, 16), (384000.0, 24), (768000.0, 32)):
            seeds = td.fixed15_xoshiro_seeds(sr, bits, ch)
            assert seeds == jd.fixed15_xoshiro_seeds(sr, bits, ch)
            np.testing.assert_array_equal(
                td.xoshiro_uniforms(500, seeds=seeds),
                jd.xoshiro_uniforms(500, seeds=seeds))
        for seed in (0, 0xC0FFEE, 2 ** 64 - 1):
            np.testing.assert_array_equal(
                td.psycho_fallback_uniforms(3000, ch, seed),
                jd.psycho_fallback_uniforms(3000, ch, seed))
    for state in (0, 1, 0x9E3779B97F4A7C15, 2 ** 64 - 1):
        assert td._splitmix64(state) == jd._splitmix64(state)
    u = np.random.default_rng(3).random((4, 50, 2))
    np.testing.assert_array_equal(td.tpdf_from_uniforms(_t(u)).numpy(),
                                  np.asarray(jd.tpdf_from_uniforms(
                                      jnp.asarray(u))))


def test_learned_banks_equal_jax():
    with open(ROOT / "convopeq_tpu" / "data" / "learned_banks.json") as f:
        jbanks = jl.AdaptiveCoefficientBanks.from_dict(json.load(f)["banks"])
    ours = tl.factory_banks()
    carried = convert.banks_from_dict(jbanks.to_dict())
    assert len(ours) == len(jbanks) == len(carried)
    for sr in tl.BANK_SAMPLE_RATES + [50000.0, 400000.0]:
        for bits in (16, 24, 32):
            for mode in range(-1, tl.BANK_MODES + 1):
                assert tl.coefficient_bank_index(sr, bits, mode) == \
                    jl.coefficient_bank_index(sr, bits, mode)
                want = jbanks.get(sr, bits, mode)
                for b in (ours, carried):
                    got = b.get(sr, bits, mode)
                    assert (got is None) == (want is None)
                    if want is not None:
                        np.testing.assert_array_equal(got, want)
    assert ours.to_dict() == jbanks.to_dict()
    assert ours.get(384000.0, 24, 5) is not None


# ------------------------------------------------ the reference binary

def _vector_cases():
    cases = []
    for side in ("l", "r"):
        cases += [("shapers", f"fixed4_{b}bit_{side}") for b in (16, 24)]
        cases += [("shapers", f"fixed15_16bit_{side}"),
                  ("shapers", f"lattice_16bit_{side}")]
        cases += [("psycho", f"psycho_{k}k_{b}bit_{side}")
                  for k, b in ((48, 16), (48, 24), (384, 24))]
    return cases


@pytest.mark.parametrize("file,key", _vector_cases())
def test_plain_shapers_reproduce_reference_binary(file, key):
    v = json.loads((VECTORS / f"{file}.json").read_text())
    kind, bits_s, side = key.rsplit("_", 2)
    if kind.startswith("psycho"):
        kind, khz = kind.split("_")
        sr = float(khz[:-1]) * 1000.0
    else:
        sr = float(v["sample_rate"])
    bits, ch = int(bits_s[:-3]), "lr".index(side)
    x = np.asarray(v[f"input_{side}"])
    n = len(x)
    h = v["headroom"]
    if kind == "psycho":
        u = td.psycho_fallback_uniforms(2 * n, ch, v["seed"]).reshape(n, 2)
        q = td.psycho_dither(_t(x), _t(u), sr, bits, headroom=h)
    elif kind == "fixed15":
        u = td.xoshiro_uniforms(2 * n, seeds=td.fixed15_xoshiro_seeds(
            sr, bits, ch)).reshape(n, 2)
        q = td.fixed_shaper_dither(_t(x), _t(u), td.fixed15_coeffs(sr), bits,
                                   headroom=h, range_clamp=True)
    else:
        u = td.xoshiro_uniforms(2 * n, channel=ch).reshape(n, 2)
        if kind == "fixed4":
            q = td.fixed_shaper_dither(_t(x), _t(u), td.fixed4_coeffs(sr),
                                       bits, headroom=h)
        else:
            k = [0.2, -0.15, 0.1, -0.08, 0.06, -0.04, 0.03, -0.02, 0.01]
            q = td.lattice_dither(_t(x), _t(u), k, bits, headroom=h,
                                  ladder="reference")
    np.testing.assert_array_equal(q.numpy(), np.asarray(v[key]))


# ------------------------------------------------ the JAX lax.scan shapers

@pytest.mark.parametrize("mode", ["fixed4", "fixed15", "lattice",
                                  "lattice_fir"])
def test_plain_shapers_match_jax_scan_f64(mode):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 700)) * 0.4
    u = rng.random(size=(3, 700, 2))
    for bits in (16, 24):
        qj, sj, qt, st = _run_both(mode, x, u, bits)
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_allclose(st, sj, rtol=0, atol=16 * 2.0 ** -52)
    # the states bit for bit, with nothing contracted on either side
    xw, uw = x[:, :24], u[:, :24]
    s0 = (rng.random(size=(3, ORDERS[mode])) * 2 - 1) * 2 * 2.0 ** -15
    with jax.disable_jit():
        qj, sj, qt, st = _run_both(mode, xw, uw, 16, s0)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)


def test_psycho_matches_jax_scan_f64():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 700)) * 0.4
    u = rng.random(size=(3, 700, 2))
    for sr, bits in ((48000.0, 16), (384000.0, 24)):
        jq = np.asarray(jd.psycho_dither(jnp.asarray(x), jnp.asarray(u), sr,
                                         bits))
        tq = td.psycho_dither(_t(x), _t(u), sr, bits).numpy()
        np.testing.assert_array_equal(tq[:, :32], jq[:, :32])
        grid = tq * 2.0 ** (bits - 1)
        np.testing.assert_array_equal(grid, np.round(grid))
    s0 = rng.normal(size=(3, 12)) * 2.0 ** -16
    with jax.disable_jit():
        qj, sj, qt, st = _run_both("psycho", x[:, :24], u[:, :24], 16, s0)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("mode", ["psycho", "fixed4", "fixed15", "lattice",
                                  "lattice_fir"])
def test_single_step_f32_matches_jax(mode):
    rng = np.random.default_rng(71)
    b = 4096
    xb = (rng.normal(size=(b, 1)) * 0.6).astype(np.float32)
    ub = rng.random(size=(b, 1, 2)).astype(np.float32)
    spread = np.linspace(0.1, 2.5, b)[:, None]
    if mode.startswith("lattice"):          # reaches the +-2 state clamps
        s0 = rng.normal(size=(b, 9)) * spread
    else:                                   # errors up to past +-2 LSB
        s0 = rng.normal(size=(b, ORDERS[mode])) * spread * 2.0 ** -15
    with jax.disable_jit():
        qj, sj, qt, st = _run_both(mode, xb, ub, 16, s0.astype(np.float32))
    assert qt.dtype == st.dtype == np.float32
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)


def test_fixed4_f32_full_sequence_bounded_against_jax():
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(3, 700)) * 0.4).astype(np.float32)
    u = rng.random(size=(3, 700, 2)).astype(np.float32)
    for bits in (16, 24):
        qj, _sj, qt, _st = _run_both("fixed4", x, u, bits)
        lsb = 2.0 ** (bits - 1)
        grid = qt.astype(np.float64) * lsb
        np.testing.assert_array_equal(grid, np.round(grid))
        assert np.abs(qt.astype(np.float64) - qj).max() * lsb <= 4.0


# ------------------------------------------------------------ apply_dither

@pytest.mark.parametrize("shaper", ["FIXED4", "FIXED15", "ADAPTIVE9",
                                    "PSYCHOACOUSTIC"])
def test_apply_dither_cpu_matches_jax_f64(shaper):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 2, 600)) * 0.3
    u = rng.random(size=(2, 2, 600, 2))
    st = getattr(td, shaper)
    for sr, bits in ((48000.0, 16), (384000.0, 24)):
        jq = np.asarray(jd.apply_dither(jnp.asarray(x), st, sr, bits,
                                        uniforms=jnp.asarray(u),
                                        adaptive_coeffs=K_TEST))
        tq = td.apply_dither(_t(x), st, sr, bits, uniforms=_t(u),
                             adaptive_coeffs=K_TEST).numpy()
        assert tq.shape == x.shape
        if shaper == "PSYCHOACOUSTIC":
            np.testing.assert_array_equal(tq[..., :32], jq[..., :32])
            grid = tq * 2.0 ** (bits - 1)
            np.testing.assert_array_equal(grid, np.round(grid))
        else:
            np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(
        td.apply_dither(_t(x), st, 48000.0, 0).numpy(), x * H)


@pytest.mark.parametrize("shaper", ["PSYCHOACOUSTIC", "FIXED4", "FIXED15",
                                    "ADAPTIVE9"])
def test_apply_dither_carries_its_state_across_blocks(shaper):
    rng = np.random.default_rng(10)
    x = _t(rng.normal(size=(3, 2, 300)) * 0.3)
    u = _t(rng.random(size=(3, 2, 300, 2)))
    st = getattr(td, shaper)
    kw = dict(adaptive_coeffs=K_TEST, return_state=True)
    q, s = td.apply_dither(x, st, 96000.0, 24, uniforms=u, **kw)
    s0 = td.dither_state_init((3, 2), st, device="cpu")
    assert s0.shape == s.shape == jd.dither_state_init((3, 2), st).shape
    q1, s1 = td.apply_dither(x[..., :130], st, 96000.0, 24,
                             uniforms=u[..., :130, :], state=s0, **kw)
    q2, s2 = td.apply_dither(x[..., 130:], st, 96000.0, 24,
                             uniforms=u[..., 130:, :], state=s1, **kw)
    assert torch.equal(torch.cat([q1, q2], dim=-1), q)
    assert torch.equal(s2, s)


def test_apply_dither_draws_uniforms_from_a_generator():
    x = torch.zeros((2, 64), dtype=torch.float64)
    q1 = td.apply_dither(x, td.ADAPTIVE9, 48000.0, 16,
                         generator=torch.Generator().manual_seed(3))
    q2 = td.apply_dither(x, td.ADAPTIVE9, 48000.0, 16,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(q1, q2) and q1.abs().max() > 0


def test_quantizer_wrapper_on_cpu_is_plain_and_checks_its_arguments():
    rng = np.random.default_rng(11)
    x = _t(rng.normal(size=(4, 70)) * 0.3)
    u = _t(rng.random(size=(4, 70, 2)))
    reset_launches()
    q, s = qk.error_feedback_quantize(x, u, K_TEST, 2.0 ** -15, H,
                                      "lattice_fir")
    qp, sp = qk.error_feedback_quantize_plain(x, u, K_TEST, 2.0 ** -15, H,
                                              "lattice_fir")
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert qk.launch_counts == {"error_feedback_quantize": 0}
    with pytest.raises(ValueError):
        qk.error_feedback_quantize(x, u, K_TEST[:4], 2.0 ** -15, H, "lattice")
    with pytest.raises(ValueError):
        qk.error_feedback_quantize(x, u, K_TEST, 2.0 ** -15, H, "nope")
    with pytest.raises(ValueError):
        qk.error_feedback_quantize(x, u[:, :10], K_TEST, 2.0 ** -15, H,
                                   "lattice_fir")
    with pytest.raises(ValueError):
        td.lattice_dither(x, u, K_TEST, 16, ladder="textbook")
    with pytest.raises(RuntimeError):
        td.dither_state_init((2,), td.FIXED4)      # the card, by default


# ------------------------------------------------ the CUDA source, emulated

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/error_feedback_quantize.cu's arithmetic built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    out = tmp_path_factory.mktemp("emu") / "libquantize_emu.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out),
                    str(ROOT / "tests" / "quantize_host_emulation.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P_, I_, D_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    args = [P_, P_, P_, P_, P_, I_, I_, I_, ctypes.POINTER(D_), I_, D_, D_]
    lib.emu_quantize_f32.argtypes = args
    lib.emu_quantize_f64.argtypes = args
    lib.emu_supported.argtypes = [I_, I_]
    lib.emu_tile.argtypes = [I_]
    return lib


def _emulate(lib, x, u, c, scale, mode, s0):
    q = torch.empty_like(x)
    s = torch.empty_like(s0)
    fn = lib.emu_quantize_f32 if x.dtype == torch.float32 \
        else lib.emu_quantize_f64
    carr = (ctypes.c_double * len(c))(*[float(v) for v in c])
    rc = fn(x.data_ptr(), u.data_ptr(), s0.data_ptr(), q.data_ptr(),
            s.data_ptr(), x.shape[0], x.shape[1], qk.MODES[mode], carr,
            len(c), scale, H)
    assert rc == 0
    return q, s


_EMU_COEFFS = {"psycho": td.psycho_coeffs(384000.0, 24),
               "fixed": td.fixed4_coeffs(96000.0),
               "fixed15": td.fixed15_coeffs(96000.0),
               "lattice": td.lattice_coeffs(K_TEST),
               "lattice_fir": td.lattice_coeffs(K_TEST)}


def _emulated_against_plain(lib, mode, dtype, n, cut, seed):
    """The emulated kernel on (3, n) against the plain version at 16 and
    24 bits, whole and split at `cut` (the split carrying the state)."""
    rng = np.random.default_rng(seed)
    c = _EMU_COEFFS[mode]
    x = _t(rng.normal(size=(3, n)) * 0.4).to(dtype)
    u = _t(rng.random(size=(3, n, 2))).to(dtype)
    for bits in (16, 24):
        scale = 2.0 ** -(bits - 1)
        s0 = _t((rng.random(size=(3, len(c))) * 2 - 1) * 2 * scale).to(dtype)
        q, s = _emulate(lib, x, u, c, scale, mode, s0)
        qp, sp = qk.error_feedback_quantize_plain(x, u, c, scale, H, mode, s0)
        assert torch.equal(q, qp) and torch.equal(s, sp)
        if not 0 < cut < n:
            continue
        q1, s1 = _emulate(lib, x[:, :cut].contiguous(),
                          u[:, :cut].contiguous(), c, scale, mode, s0)
        q2, s2 = _emulate(lib, x[:, cut:].contiguous(),
                          u[:, cut:].contiguous(), c, scale, mode, s1)
        assert torch.equal(torch.cat([q1, q2], dim=1), q)
        assert torch.equal(s2, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", list(qk.MODES))
def test_cuda_source_quantizer_emulated(emulated, mode, dtype):
    tile = emulated.emu_tile(dtype.itemsize)
    batch = emulated.emu_batch()
    # three tiles, then a ragged tile that ends in a ragged batch; split
    # inside a batch of the second tile
    _emulated_against_plain(emulated, mode, dtype, 3 * tile + 2 * batch + 3,
                            tile + batch + 1, qk.MODES[mode])


@pytest.mark.parametrize("edge", ["one sample", "below a batch",
                                  "one past a tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", list(qk.MODES))
def test_cuda_source_quantizer_emulated_edges(emulated, mode, dtype, edge):
    tile = emulated.emu_tile(dtype.itemsize)
    batch = emulated.emu_batch()
    n, cut = {"one sample": (1, 0), "below a batch": (batch - 1, 1),
              "one past a tile": (tile + 1, tile - batch + 2)}[edge]
    _emulated_against_plain(emulated, mode, dtype, n, cut,
                            10 + qk.MODES[mode])


def test_cuda_source_rejects_unsupported_modes_emulated(emulated):
    for mode, orders in qk.ORDERS.items():
        for order in range(1, 18):
            assert emulated.emu_supported(qk.MODES[mode], order) == \
                (order in orders)
    assert emulated.emu_supported(7, 9) == 0
