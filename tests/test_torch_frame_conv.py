"""The frame kernels of convopeq_tpu_torch on the CPU.

- The plain versions against the JAX Pallas kernels in interpret mode
  (bf16x3 dots: atol 6e-5 x scale for the transforms, 2e-5 x max for the
  MAC, as tests/test_pallas.py), and in f64 against jnp.fft at 1e-12.
- uniform_partitioned_conv, torch f64 against JAX f64.
- The CUDA source itself, compiled for the host by
  tests/frame_conv_host_emulation.cpp (every thread of a block a
  coroutine), against the plain versions: the f32 kernels at 2e-5 x max,
  the f64 kernels at 1e-12 x max against numpy f64 (the packed forward
  bin by bin; the packed forward and inverse each in a scratch of
  exactly C*K*p values with a guard past it), and osa_rfft as the f32
  forward, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.ops import pallas_gemm_fft as pg
from convopeq_tpu.ops import partitioned_conv as j_pc
from convopeq_tpu_torch.ops import frame_conv_kernels as fk
from convopeq_tpu_torch.ops import partitioned_conv as t_pc

import frame_conv_emulation as emu


def _frames(rng, C, K, p, dtype=np.float32):
    return rng.normal(size=(C, K, p)).astype(dtype)


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)


@pytest.mark.parametrize("p", [512, 2048])
@pytest.mark.parametrize("C,K", [(1, 5), (2, 11)])
def test_frames_rfft_plain_matches_pallas(p, C, K):
    rng = np.random.default_rng(p + K)
    fr = _frames(rng, C, K, p)
    Xr, Xi = pg.rfft_frames_two_stage_pallas(jnp.asarray(fr), p,
                                             interpret=True)
    ref = np.asarray(Xr)[..., :p + 1] + 1j * np.asarray(Xi)[..., :p + 1]
    X = fk.frames_rfft_plain(torch.from_numpy(fr)).numpy()
    assert X.shape == (C, K, p + 1) and X.dtype == np.complex64
    np.testing.assert_allclose(X, ref, rtol=0, atol=6e-5 * np.abs(ref).max())


@pytest.mark.parametrize("p", [512, 2048])
@pytest.mark.parametrize("C,K,P", [(1, 5, 9), (2, 11, 4)])
def test_causal_mac_plain_matches_pallas(p, C, K, P):
    rng = np.random.default_rng(p + 7 * K + P)
    X = _cplx(rng, (C, K, p + 1))
    H = _cplx(rng, (P, p + 1))
    _n1, _k2, g = pg.grid_bins(p)
    grid = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, g - p - 1)])
    Yr, Yi = pg.causal_mac_grid_pallas(
        jnp.asarray(grid(X.real)), jnp.asarray(grid(X.imag)),
        jnp.asarray(grid(H.real)), jnp.asarray(grid(H.imag)), p,
        interpret=True)
    ref = np.asarray(Yr)[..., :p + 1] + 1j * np.asarray(Yi)[..., :p + 1]
    Y = fk.causal_mac_plain(torch.from_numpy(X), torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(Y, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("p", [512, 2048])
@pytest.mark.parametrize("C,K", [(2, 3)])
def test_irfft_valid_plain_matches_pallas(p, C, K):
    rng = np.random.default_rng(p + 3 * K)
    S = np.fft.rfft(rng.normal(size=(C, K, 2 * p)), axis=-1).astype(
        np.complex64)
    _n1, _k2, g = pg.grid_bins(p)
    pad = [(0, 0), (0, 0), (0, g - p - 1)]
    ref = np.asarray(pg.irfft_valid_two_stage_pallas(
        jnp.asarray(np.pad(S.real, pad)), jnp.asarray(np.pad(S.imag, pad)),
        p, interpret=True))
    y = fk.irfft_valid_plain(torch.from_numpy(S)).numpy()
    assert y.shape == (C, K, p)
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=6e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("p", [512, 2048])
def test_plain_versions_f64_match_jnp_fft(p):
    rng = np.random.default_rng(p)
    C, K, P = 2, 6, 9
    fr = _frames(rng, C, K, p, np.float64)
    prev = np.concatenate([np.zeros((C, 1, p)), fr[:, :-1]], axis=1)
    X_ref = np.array(jnp.fft.rfft(jnp.asarray(
        np.concatenate([prev, fr], axis=-1)), axis=-1))
    X = fk.frames_rfft_plain(torch.from_numpy(fr)).numpy()
    np.testing.assert_allclose(X, X_ref, rtol=0,
                               atol=1e-12 * np.abs(X_ref).max())
    H = _cplx(rng, (P, p + 1), np.complex128)
    Y_ref = np.array(j_pc._causal_frame_mac_fft(jnp.asarray(X_ref),
                                                  jnp.asarray(H)))
    Y = fk.causal_mac_plain(torch.from_numpy(X_ref),
                            torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(Y, Y_ref, rtol=0,
                               atol=1e-12 * np.abs(Y_ref).max())
    y_ref = np.asarray(jnp.fft.irfft(jnp.asarray(Y_ref), n=2 * p,
                                     axis=-1))[..., p:]
    y = fk.irfft_valid_plain(torch.from_numpy(Y_ref)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-12 * np.abs(y_ref).max())


def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(2)
    fr = torch.from_numpy(_frames(rng, 2, 4, 512))
    H = torch.from_numpy(_cplx(rng, (3, 513)))
    fk.reset_launch_counts()
    X = fk.frames_rfft(fr)
    Y = fk.causal_mac(X, H)
    y = fk.irfft_valid(Y)
    assert torch.equal(X, fk.frames_rfft_plain(fr))
    assert torch.equal(Y, fk.causal_mac_plain(X, H))
    assert torch.equal(y, fk.irfft_valid_plain(Y))
    fr64, H128 = fr.double(), H.to(torch.complex128)
    X64 = fk.frames_rfft(fr64)
    assert X64.dtype == torch.complex128
    assert torch.equal(fk.causal_mac(X64, H128),
                       fk.causal_mac_plain(X64, H128))
    assert fk.irfft_valid(X64).dtype == torch.float64
    osa = torch.cat([torch.zeros_like(fr[:, :1]), fr[:, :-1]], dim=1)
    osa = torch.cat([osa, fr], dim=-1)
    assert torch.equal(fk.osa_rfft(osa), fk.osa_rfft_plain(osa))
    assert set(fk.launch_counts) == {*fk.F32_KERNELS, *fk.F64_KERNELS,
                                     "osa_rfft"}
    assert all(v == 0 for v in fk.launch_counts.values())


@pytest.mark.parametrize("dtype,rel", [(np.complex64, 2e-5),
                                       (np.complex128, 1e-12)])
@pytest.mark.parametrize("C,K,P,B", [(3, 20, 6, 17), (2, 4, 9, 33),
                                     (1, 7, 1, 5)])
def test_chip_smoke_mac_library_is_causal_mac(dtype, rel, C, K, P, B):
    """chip_smoke's library yardstick for the MAC rows (a grouped complex
    conv1d), K < P included, against the plain version."""
    import chip_smoke
    rng = np.random.default_rng(C * K * P + B)
    X = torch.from_numpy(_cplx(rng, (C, K, B), dtype))
    H = torch.from_numpy(_cplx(rng, (P, B), dtype))
    Y = chip_smoke.mac_library(X, H)
    ref = fk.causal_mac_plain(X, H)
    assert Y.shape == ref.shape and Y.dtype == ref.dtype
    assert float((Y - ref).abs().max()) <= rel * float(ref.abs().max())


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


@pytest.mark.parametrize("p,n,taps", [(1024, 9999, 11 * 1024 + 7),
                                      (512, 700, 9 * 512)])
def test_uniform_partitioned_conv_f64_matches_jax(p, n, taps):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, 3, n))
    h = rng.normal(size=taps) * np.exp(-np.arange(taps) / (taps / 4))
    Hj = j_pc.partition_spectra(jnp.asarray(h), p, dtype=jnp.float64)
    yj = np.asarray(j_pc.uniform_partitioned_conv(jnp.asarray(x), Hj, p))
    Ht = t_pc.partition_spectra(h, p, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(Hj)).max())
    for frame_mac in ("auto", "plain"):
        yt = t_pc.uniform_partitioned_conv(torch.from_numpy(x), Ht, p,
                                           frame_mac).numpy()
        assert yt.shape == x.shape
        assert _rel_rms(yt, yj) <= 1e-12


# ------------------------------------------------ the CUDA source, emulated

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emu.build(tmp_path_factory)


def _check_bins(X, ref, rel):
    """Every bin of X (..., p+1) within rel x max|ref| of ref; a failure
    names the bins off, and DC, k = p/2 and Nyquist always."""
    p = ref.shape[-1] - 1
    err = np.abs(np.asarray(X) - ref).reshape(-1, p + 1).max(axis=0)
    tol = rel * np.abs(ref).max()
    bad = np.flatnonzero(err > tol)
    assert bad.size == 0, (
        f"{bad.size} of {p + 1} bins off by more than {tol:.3e}: "
        + ", ".join(f"k = {k} {err[k]:.3e}" for k in bad[:8])
        + f"; DC {err[0]:.3e}, k = p/2 {err[p // 2]:.3e}, "
        f"Nyquist {err[p]:.3e}")


def _irfft_valid_np(Y):
    """numpy's f64 valid half of irfft(Y, 2p), DC's and Nyquist's
    imaginary parts dropped."""
    p = Y.shape[-1] - 1
    Yz = Y.astype(np.complex128)
    Yz[..., 0] = Yz[..., 0].real
    Yz[..., p] = Yz[..., p].real
    return np.fft.irfft(Yz, n=2 * p, axis=-1)[..., p:]


def _check_inverse(emulated, entry, Y, rel):
    """The packed inverse `entry` on Y (C, K, p+1) in a scratch of exactly
    C*K*p values with a guard past it, against numpy's f64 irfft within
    rel x max."""
    C, K, p = Y.shape[0], Y.shape[1], Y.shape[2] - 1
    Yt = torch.from_numpy(Y)
    n = C * K * p
    scratch = emu.guarded_scratch(n, Yt.dtype)
    y = torch.empty((C, K, p), dtype=fk._REAL_OF[Yt.dtype])
    assert getattr(emulated, entry)(Yt.data_ptr(), scratch.data_ptr(),
                                    y.data_ptr(), C, K, p, None) == 0
    assert emu.guard_intact(scratch, n)
    ref = _irfft_valid_np(Y)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("p,C,K", [(512, 2, 3), (2048, 1, 5), (4096, 1, 3),
                                   (512, 1, 1), (65536, 1, 2), (1024, 3, 2),
                                   (16384, 1, 3)])
def test_cuda_source_transforms_emulated(emulated, p, C, K):
    """The packed forward and the packed inverse, each in a scratch of
    C*K*p values with a guard past it, against numpy's f64 rfft (every
    bin) and irfft; the inverse of random spectra and of real frames'."""
    rng = np.random.default_rng(p + C)
    fr = torch.from_numpy(_frames(rng, C, K, p))
    X = torch.empty((C, K, p + 1), dtype=torch.complex64)
    n = C * K * p
    scratch = emu.guarded_scratch(n, torch.complex64)
    assert emulated.frames_rfft_f32(fr.data_ptr(), scratch.data_ptr(),
                                    X.data_ptr(), C, K, p, None) == 0
    assert emu.guard_intact(scratch, n)
    _check_bins(X.numpy(), np.fft.rfft(_osa_np(fr.double().numpy()),
                                       axis=-1), 2e-5)
    _check_inverse(emulated, "irfft_valid_f32", _cplx(rng, (C, K, p + 1)),
                   2e-5)
    _check_inverse(emulated, "irfft_valid_f32",
                   np.fft.rfft(_osa_np(fr.double().numpy()),
                               axis=-1).astype(np.complex64), 2e-5)


# the MAC's edges: K not a multiple of its 8-frame tile, K < P, P = 1, C
# not a multiple of the channels a block takes (3 of 4, 5 of 8), B not a
# multiple of its 32 bins, ring wraps within a tile (P - 1 < 8) and
# across tiles, and the largest P of each type
MAC_EDGES = [(3, 21, 12, 70), (2, 5, 12, 40), (2, 9, 1, 33),
             (2, 70, 12, 45), (5, 30, 17, 45)]


@pytest.mark.parametrize("C,K,P,B", [(2, 11, 4, 513), (1, 5, 9, 1025),
                                     (3, 40, 33, 300), (1, 3, 200, 77),
                                     *MAC_EDGES, (1, 12, 454, 40)])
def test_cuda_source_mac_emulated(emulated, C, K, P, B):
    rng = np.random.default_rng(K * P)
    X = torch.from_numpy(_cplx(rng, (C, K, B)))
    H = torch.from_numpy(_cplx(rng, (P, B)))
    Y = torch.empty_like(X)
    assert emulated.causal_mac_c64(X.data_ptr(), H.data_ptr(), Y.data_ptr(),
                                   C, K, B, P, None) == 0
    ref = fk.causal_mac_plain(X.to(torch.complex128), H.to(torch.complex128))
    assert float((Y - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


def test_cuda_source_rejects_unsupported_shapes_emulated(emulated):
    # channels (warps) a MAC block: H and a ring column a bin and channel,
    # (P + G (P - 1)) x 32 values, the G of the most warps an SM
    assert emulated.frame_conv_mac_block(8, 33) == 8  # 3 blocks by smem
    assert emulated.frame_conv_mac_block(16, 64) == 8
    assert emulated.frame_conv_mac_block(3, 33) == 4       # covers C = 3
    assert emulated.frame_conv_mac_block(1, 33) == 1
    assert emulated.frame_conv_mac_block(1, 454) == 1
    assert emulated.frame_conv_mac_block(8, 454) == 1
    assert emulated.frame_conv_mac_block(1, 455) == 0
    assert emulated.frame_conv_mac_block(1, 0) == 0
    # complex128: 16 B a value, so a block of G channels takes half the P
    assert emulated.frame_conv_mac_block_c128(8, 33) == 8
    assert emulated.frame_conv_mac_block_c128(16, 64) == 4  # 4 warps an SM
    assert emulated.frame_conv_mac_block_c128(1, 227) == 1
    assert emulated.frame_conv_mac_block_c128(1, 228) == 0
    for p in (256, 1000, 131072):
        for name in ("frames_rfft_f32", "frames_rfft_f64", "osa_rfft_f32",
                     "irfft_valid_f32", "irfft_valid_f64"):
            assert getattr(emulated, name)(None, None, None, 1, 1, p,
                                           None) == -1
    assert emulated.causal_mac_c128(None, None, None, 1, 1, 1, 228,
                                    None) == -1


def _osa_np(fr):
    prev = np.concatenate([np.zeros_like(fr[:, :1]), fr[:, :-1]], axis=1)
    return np.concatenate([prev, fr], axis=-1)


@pytest.mark.parametrize("p,C,K", [(512, 2, 3), (2048, 1, 5), (4096, 1, 3),
                                   (2048, 1, 1), (65536, 1, 2)])
def test_cuda_source_f64_transforms_emulated(emulated, p, C, K):
    rng = np.random.default_rng(p + 5 * C)
    fr = _frames(rng, C, K, p, np.float64)
    X = torch.empty((C, K, p + 1), dtype=torch.complex128)
    n = C * K * p
    scratch = emu.guarded_scratch(n, torch.complex128)
    frt = torch.from_numpy(fr)
    assert emulated.frames_rfft_f64(frt.data_ptr(), scratch.data_ptr(),
                                    X.data_ptr(), C, K, p, None) == 0
    assert emu.guard_intact(scratch, n)
    _check_bins(X.numpy(), np.fft.rfft(_osa_np(fr), axis=-1), 1e-12)
    _check_inverse(emulated, "irfft_valid_f64",
                   _cplx(rng, (C, K, p + 1), np.complex128), 1e-12)
    _check_inverse(emulated, "irfft_valid_f64",
                   np.fft.rfft(_osa_np(fr), axis=-1), 1e-12)


@pytest.mark.parametrize("C,K,P,B", [(2, 11, 4, 513), (1, 9, 64, 300),
                                     (1, 3, 200, 77), (3, 21, 64, 70),
                                     *MAC_EDGES, (1, 12, 227, 40)])
def test_cuda_source_f64_mac_emulated(emulated, C, K, P, B):
    rng = np.random.default_rng(K * P + 1)
    X = _cplx(rng, (C, K, B), np.complex128)
    H = _cplx(rng, (P, B), np.complex128)
    Xt, Ht = torch.from_numpy(X), torch.from_numpy(H)
    Y = torch.empty_like(Xt)
    assert emulated.causal_mac_c128(Xt.data_ptr(), Ht.data_ptr(),
                                    Y.data_ptr(), C, K, B, P, None) == 0
    ref = np.zeros_like(X)
    for f in range(K):
        for j in range(min(P, f + 1)):
            ref[:, f] += X[:, f - j] * H[j]
    np.testing.assert_allclose(Y.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("p,C,K", [(512, 2, 3), (4096, 1, 3), (2048, 1, 1),
                                   (65536, 1, 2)])
def test_cuda_source_osa_rfft_emulated(emulated, p, C, K):
    """osa_rfft of materialized frames: the f32 forward's transform, so
    equal to frames_rfft_f32 on the frames they were built from."""
    rng = np.random.default_rng(p + K)
    fr = _frames(rng, C, K, p)
    osa = torch.from_numpy(_osa_np(fr))
    X = torch.empty((C, K, p + 1), dtype=torch.complex64)
    Xf = torch.empty_like(X)
    n = C * K * p
    scratch = emu.guarded_scratch(n, torch.complex64)
    assert emulated.osa_rfft_f32(osa.data_ptr(), scratch.data_ptr(),
                                 X.data_ptr(), C, K, p, None) == 0
    assert emu.guard_intact(scratch, n)
    _check_bins(X.numpy(), np.fft.rfft(osa.double().numpy(), axis=-1), 2e-5)
    frt = torch.from_numpy(fr)
    assert emulated.frames_rfft_f32(frt.data_ptr(), scratch.data_ptr(),
                                    Xf.data_ptr(), C, K, p, None) == 0
    assert torch.equal(X, Xf)
