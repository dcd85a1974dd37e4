"""The fused P <= 8 convolution of convopeq_tpu_torch on the CPU.

- The plain version against the JAX Pallas kernel
  (`fused_conv_frames_pallas`) in interpret mode, at the (P, C, K) cases
  of tests/test_pallas.py::test_fused_conv_small_p_matches_reference and
  its tolerance (atol 1e-4 x scale, bf16x3 dots), and in f64 against a
  numpy linear convolution at 1e-12.
- The routing: a layer of P <= 8 partitions goes to the fused wrapper,
  a larger one to the frame kernels, "plain" to the plain steps.
- The CUDA source itself, compiled for the host by
  tests/frame_conv_host_emulation.cpp (every thread of a block a
  coroutine), against the plain version in f64: atol 2e-5 x scale, the
  bound the frame kernels' emulation is held to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.ops import pallas_gemm_fft as pg
from convopeq_tpu_torch.ops import frame_conv_kernels as fk
from convopeq_tpu_torch.ops import fused_conv_kernels as fc
from convopeq_tpu_torch.ops import partitioned_conv as t_pc

import frame_conv_emulation as emu


def _case(rng, P, C, K, p):
    """Frames (C, K, p) f32, a decaying IR of P partitions and its
    partition spectra (P, p+1) in f64."""
    x = rng.normal(size=(C, K * p)).astype(np.float32)
    ir = rng.normal(size=P * p) * np.exp(-np.arange(P * p) / (P * p / 4.0))
    hp = np.zeros((P, 2 * p))
    hp[:, :p] = ir.reshape(P, p)
    return x.reshape(C, K, p), ir, np.fft.rfft(hp, axis=-1)


@pytest.mark.parametrize("P,C,K", [(1, 1, 8), (3, 2, 16), (8, 2, 24),
                                   (5, 1, 11)])
def test_fused_conv_plain_matches_pallas(P, C, K):
    p = 1024
    frames, _ir, H = _case(np.random.default_rng(11 + P), P, C, K, p)
    Gr, Gi = pg.spectra_to_grid(jnp.asarray(H.real, jnp.float32),
                                jnp.asarray(H.imag, jnp.float32), p)
    ref = np.asarray(pg.fused_conv_frames_pallas(jnp.asarray(frames), Gr,
                                                 Gi, p, interpret=True))
    y = fc.fused_conv_plain(torch.from_numpy(frames),
                            torch.from_numpy(H.astype(np.complex64)))
    assert y.dtype == torch.float32 and y.shape == (C, K, p)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("P,C,K", [(1, 1, 3), (8, 2, 5), (5, 1, 11)])
def test_fused_conv_plain_f64_matches_numpy_convolution(P, C, K):
    p = 512
    frames, ir, H = _case(np.random.default_rng(P * K), P, C, K, p)
    x = frames.reshape(C, K * p).astype(np.float64)
    ref = np.stack([np.convolve(x[c], ir)[:K * p] for c in range(C)])
    y = fc.fused_conv_plain(torch.from_numpy(x.reshape(C, K, p)),
                            torch.from_numpy(H)).numpy().reshape(C, K * p)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_fused_conv_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    frames, _ir, H = _case(rng, 4, 2, 5, 512)
    fr = torch.from_numpy(frames)
    Hc = torch.from_numpy(H.astype(np.complex64))
    fc.reset_launch_counts()
    assert torch.equal(fc.fused_conv(fr, Hc), fc.fused_conv_plain(fr, Hc))
    assert fc.launch_counts == {"fused_conv": 0}


def test_fused_conv_gate():
    assert fc.fused_conv_supported(8192, 8)
    assert fc.fused_conv_supported(512, 1)
    assert fc.fused_conv_supported(65536, 5)
    for p, P in ((8192, 9), (8192, 0), (256, 4), (1000, 4), (131072, 2)):
        assert not fc.fused_conv_supported(p, P)


@pytest.mark.parametrize("P,expect_fused", [(8, True), (9, False)])
def test_partitioned_conv_routes_small_layers_to_fused(monkeypatch, P,
                                                       expect_fused):
    calls = []

    def spy(frames, H):
        calls.append(tuple(frames.shape))
        return fc.fused_conv_plain(frames, H)

    monkeypatch.setattr(t_pc, "fused_conv", spy)
    rng = np.random.default_rng(P)
    x = torch.from_numpy(rng.normal(size=(2, 3, 3000)))
    h = rng.normal(size=P * 512 - 100)
    ref = np.stack([np.convolve(r, h)[:3000]
                    for r in x.numpy().reshape(-1, 3000)]).reshape(2, 3, -1)
    # f32: P <= 8 layers take the fused kernel
    H32 = t_pc.partition_spectra(h, 512, dtype=torch.float32, device="cpu")
    y32 = t_pc.uniform_partitioned_conv(x.float(), H32, 512)
    assert calls == ([(6, 6, 512)] if expect_fused else [])
    np.testing.assert_allclose(y32.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())
    # f64: every layer takes the three frame kernels (no fused f64 kernel)
    calls.clear()
    H = t_pc.partition_spectra(h, 512, dtype=torch.float64, device="cpu")
    y = t_pc.uniform_partitioned_conv(x, H, 512)
    assert calls == []
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    calls.clear()
    y_plain = t_pc.uniform_partitioned_conv(x, H, 512, "plain")
    assert calls == []
    np.testing.assert_allclose(y_plain.numpy(), y.numpy(), rtol=0,
                               atol=1e-12 * np.abs(ref).max())


# ------------------------------------------------ the CUDA source, emulated

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emu.build(tmp_path_factory)


# K < P and ragged K included; C = 1 and C = 2; p = 16384 is fused2's
# near layer; at 32768 and 65536 the row pass takes 256 threads a block
@pytest.mark.parametrize("p,P,C,K", [(512, 1, 1, 3), (512, 5, 2, 3),
                                     (512, 8, 1, 11), (2048, 1, 2, 5),
                                     (2048, 5, 1, 13), (2048, 8, 2, 6),
                                     (4096, 3, 1, 4), (16384, 8, 1, 3),
                                     (1024, 8, 2, 5), (32768, 2, 2, 2),
                                     (65536, 8, 1, 3)])
def test_cuda_source_fused_conv_emulated(emulated, p, P, C, K):
    """The packed fused kernel in a scratch of exactly C*K*p values with a
    guard past it."""
    rng = np.random.default_rng(p + 10 * P + K)
    fr = torch.from_numpy(rng.normal(size=(C, K, p)).astype(np.float32))
    H = torch.from_numpy((rng.normal(size=(P, p + 1))
                          + 1j * rng.normal(size=(P, p + 1))).astype(
                              np.complex64))
    y = torch.empty((C, K, p), dtype=torch.float32)
    n = C * K * p
    scratch = emu.guarded_scratch(n, torch.complex64)
    assert emulated.fused_conv_f32(fr.data_ptr(), H.data_ptr(),
                                   scratch.data_ptr(), y.data_ptr(), C, K, p,
                                   P, None) == 0
    assert emu.guard_intact(scratch, n)
    ref = fc.fused_conv_plain(fr.double(), H.to(torch.complex128))
    assert float((y - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


def test_cuda_source_fused_conv_rejects_unsupported_shapes_emulated(emulated):
    for p, P in ((512, 0), (512, 9), (256, 1), (1000, 4), (131072, 2)):
        assert emulated.fused_conv_f32(None, None, None, None, 1, 1, p, P,
                                       None) == -1
    assert fk.MAX_PART == 65536 and fc.MAX_FUSED_PARTS == 8
