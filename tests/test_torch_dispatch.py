"""The kernel choice of `convopeq_tpu_torch.ops.dispatch`, on the CPU.

Tensors on the meta device stand in for the card's: a wrapper takes them
to its kernel, whose launch is patched here to record.
- Each of the seven kernel wrappers reaches its launch outside `plain()`
  and, inside it, calls its reference form (the table in the module's
  docstring) with no counter moving.
- The quantizer keeps its kernel under `plain()`.
- `launches()` has every key of the wrapper modules' `launch_counts`,
  and `reset_launches()` zeroes them all.
- Under `plain()` the staged chain with a soft clip runs
  `soft_clip_local2x_plain` and the IIR cascade's FFT form.
"""
import importlib
import pkgutil

import pytest
import torch

import convopeq_tpu_torch.ops as ops_pkg
from convopeq_tpu_torch.models import chain as t_chain
from convopeq_tpu_torch.ops import dispatch
from convopeq_tpu_torch.ops import frame_conv_kernels as fk
from convopeq_tpu_torch.ops import fused_conv_kernels as fc
from convopeq_tpu_torch.ops import iir_cascade as ic
from convopeq_tpu_torch.ops import quantize_kernels as qk
from convopeq_tpu_torch.ops import softclip as sc
from convopeq_tpu_torch.ops.dc_blocker import dc_blocker_alphas


class Launched(Exception):
    pass


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _reach(*_args, **_kw):
    raise Launched


# wrapper: (its module, the launch it reaches, its reference form, args)
CASES = {
    "frames_rfft": (fk, "load", "frames_rfft_plain",
                    lambda: (_meta(2, 4, 512),)),
    "osa_rfft": (fk, "load", "osa_rfft_plain", lambda: (_meta(2, 4, 1024),)),
    "causal_mac": (fk, "load", "causal_mac_plain",
                   lambda: (_meta(2, 4, 513, dtype=torch.complex64),
                            _meta(3, 513, dtype=torch.complex64))),
    "irfft_valid": (fk, "load", "irfft_valid_plain",
                    lambda: (_meta(2, 4, 513, dtype=torch.complex64),)),
    "fused_conv": (fc, "load", "fused_conv_plain",
                   lambda: (_meta(2, 4, 512),
                            _meta(3, 513, dtype=torch.complex64))),
    "soft_clip_local2x": (sc, "_launch", "soft_clip_local2x_plain",
                          lambda: (_meta(2, 2, 1000), 0.8, 0.2, 0.03)),
    "iir_cascade": (ic, "_launch", "iir_cascade_fft",
                    lambda: (_meta(2, 2, 1000),
                             (ic.dc_section(*dc_blocker_alphas(48000.0,
                                                               3.0)),))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_takes_its_reference_form_under_plain(monkeypatch, name):
    module, launch, reference, args = CASES[name]
    wrapper = getattr(module, name)
    seen = []
    monkeypatch.setattr(module, launch, _reach)
    monkeypatch.setattr(module, reference,
                        lambda *a: seen.append(a) or "reference")
    dispatch.reset_launches()
    with pytest.raises(Launched):
        wrapper(*args())
    assert seen == []
    with dispatch.plain():
        out = wrapper(*args())
    assert len(seen) == 1
    assert (out[0] if name == "iir_cascade" else out) == "reference"
    assert set(dispatch.launches().values()) == {0}
    with pytest.raises(Launched):               # plain() has ended
        wrapper(*args())


def test_quantizer_keeps_its_kernel_under_plain(monkeypatch):
    monkeypatch.setattr(qk, "load", _reach)
    monkeypatch.setattr(qk, "error_feedback_quantize_plain",
                        lambda *a, **k: pytest.fail("plain quantizer ran"))
    with dispatch.plain(), pytest.raises(Launched):
        qk.error_feedback_quantize(_meta(4, 100), _meta(4, 100, 2),
                                   [0.1] * 12, 2.0 ** -23, 1.0, "psycho")


def test_launches_merge_and_reset_every_counter():
    counted = [name for _, name, _ in pkgutil.iter_modules(ops_pkg.__path__)
               if hasattr(importlib.import_module(
                   f"{ops_pkg.__name__}.{name}"), "launch_counts")]
    assert sorted(counted) == sorted(dispatch.WRAPPERS)
    counts = (fk.launch_counts, fc.launch_counts, sc.launch_counts,
              ic.launch_counts, qk.launch_counts)
    keys = {k for c in counts for k in c}
    assert len(keys) == sum(len(c) for c in counts)
    assert set(dispatch.launches()) == keys
    for c in counts:
        for k in c:
            c[k] = 3
    assert set(dispatch.launches().values()) == {3}
    dispatch.reset_launches()
    assert set(dispatch.launches().values()) == {0}
    assert all(v == 0 for c in counts for v in c.values())


def test_staged_chain_with_a_soft_clip_runs_the_plain_forms(monkeypatch):
    """On a tensor off the CPU, the staged chain (soft clip on, neither EQ
    nor convolver) launches the IIR kernel for both DC blockers and the
    soft clip kernel; under plain() it runs `iir_cascade_fft` and
    `soft_clip_local2x_plain` instead, and launches nothing."""
    seen = []
    monkeypatch.setattr(ic, "_launch", lambda *a: seen.append("iir") or 0)
    monkeypatch.setattr(sc, "_launch", lambda *a: seen.append("clip") or 0)
    fft, clip = ic.iir_cascade_fft, sc.soft_clip_local2x_plain
    monkeypatch.setattr(ic, "iir_cascade_fft", lambda *a: (
        seen.append("iir fft"), fft(*a))[1])
    monkeypatch.setattr(sc, "soft_clip_local2x_plain", lambda *a: (
        seen.append("clip plain"), clip(*a))[1])
    cfg = t_chain.ChainConfig(soft_clip_enabled=True, saturation_amount=0.3)
    x = _meta(1, 2, 3000)
    t_chain.process_chain(x, cfg)
    assert seen == ["iir", "clip", "iir"]
    seen.clear()
    dispatch.reset_launches()
    with dispatch.plain():
        y = t_chain.process_chain(x, cfg)
    assert seen == ["iir fft", "clip plain", "iir fft"]
    assert y.shape == x.shape
    assert set(dispatch.launches().values()) == {0}
