"""The local 2x soft clip's CUDA kernel (convopeq_tpu_torch/csrc/
softclip.cu) and its wrapper (ops/softclip.py), on the CPU.

- The kernel runs on the host through tests/softclip_host_emulation.cpp
  (every thread of a block a coroutine, each barrier a yield; skipped
  without g++), held to the plain version `soft_clip_local2x_plain`:
  f64 to a relative max error <= 1e-12, the tolerance of
  tests/test_torch_render_chain.py's `test_soft_clip_matches_jax`; f32
  to a relative RMS error <= 3e-7 of the plain version in f64.  The f32
  bound: each output sums 32 products of f32 values through two clips,
  and the plain version in f32 itself sits ~1e-7 from it in f64 (the
  test checks it stays within the same bound), so 3e-7 is a few f32
  roundings of the output and far under any error of the algorithm
  (a wrong tap or a lost history sample is > 1e-3).
- Shapes: several batch shapes, N below one tile, N not a multiple of the
  tile (4,096 f32 / 2,048 f64 outputs), N = 1, rows whose length is not a
  multiple of the 16-byte vector and a misaligned pointer (the scalar
  loads), large values at every row's start and end (zero history at each
  row's start, nothing carried from the row before); saturations 0, 0.3
  and 1 (asymmetry on) and the hard clip (knee 0).
- The wrapper: the CPU takes the plain version; the launch counter moves
  by one on a launch and on nothing else; the wrapper rejects a type,
  layout or shape the kernel does not take, and a failed launch.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from convopeq_tpu_torch.ops import softclip as sc
from convopeq_tpu_torch.ops.dispatch import reset_launches

ROOT = Path(__file__).resolve().parent.parent
F32_REL_RMS = 3e-7

SHAPES = [(2, 3, 5001), (1, 1000), (3, 8192), (2, 6150), (5, 1), (4, 17)]
PARAMS = {"sat0": sc.soft_clip_params(0.0),
          "sat0.3": sc.soft_clip_params(0.3),
          "sat1": sc.soft_clip_params(1.0),
          "hard": (0.8, 0.0, 0.0)}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated library, its entries' argument types set; skips the
    test without a host C++ compiler."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    out = tmp_path_factory.mktemp("emu") / "libsoftclip_emu.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-fno-strict-aliasing",
                    "-shared", "-fPIC", "-o", str(out),
                    str(ROOT / "tests" / "softclip_host_emulation.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P_, I_, D_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("soft_clip_local2x_f32", "soft_clip_local2x_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P_, P_, I_, I_, ctypes.POINTER(D_), D_, D_, D_, P_]
        fn.restype = I_
    return lib


def _run(lib, x, params):
    """The emulated kernel on x (contiguous, R rows of N): y."""
    y = torch.empty_like(x)
    fn = (lib.soft_clip_local2x_f32 if x.dtype == torch.float32
          else lib.soft_clip_local2x_f64)
    assert fn(*sc._entry_args(x, y, *params), None) == 0
    return y


def _signal(shape, seed):
    """Normal noise x 0.6, with full-scale values at every row's first
    and last samples."""
    x = np.random.default_rng(seed).normal(size=shape) * 0.6
    k = min(4, shape[-1])
    x[..., :k] = [1.5, -1.5, 0.95, -0.2][:k]
    x[..., -min(3, shape[-1]):] = 1.4
    return torch.from_numpy(x)


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _rel_rms(got, want):
    return float(((got - want).pow(2).mean() / want.pow(2).mean()).sqrt())


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_source_f64_matches_plain_emulated(emulated, shape, name):
    x = _signal(shape, 7 + len(shape) + shape[-1])
    want = sc.soft_clip_local2x_plain(x, *PARAMS[name])
    got = _run(emulated, x, PARAMS[name])
    assert got.shape == x.shape
    assert _rel_max(got, want) <= 1e-12


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_source_f32_matches_plain_emulated(emulated, shape, name):
    x = _signal(shape, 11 + len(shape) + shape[-1]).float()
    want = sc.soft_clip_local2x_plain(x.double(), *PARAMS[name])
    got = _run(emulated, x, PARAMS[name])
    assert got.dtype == torch.float32
    assert _rel_rms(got.double(), want) <= F32_REL_RMS
    plain32 = sc.soft_clip_local2x_plain(x, *PARAMS[name])
    assert _rel_rms(plain32.double(), want) <= F32_REL_RMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_source_misaligned_rows_emulated(emulated, dtype):
    """A contiguous signal one value past a 16-byte boundary takes the
    scalar loads and stores; rows are not carried into each other."""
    base = _signal((3 * 4100 + 1,), 5).to(dtype)
    x = base[1:].view(3, 4100)
    assert x.data_ptr() % 16 != 0
    params = PARAMS["sat0.3"]
    want = sc.soft_clip_local2x_plain(x.double(), *params)
    got = _run(emulated, x, params)
    if dtype == torch.float64:
        assert _rel_max(got, want) <= 1e-12
    else:
        assert _rel_rms(got.double(), want) <= F32_REL_RMS
    # each row alone gives the same output: zero history at a row start
    for r in range(3):
        alone = _run(emulated, x[r].clone(), params)
        assert torch.equal(alone, got[r])


def test_cuda_source_rejects_empty_shapes_emulated(emulated):
    x = torch.zeros(4, dtype=torch.float64)
    taps = sc._taps()
    for R, N in ((0, 4), (4, 0), (-1, 4)):
        assert emulated.soft_clip_local2x_f64(
            x.data_ptr(), x.data_ptr(), R, N, taps, 0.8, 0.2, 0.0,
            None) == -1


# ------------------------------------------------------------ the wrapper

def test_cpu_takes_the_plain_version_and_launches_nothing():
    reset_launches()
    x = _signal((2, 2, 300), 3)
    params = PARAMS["sat0.3"]
    y = sc.soft_clip_local2x(x, *params)
    assert torch.equal(y, sc.soft_clip_local2x_plain(x, *params))
    assert sc.launch_counts == {"soft_clip_local2x": 0}


def test_launch_counter_moves_only_on_a_launch(monkeypatch):
    """A non-CPU tensor (meta here) goes to the kernel: one launch a call
    with R rows of N, the count up by one; a failed launch raises and
    counts nothing."""
    calls, codes = [], [0]

    def fake_launch(x, y, threshold, knee, asymmetry):
        calls.append((tuple(x.shape), x.numel() // x.shape[-1],
                      x.shape[-1], y.shape, threshold))
        return codes[0]

    monkeypatch.setattr(sc, "_launch", fake_launch)
    reset_launches()
    x = torch.empty((4, 2, 1000), device="meta")
    y = sc.soft_clip_local2x(x, 0.8, 0.2, 0.03)
    assert y.shape == x.shape and y.device.type == "meta"
    assert calls == [((4, 2, 1000), 8, 1000, x.shape, 0.8)]
    assert sc.launch_counts["soft_clip_local2x"] == 1
    sc.soft_clip_local2x(x[0].double(), 0.8, 0.2, 0.03)
    assert sc.launch_counts["soft_clip_local2x"] == 2
    codes[0] = 700
    with pytest.raises(RuntimeError, match="code 700"):
        sc.soft_clip_local2x(x, 0.8, 0.2, 0.03)
    assert sc.launch_counts["soft_clip_local2x"] == 2
    reset_launches()
    assert sc.launch_counts["soft_clip_local2x"] == 0


@pytest.mark.parametrize("bad", ["float16", "transposed", "empty",
                                 "scalar"])
def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, bad):
    monkeypatch.setattr(sc, "_launch", lambda *a: pytest.fail("launched"))
    reset_launches()
    x = {"float16": torch.empty((2, 64), device="meta",
                                dtype=torch.float16),
         "transposed": torch.empty((64, 2), device="meta").T,
         "empty": torch.empty((2, 0), device="meta"),
         "scalar": torch.empty((), device="meta")}[bad]
    with pytest.raises(ValueError):
        sc.soft_clip_local2x(x, 0.8, 0.2, 0.0)
    assert sc.launch_counts["soft_clip_local2x"] == 0
