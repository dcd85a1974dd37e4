"""convopeq_tpu_torch/csrc/frame_conv.cu built for the host by
tests/frame_conv_host_emulation.cpp (every thread of a block a
coroutine), and the guarded scratch its transforms are run in."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
GUARD = 12345.0


def build(tmp_path_factory):
    """The emulated library, its entries' argument types set; skips the
    test without a host C++ compiler."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    out = tmp_path_factory.mktemp("emu") / "libframe_conv_emu.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(out), str(ROOT / "tests" /
                                  "frame_conv_host_emulation.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    for name in ("frames_rfft_f32", "frames_rfft_f64", "osa_rfft_f32",
                 "irfft_valid_f32", "irfft_valid_f64"):
        getattr(lib, name).argtypes = [P_, P_, P_, I_, I_, I_, P_]
    for name in ("causal_mac_c64", "causal_mac_c128"):
        getattr(lib, name).argtypes = [P_, P_, P_, I_, I_, I_, I_, P_]
    lib.fused_conv_f32.argtypes = [P_, P_, P_, P_, I_, I_, I_, I_, P_]
    lib.frame_conv_mac_block.argtypes = [I_, I_]
    lib.frame_conv_mac_block_c128.argtypes = [I_, I_]
    return lib


def guarded_scratch(n, dtype):
    """A scratch of n complex values and a guard past it."""
    s = torch.empty((n + 64,), dtype=dtype)
    s[n:] = GUARD
    return s


def guard_intact(scratch, n):
    return bool((scratch[n:] == GUARD).all())
